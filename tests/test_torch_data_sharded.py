"""The port's locality-sharded dataset (``repro_torch.data.pipeline``:
``synth_token_rows``, ``ShardedTokenDataset``, ``LocalShardFeeder``), the
trainer's ``prefetcher=`` and ``retry_stragglers``, and the launcher's
fleet and observability flags, against the reference's.

A 3-locality fleet of each package side by side (as
``test_torch_net_localities.py``): each package synthesizes the dataset in
place at its owners (the port's segments on ``cpu`` here), and the rows,
the feeder's global rows and its batches must be equal; the smoke
starcoder2_3b trained by each package's trainer from its own feeder, the
port's params carried over from the reference's, must agree within
``test_torch_train.py``'s fp32 tolerance."""

import contextlib
import itertools
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4  # test_torch_train.TOL["float32"]["loss"]
_uid = itertools.count()


class _Side:
    """One package's net, data pipeline, configs and trainer."""

    def __init__(self, name):
        self.name = name
        if name == "port":
            import repro_torch.core as core
            from repro_torch import net
            from repro_torch.configs import get_config
            from repro_torch.data import pipeline
            from repro_torch.train import trainer
        else:
            import repro.core as core
            from repro import net
            from repro.configs import get_config
            from repro.data import pipeline
            from repro.train import trainer
        self.core, self.net, self.get_config = core, net, get_config
        self.pipe, self.trainer = pipeline, trainer

    def dataset(self, name, cfg, dcfg, rows, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.pipe.ShardedTokenDataset.create(name, cfg, dcfg, rows=rows, **kw)


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(x, np.ndarray) else np.asarray(x)


@pytest.fixture(scope="module")
def fleets(rt):
    """A 3-locality fleet of each package, side by side in this process."""
    port = _Side("port")
    port.core.init(num_workers=4)
    try:
        with contextlib.ExitStack() as stack:
            out = {}
            for side in (_Side("ref"), port):
                out[side.name] = (side, stack.enter_context(
                    side.net.running(3, pools={"default": 4, "io": 1})))
            yield out
    finally:
        port.core.finalize()


def _both(fleets, fn):
    return {name: fn(side, net) for name, (side, net) in fleets.items()}


# ------------------------------------------------------------- the stream
@pytest.mark.parametrize("arch,seed,seq,rows", [
    ("starcoder2_3b", 0, 16, [0, 1, 2, 29]), ("qwen25_3b", 3, 7, [5, 1000, 123456]),
    ("mamba2_780m", 1, 64, list(range(10)))])
def test_synth_token_rows_bit_equal_to_reference(arch, seed, seq, rows):
    from repro.configs import get_config as rconfig
    from repro.data import pipeline as rpipe
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as tpipe

    t = tpipe.synth_token_rows(np.asarray(rows), get_config(arch, smoke=True),
                               tpipe.DataConfig(seq_len=seq, seed=seed))
    r = rpipe.synth_token_rows(np.asarray(rows), rconfig(arch, smoke=True),
                               rpipe.DataConfig(seq_len=seq, seed=seed))
    assert t.dtype == r.dtype == np.int32 and t.shape == (len(rows), seq + 1)
    np.testing.assert_array_equal(t, r)


# ---------------------------------------------------------- the dataset
@pytest.mark.parametrize("layout", ["block", "cyclic"])
def test_sharded_dataset_and_feeder_match_reference(fleets, layout):
    def call(side, net):
        cfg = side.get_config("qwen25_3b", smoke=True)
        dcfg = side.pipe.DataConfig(batch_size=4, seq_len=16, seed=2)
        ds = side.dataset(f"td/ds{next(_uid)}", cfg, dcfg, 30, distribution=layout)
        feeder = ds.feeder()
        batches = [feeder.get(s).get(timeout=60) for s in (0, 1, 5, 1)]
        again = side.pipe.ShardedTokenDataset.attach(ds.pv.name, cfg, dcfg)
        return (_np(ds.pv.to_array()), feeder.global_rows, len(ds), len(again),
                [{k: _np(v) for k, v in b.items()} for b in batches], batches[0])

    out = _both(fleets, call)
    p, r = out["port"], out["ref"]
    from repro.configs import get_config as rconfig
    from repro.data import pipeline as rpipe

    oracle = rpipe.synth_token_rows(np.arange(30), rconfig("qwen25_3b", smoke=True),
                                    rpipe.DataConfig(batch_size=4, seq_len=16, seed=2))
    np.testing.assert_array_equal(p[0], oracle)
    np.testing.assert_array_equal(r[0], oracle)
    assert p[0].dtype == r[0].dtype == np.int32
    np.testing.assert_array_equal(p[1], r[1])  # locality 0's global rows
    assert p[1].shape == (10,) and p[1].dtype == np.int64
    assert p[2] == r[2] == p[3] == 30
    for bp, br in zip(p[4], r[4], strict=True):
        assert bp.keys() == br.keys() == {"tokens"}
        assert bp["tokens"].dtype == br["tokens"].dtype == np.int32
        np.testing.assert_array_equal(bp["tokens"], br["tokens"])
    np.testing.assert_array_equal(p[4][1]["tokens"], p[4][3]["tokens"])  # per step
    local = {tuple(row) for row in oracle[p[1]]}
    assert all(tuple(row) in local for b in p[4] for row in b["tokens"])
    assert p[5]["tokens"].device.type == "cpu"


def test_sharded_dataset_refusals_match_reference(fleets):
    far = f"td/far{next(_uid)}"

    def call(side, net):
        msgs = []
        for arch in ("internvl2_2b", "whisper_small"):
            with pytest.raises(ValueError) as e:
                side.dataset(f"td/no{next(_uid)}", side.get_config(arch, smoke=True),
                             side.pipe.DataConfig(), 8)
            msgs.append(str(e.value))
        ds = side.dataset(far, side.get_config("starcoder2_3b", smoke=True),
                          side.pipe.DataConfig(seq_len=8), 6,
                          distribution=[3, 3])
        ds.pv.rebalance([1, 2])  # nothing left at locality 0
        with pytest.raises(RuntimeError) as e:
            ds.feeder()
        msgs.append(str(e.value))
        return msgs

    out = _both(fleets, call)
    assert out["port"] == out["ref"]


def test_sharded_dataset_without_cpu_raises_here(fleets):
    side, _net = fleets["port"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        side.pipe.ShardedTokenDataset.create(
            f"td/cuda{next(_uid)}", side.get_config("starcoder2_3b", smoke=True),
            side.pipe.DataConfig(), rows=4)


# ------------------------------------------------------------ the trainer
def _trainers(fleets, steps, **tkw):
    """Each package's trainer over the fp32 smoke starcoder2_3b, fed by its
    own feeder over the same sharded rows; the port's params are the
    reference's."""
    import torch

    from repro.models.model import build_model as rbuild
    from repro.optim import adamw as radamw
    from repro.dist import plan as rplan
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_reference
    from repro_torch.optim import adamw

    out = {}
    for name, (side, _net) in fleets.items():
        cfg = replace(side.get_config("starcoder2_3b", smoke=True), dtype="float32")
        dcfg = side.pipe.DataConfig(batch_size=2, seq_len=16, seed=4)
        feeder = side.dataset(f"td/tr{next(_uid)}", cfg, dcfg, 24).feeder()
        tcfg = side.trainer.TrainConfig(steps=steps, log_every=1, **tkw)
        if name == "ref":
            opt = radamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=steps)
            tr = side.trainer.Trainer(rbuild(cfg, rplan.get_plan("futurized")), opt, dcfg,
                                      tcfg, prefetcher=feeder)
        else:
            opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=steps)
            model = Model(cfg, "cpu")
            tr = side.trainer.Trainer(model, opt, dcfg, tcfg, device="cpu",
                                      prefetcher=feeder)
            ref = out["ref"][0]
            tr.params = from_reference({k: np.asarray(v) for k, v in ref.params.items()},
                                       cfg, torch.device("cpu"))
            tr.opt_state = adamw.init(tr.params)
        out[name] = (tr, feeder)
    return out


def test_trainer_fed_by_the_feeder_matches_reference(fleets):
    tr = _trainers(fleets, steps=3)
    hist = {name: t.fit() for name, (t, _f) in tr.items()}
    p, r = hist["port"], hist["ref"]
    assert [h["step"] for h in p] == [h["step"] for h in r] == [1, 2, 3]
    for hp, hr in zip(p, r):
        assert abs(hp["loss"] - hr["loss"]) <= LOSS_TOL, (hp, hr)
        assert hp["grad_norm"] == pytest.approx(hr["grad_norm"], rel=1e-3)
    assert tr["port"][0].prefetcher is tr["port"][1]
    assert tr["port"][1].c_built.get_value() >= 3
    tr["port"][0].close()


def test_retry_stragglers_matches_reference(fleets):
    """Every logged step counts as a straggler (factor 0) and is stepped
    again on the same batch: each package's optimizer takes two steps for
    every one of the loop's."""
    out = {}
    for flag in (False, True):
        tr = _trainers(fleets, steps=2, straggler_factor=0.0, retry_stragglers=flag)
        for name, (t, _f) in tr.items():
            before = t.c_straggler.get_value()
            hist = t.fit()
            out[name, flag] = (int(np.asarray(t.opt_state["step"])),
                               t.c_straggler.get_value() - before, len(hist))
        tr["port"][0].close()
    for flag in (False, True):
        assert out["port", flag] == out["ref", flag]
    assert out["port", False] == (2, 2, 2) and out["port", True] == (4, 2, 2)


# ------------------------------------------------------------ the launcher
def test_launch_train_sharded_with_observability(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    trace, tl = tmp_path / "t.json", tmp_path / "tl.jsonl"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "starcoder2_3b", "--smoke", "--device", "cpu", "--steps", "4",
                        "--batch", "2", "--seq", "32", "--log-every", "2",
                        "--localities", "2", "--sharded-rows", "1024",
                        "--trace", str(trace), "--print-counters", "/train*",
                        "--metrics-port", "0", "--timeline", str(tl)],
                       capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("metrics: http://127.0.0.1:")
    js = [json.loads(line) for line in lines if line.startswith("{")]
    sharded = js[0]
    assert sharded["sharded_rows"] == 1024 and sharded["segments"] == 2
    assert sharded["local_rows"] == 512
    assert 0 < sharded["wire_bytes"] < 0.05 * 1024 * 33 * 4  # the rows never travel
    steps = [j for j in js if "step" in j]
    assert [h["step"] for h in steps] == [2, 4]
    assert all(np.isfinite(h["loss"]) for h in steps)
    counters = next(j for j in js if "counters" in j)["counters"]
    assert counters["/train{loop#0}/steps/cumulative"] == 4
    assert next(j for j in js if "trace" in j)["events"] > 0
    pids = {e.get("pid") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {0, 1} <= pids, pids
    assert any(line.startswith("L0 /train{loop#0}/steps/cumulative") for line in lines)
    timeline = next(j for j in js if "timeline" in j)
    assert timeline["timeline"] == str(tl) and timeline["records"] >= 2
    assert len(tl.read_text().splitlines()) >= 2


def test_launch_train_refuses_a_scheduler_with_localities():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    errs = []
    for pkg in ("repro_torch", "repro"):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.launch.train", "--arch",
                            "starcoder2_3b", "--smoke", "--steps", "1",
                            "--localities", "2", "--scheduler", "static"]
                           + (["--device", "cpu"] if pkg == "repro_torch" else []),
                           capture_output=True, text=True,
                           env={**env, "JAX_PLATFORMS": "cpu"}, timeout=120)
        assert r.returncode == 2
        errs.append(r.stderr.strip().splitlines()[-1])
    assert errs[0] == errs[1] and "--scheduler is not supported" in errs[0]
