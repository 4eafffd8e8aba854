"""The port's local checkpoints: the reference's local cases (roundtrip,
latest step, async write, torn write, missing raises, resume then step),
a checkpoint written by either package restored equal by the other (the
on-disk layout is shared), and a bf16 leaf."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro_torch.checkpoint import ckpt


@pytest.fixture(scope="module")
def port_rt():
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g), "blk/b": torch.zeros(8)},
            "opt": {"m": {"w": torch.ones(8, 8) * 0.5},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k])
        else:
            x, y = (torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
                    for t in (a[k], b[k]))
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(x, y), k


def test_roundtrip(tmp_path):
    s = _state()
    ckpt.save(tmp_path, 10, s)
    step, r = ckpt.restore(tmp_path)
    assert step == 10
    _assert_same(r, s)
    assert int(r["opt"]["step"]) == 7 and r["params"]["w"].device.type == "cpu"


def test_latest_step_picks_max(tmp_path):
    ckpt.save(tmp_path, 5, _state())
    ckpt.save(tmp_path, 20, _state(1))
    ckpt.save(tmp_path, 15, _state(2))
    assert ckpt.latest_step(tmp_path) == 20
    step, r = ckpt.restore(tmp_path)
    assert step == 20
    _assert_same(r, _state(1))


def test_async_save_snapshots_before_returning(port_rt, tmp_path):
    s = _state()
    fut = ckpt.save_async(tmp_path, 3, s)
    s["params"]["w"].add_(1.0)  # the trainer updates in place meanwhile
    out = fut.get(timeout=60)
    assert (Path(out) / "manifest.json").exists()
    step, r = ckpt.restore(tmp_path)
    assert step == 3
    _assert_same(r["params"], _state()["params"])


def test_torn_write_ignored(tmp_path):
    ckpt.save(tmp_path, 1, _state())
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "leaf_00000.npy").write_bytes(b"garbage")  # no manifest
    assert ckpt.latest_step(tmp_path) == 1


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "nope")


def test_bf16_leaf_roundtrips(tmp_path):
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    ckpt.save(tmp_path, 2, {"x": x, "s": x[0, 0].clone()})
    meta = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert {m["dtype"] for m in meta["leaves"].values()} == {"bfloat16"}
    _, r = ckpt.restore(tmp_path)
    assert r["x"].dtype == torch.bfloat16 and torch.equal(r["x"], x)
    assert r["s"].shape == () and torch.equal(r["s"], x[0, 0])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    s = _state()
    ckpt.save(tmp_path, 4, s)
    step, r = rckpt.restore(tmp_path)
    assert step == 4
    _assert_same(r, s)
    # the same manifest as the reference writes for the same state
    ckpt_ref = tmp_path / "ref"
    mine = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    rckpt.save(ckpt_ref, 4, _numpy(s))
    theirs = json.loads((ckpt_ref / "step_00000004" / "manifest.json").read_text())
    assert mine == theirs


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    s = _state(3)
    rckpt.save(tmp_path, 6, _numpy(s))
    step, r = ckpt.restore(tmp_path)
    assert step == 6
    _assert_same(r, s)


def test_resume_then_step_trains(port_rt, tmp_path):
    """Param paths contain '/': restore must give back the flat params so
    the restored state steps at once."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    model = build_model(get_config("starcoder2_3b", smoke=True), "cpu")
    tr = Trainer(model, AdamWConfig(lr=1e-3, total_steps=10),
                 DataConfig(batch_size=2, seq_len=16),
                 TrainConfig(steps=4, log_every=2, ckpt_every=4, ckpt_dir=str(tmp_path)),
                 device="cpu")
    tr.fit()
    tr2 = Trainer(model, AdamWConfig(lr=1e-3, total_steps=10),
                  DataConfig(batch_size=2, seq_len=16),
                  TrainConfig(steps=2, log_every=1, ckpt_dir=str(tmp_path)), device="cpu")
    assert tr2.resume() == 4
    assert set(tr2.params) == set(tr.params)
    _assert_same({"p": tr2.params, "m": tr2.opt_state["m"]},
                 {"p": tr.params, "m": tr.opt_state["m"]})
    assert int(tr2.opt_state["step"]) == 4
    hist = tr2.fit(2)
    assert [h["step"] for h in hist] == [5, 6]
