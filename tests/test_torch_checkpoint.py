"""The port's local checkpoints: the reference's local cases (roundtrip,
latest step, async write, torn write, missing raises, resume then step),
a checkpoint written by either package restored equal by the other (the
on-disk layout is shared), a bf16 leaf, and checkpoints by GID
(``save_gid``/``restore_gid``): the local round trip, the remote branches
raising as the reference's do without a multi-locality runtime, and a GID checkpoint written by either package restored by the
other."""
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


# ------------------------------------------------------ checkpoints by GID
def test_save_gid_restore_gid_reinstalls_under_the_name(port_rt, tmp_path):
    """Local branch: the AGAS record is snapshotted and ``agas.json`` names
    it; restoring after the object is gone registers the state under its
    old name with a new GID."""
    from repro_torch.core import agas

    a = agas.default()
    s = _state(4)
    gid = a.register_name("/ckpt/gid/state", s, replace=True)
    out = ckpt.save_gid(tmp_path, 3, "/ckpt/gid/state")
    meta = json.loads((out / "agas.json").read_text())
    assert meta == {"gid": [gid.locality, gid.seq], "name": "/ckpt/gid/state"}
    a.unregister(gid)
    step, new = ckpt.restore_gid(tmp_path)
    assert step == 3 and new != gid and a.gid_of("/ckpt/gid/state") == new
    _assert_same(a.resolve(new), s)
    # by GID as well as by name; a taken name is rebound, its GID kept
    ckpt.save_gid(tmp_path, 4, new)
    gen = a.record(new).generation
    step, again = ckpt.restore_gid(tmp_path, 4)
    assert step == 4 and again == new and a.record(new).generation == gen + 1
    a.unregister(new)


def test_gid_checkpoint_remote_branches_raise(rt, port_rt, tmp_path):
    """Without a multi-locality runtime the remote branches raise in both
    packages, with the same messages: a target that does not resolve here,
    and a restore onto another locality."""
    msgs = {}
    for name, mod in (("ref", rckpt), ("port", ckpt)):
        got = []
        with pytest.raises(RuntimeError) as e:
            mod.save_gid(tmp_path / name, 1, "/ckpt/gid/nowhere")
        got.append(str(e.value))
        ckpt.save(tmp_path / name, 1, _state())
        with pytest.raises(RuntimeError) as e:
            mod.restore_gid(tmp_path / name, 1, locality=1)
        got.append(str(e.value))
        msgs[name] = [m.replace("repro_torch.", "repro.") for m in got]
    assert msgs["port"] == msgs["ref"]
    assert "multi-locality runtime" in msgs["port"][0]
    assert "restore_gid(locality=1) needs a multi-locality runtime" in msgs["port"][1]


def test_reference_save_gid_restores_in_the_port(rt, port_rt, tmp_path):
    """A checkpoint written by the reference's ``save_gid`` restores through
    the port's ``restore_gid``: the same state, under the same name."""
    from repro.core import agas as ragas
    from repro_torch.core import agas

    s = _state(5)
    rgid = ragas.default().register_name("/ckpt/gid/ref", _numpy(s), replace=True)
    rckpt.save_gid(tmp_path, 9, "/ckpt/gid/ref")
    ragas.default().unregister(rgid)
    step, gid = ckpt.restore_gid(tmp_path)
    assert step == 9 and agas.default().gid_of("/ckpt/gid/ref") == gid
    _assert_same(agas.default().resolve(gid), s)
    agas.default().unregister(gid)


def test_port_save_gid_restores_in_the_reference(rt, port_rt, tmp_path):
    from repro.core import agas as ragas
    from repro_torch.core import agas

    s = _state(6)
    gid = agas.default().register_name("/ckpt/gid/port", s, replace=True)
    ckpt.save_gid(tmp_path, 2, gid)
    agas.default().unregister(gid)
    step, rgid = rckpt.restore_gid(tmp_path)
    assert step == 2 and ragas.default().gid_of("/ckpt/gid/port") == rgid
    _assert_same(ragas.default().resolve(rgid), s)
    ragas.default().unregister(rgid)
