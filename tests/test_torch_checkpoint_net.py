"""The port's checkpoints across localities against the reference's:
partitioned checkpoints (``save_partitioned`` / ``latest_partitioned_step``
/ ``restore_partitioned``: each owner writes its own shard, a restore keeps
the save-time placement) written by either package and restored by the
other, and the remote branches of ``save_gid`` / ``restore_gid`` (state
fetched home by GID, re-homed on a fresh locality), mirroring
``tests/test_net_localities.py::test_checkpoint_by_gid_respawns_on_fresh_locality``.

A 3-locality fleet of each package side by side (as
``test_torch_net_localities.py``); helper actions are module-level plain
functions that workers of either package resolve by dotted name, and this
module imports neither package at its top."""

import contextlib
import itertools
import json

import numpy as np
import pytest

_uid = itertools.count()


class _Side:
    def __init__(self, name):
        self.name = name
        if name == "port":
            import repro_torch.core as core
            from repro_torch import net
            from repro_torch.checkpoint import ckpt
            from repro_torch.container import PartitionedVector
            from repro_torch.core import agas
        else:
            import repro.core as core
            from repro import net
            from repro.checkpoint import ckpt
            from repro.container import PartitionedVector
            from repro.core import agas
        self.core, self.net, self.ckpt, self.PV, self.agas = core, net, ckpt, PartitionedVector, agas

    def vector(self, name, xs):
        xs = np.asarray(xs)
        kw = {"device": "cpu"} if self.name == "port" else {}
        pv = self.PV.create(name, len(xs), dtype=xs.dtype, element_shape=xs.shape[1:], **kw)
        pv.set_slice(0, len(xs), xs)
        return pv

    def restore(self, d, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.ckpt.restore_partitioned(d, **kw)


def _side_of(rt):
    return _Side("port" if type(rt).__module__.startswith("repro_torch") else "ref")


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(x, np.ndarray) else np.asarray(x)


# ----------------------------------------------------------- helper actions
def register_payload(rt, name, n):
    side = _side_of(rt)
    if side.name == "port":
        import torch

        state = {"x": torch.arange(n, dtype=torch.float64),
                 "h": torch.linspace(-3, 3, n).to(torch.bfloat16)}
    else:
        state = {"x": np.arange(n, dtype=np.float64)}
    gid = side.agas.default().register(state, name=name)
    return [gid.locality, gid.seq]


def unregister_by_name(rt, name):
    a = _side_of(rt).agas.default()
    a.unregister(a.gid_of(name))


def state_kind(rt, name):
    """At the owner: what each leaf of the named state is there."""
    state = _side_of(rt).agas.default().resolve(name)
    return {k: (type(v).__module__.split(".")[0], str(v.dtype)) for k, v in state.items()}


def tree_sum(obj, s):
    return float(sum(float(v.sum()) for v in obj.values()) * s)


# ------------------------------------------------------------------ fixture
@pytest.fixture(scope="module")
def fleets(rt):
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


# ------------------------------------------------------- partitioned vectors
@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("rows", [False, True], ids=["scalars", "rows"])
def test_partitioned_checkpoint_restores_in_the_other_package(fleets, tmp_path, writer, rows):
    """The writer saves after a ``move_segment`` (owners differ from
    creation), each shard written by its owner; the other package restores
    it at the save-time owners, equal in values and dtype."""
    reader = "port" if writer == "ref" else "ref"
    xs = (np.arange(24.0) * 1.5 if not rows else
          np.random.default_rng(0).integers(0, 500, size=(24, 9)).astype(np.int32))
    wside, _ = fleets[writer]
    rside, _ = fleets[reader]
    pv = wside.vector(f"tk/pv{next(_uid)}", xs)
    pv.move_segment(0, 1)  # placement at SAVE time must be what restores
    out = wside.ckpt.save_partitioned(tmp_path, step=5, pv=pv)
    manifest = json.loads((out / "partitioned.json").read_text())
    assert [s["locality"] for s in manifest["shards"]] == [1, 1, 2]
    assert sorted(p.name for p in out.iterdir()) == [
        "partitioned.json", "shard_00000.npy", "shard_00001.npy", "shard_00002.npy"]
    assert manifest["dtype"] == xs.dtype.str
    assert {s["dtype"] for s in manifest["shards"]} == {str(xs.dtype)}
    assert rside.ckpt.latest_partitioned_step(tmp_path) == 5
    step, back = rside.restore(tmp_path, name=f"tk/rst{next(_uid)}")
    assert step == 5 and back.owners() == [1, 1, 2]
    got = _np(back.to_array())
    assert got.dtype == xs.dtype
    np.testing.assert_array_equal(got, xs)
    pv.free()
    back.free()


def test_partitioned_checkpoint_manifests_match(fleets, tmp_path):
    """The same vector saved by each package gives the same manifest, and
    a restore without a name takes the saved one."""
    xs = np.arange(10, dtype=np.int64)
    out = {}
    for name, (side, _net) in fleets.items():
        pv = side.vector(f"tk/man{next(_uid)}", xs)
        for step in (3, 9):
            side.ckpt.save_partitioned(tmp_path / name, step=step, pv=pv)
        d = tmp_path / name / "pvec_00000009"
        out[name] = json.loads((d / "partitioned.json").read_text())
        out[name]["name"] = "-"
        pv.free()
        step, back = side.restore(tmp_path / name)
        assert step == 9 and back.name == pv.name
        np.testing.assert_array_equal(_np(back.to_array()), xs)
        back.free()
    assert out["port"] == out["ref"]
    for name, (side, _net) in fleets.items():
        assert side.ckpt.latest_partitioned_step(tmp_path / "nowhere") is None
        with pytest.raises(FileNotFoundError):
            side.restore(tmp_path / "nowhere")


def test_partitioned_restore_without_cpu_raises_here(fleets, tmp_path):
    side, _net = fleets["port"]
    pv = side.vector(f"tk/cuda{next(_uid)}", np.arange(4.0))
    side.ckpt.save_partitioned(tmp_path, 1, pv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        side.ckpt.restore_partitioned(tmp_path)


# --------------------------------------------------------------- by GID
def test_checkpoint_by_gid_respawns_on_fresh_locality(fleets, tmp_path):
    """save_gid at the root pulls remote state home over the parcelport;
    restore_gid re-homes it on a different locality under the same name,
    re-published through the root AGAS table."""
    out = {}
    for name, (side, _net) in fleets.items():
        d = tmp_path / name
        key = side.net.run_on(1, register_payload, "tk/ckpt", 12).get(timeout=60)
        saved = side.ckpt.save_gid(d, step=7, target=side.agas.GID(*key))
        meta = json.loads((saved / "agas.json").read_text())
        side.net.run_on(1, unregister_by_name, "tk/ckpt").get(timeout=60)
        step, gid = side.ckpt.restore_gid(d, locality=2)
        got = side.net.apply_remote(tree_sum, "tk/ckpt", 1).get(timeout=60)
        state = side.net.fetch(gid)
        kinds = side.net.run_on(2, state_kind, "tk/ckpt").get(timeout=60)
        out[name] = ((meta["name"], meta["gid"] == list(key), meta["gid"][0]),
                     step, gid.locality, state, kinds, got)
    p, r = out["port"], out["ref"]
    assert p[0] == r[0] == ("tk/ckpt", True, 1)
    assert p[1:3] == r[1:3] == (7, 2)
    np.testing.assert_array_equal(p[3]["x"], np.arange(12, dtype=np.float64))
    np.testing.assert_array_equal(r[3]["x"], np.arange(12, dtype=np.float64))
    assert p[3]["x"].dtype == r[3]["x"].dtype == np.float64
    # the port's bf16 leaf: home and back as its bits
    import torch

    want = torch.linspace(-3, 3, 12).to(torch.bfloat16)
    assert p[3]["h"].dtype == torch.bfloat16
    assert torch.equal(p[3]["h"].view(torch.int16), want.view(torch.int16))
    # re-homed as the port's CPU tensors (the reference's numpy arrays)
    assert p[4] == {"x": ("torch", "torch.float64"), "h": ("torch", "torch.bfloat16")}
    assert r[4] == {"x": ("numpy", "float64")}
    assert r[5] == pytest.approx(float(np.arange(12).sum()))
    assert p[5] == pytest.approx(float(np.arange(12).sum()) + float(want.float().sum()))


def test_save_gid_by_name_of_a_remote_object(fleets, tmp_path):
    """By name, the owner is asked for the record; the checkpoint restores
    here (no locality) as the local branch does."""
    out = {}
    for name, (side, _net) in fleets.items():
        key = side.net.run_on(2, register_payload, "tk/byname", 5).get(timeout=60)
        saved = side.ckpt.save_gid(tmp_path / name, 2, "tk/byname")
        meta = json.loads((saved / "agas.json").read_text())
        side.net.run_on(2, unregister_by_name, "tk/byname").get(timeout=60)
        step, gid = side.ckpt.restore_gid(tmp_path / name)
        local = side.agas.default().resolve(gid)
        out[name] = (meta["gid"] == list(key), meta["name"], step, gid.locality,
                     _np(local["x"]))
        side.agas.default().unregister(gid)
    p, r = out["port"], out["ref"]
    assert p[:4] == r[:4] == (True, "tk/byname", 2, 0)
    np.testing.assert_array_equal(p[4], r[4])
