"""The port's parcels (``repro_torch.core.parcel``): the reference's three
parcel cases of ``test_core_agas_parcel.py`` on the port, the action
registry's lazy resolution, and the same numpy-seeded object and action
through both packages — equal results, the parcel counters stepping by one
in each."""
import numpy as np
import pytest
import torch

import repro.core as rcore
import repro_torch.core as core
from repro.core import agas as ragas
from repro.core import parcel as rparcel
from repro_torch.core import agas, counters, parcel


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def test_parcel_apply_executes_at_object(port_rt):
    agas.default().register_name("/parcel/target", {"count": 10}, replace=True)
    fut = parcel.apply(lambda obj, d: obj["count"] + d, "/parcel/target", 5)
    assert fut.get() == 15


def test_parcel_action_decorator(port_rt):
    @parcel.action
    def scale(obj, s):
        return obj * s

    agas.default().register_name("/parcel/num", 6, replace=True)
    assert parcel.apply(scale, "/parcel/num", 7).get() == 42


def test_parcel_counters_increment(port_rt):
    before = counters.get_value("/parcel{port#0}/count/sent")
    agas.default().register_name("/parcel/c", 0, replace=True)
    parcel.apply(lambda o: o, "/parcel/c").get()
    assert counters.get_value("/parcel{port#0}/count/sent") == before + 1


def test_action_registry_resolves_by_qualname_and_rejects_clashes(port_rt):
    reg = parcel.ActionRegistry()
    # a module-level function never registered here: found by importing
    # its module and walking the qualname
    assert reg.resolve("repro_torch.core.migration.migrate_tree") is \
        core.migration.migrate_tree
    reg.register(len, name="n")
    with pytest.raises(KeyError):
        reg.register(abs, name="n")
    with pytest.raises(KeyError):
        reg.resolve("repro_torch.core.no_such_module.fn")


def test_remote_route_takes_targets_not_registered_here(port_rt):
    seen = []

    def route(p):
        seen.append(p.target)
        return core.make_ready_future("remote")

    def ident(o):
        return o

    def inc(o):
        return o + 1

    parcel.set_remote_route(route)
    try:
        assert parcel.apply(ident, "/parcel/elsewhere").get() == "remote"
        agas.default().register_name("/parcel/here", 3, replace=True)
        assert parcel.apply(inc, "/parcel/here").get() == 4
    finally:
        parcel.set_remote_route(None)
    assert seen == ["/parcel/elsewhere"]


def _sq_norm(obj, scale):
    return sum(float((np.asarray(v, np.float64) ** 2).sum()) for v in obj.values()) * scale


def _port_sq_norm(obj, scale):
    assert all(t.device.type == "cpu" for t in obj.values())  # where it lives
    return float(sum((t.double() ** 2).sum() for t in obj.values())) * scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parcel_matches_reference(rt, port_rt, seed):
    """The same seeded tree registered in both packages, one parcel each:
    the port's action runs on its tensors where they live and equals the
    reference's; each port's counters step by one."""
    rng = np.random.default_rng(seed)
    tree = {f"w{i}": rng.standard_normal((4, 3)).astype(np.float32) for i in range(3)}
    name = f"/parcel/parity{seed}"
    ragas.default().register_name(name, {k: v.copy() for k, v in tree.items()}, replace=True)
    agas.default().register_name(name, {k: torch.from_numpy(v.copy()) for k, v in tree.items()},
                                 replace=True)

    def sent(reg):
        return (reg.get_value("/parcel{port#0}/count/sent"),
                reg.get_value("/parcel{port#0}/actions/executed"))

    rparcel.default_port(), parcel.default_port()  # their counters exist
    r0, p0 = sent(rcore.counters), sent(counters)
    want = rparcel.apply(_sq_norm, name, 0.5).get(timeout=60)
    got = parcel.apply(_port_sq_norm, name, 0.5).get(timeout=60)
    assert got == pytest.approx(want, rel=1e-12)
    assert sent(rcore.counters) == (r0[0] + 1, r0[1] + 1)
    assert sent(counters) == (p0[0] + 1, p0[1] + 1)
