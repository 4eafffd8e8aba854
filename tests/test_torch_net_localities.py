"""The port's multi-locality runtime (``repro_torch.net``) against the
reference's: real processes, parcels over the wire, distributed AGAS with
generation-based cache invalidation (``tests/test_net_localities.py``), and
leak-proof bootstrap (``tests/test_net_bootstrap.py``).

One 3-locality fleet per package for the module (3 localities, so
worker↔worker traffic crosses the root's frame switch); every case makes
the same calls against both and compares results and counters.  Helper
actions are module-level plain functions: workers of either package
resolve them by dotted name (``test_torch_net_localities.<fn>``).  This
module imports neither package at its top, so a worker pays only for its
own."""

import contextlib

import numpy as np
import pytest


# ----------------------------------------------------------- the two sides
class _Side:
    """One package's net, AGAS, parcel and counter modules."""

    def __init__(self, name):
        self.name = name
        if name == "port":
            import repro_torch.core as core
            from repro_torch import net
            from repro_torch.core import agas, counters, parcel
            from repro_torch.net import locality, remote
        else:
            import repro.core as core
            from repro import net
            from repro.core import agas, counters, parcel
            from repro.net import locality, remote
        self.core, self.net, self.agas, self.counters = core, net, agas, counters
        self.parcel, self.locality, self.remote = parcel, locality, remote

    def array(self, n):
        """The state an object holds on this side: a tensor in the port, an
        array in the reference."""
        if self.name == "port":
            import torch

            return torch.arange(n, dtype=torch.float64)
        return np.arange(n, dtype=np.float64)


def _side_of(rt):
    return _Side("port" if type(rt).__module__.startswith("repro_torch") else "ref")


# ----------------------------------------------------------- helper actions
def tree_scale_sum(obj, s):
    """Object-targeted: runs where the data lives."""
    return float(sum(float(v.sum()) for v in obj.values()) * s)


def raise_value_error(obj, msg):
    raise ValueError(msg)


def echo_locality(rt, payload):
    return rt.locality, payload


def register_payload(rt, name, n):
    side = _side_of(rt)
    gid = side.agas.default().register({"x": side.array(n)}, name=name)
    return list(side.locality._gid_key(gid))


def fetch_by_name(rt, name):
    return _side_of(rt).remote.fetch(name)


def unregister_by_name(rt, name):
    a = _side_of(rt).agas.default()
    a.unregister(a.gid_of(name))


def record_generation(rt, name):
    a = _side_of(rt).agas.default()
    return a.record(a.gid_of(name)).generation


def _probe(rt):
    return rt.locality


# ------------------------------------------------------------------ fixture
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
    """``fn(side, net)`` on each package → {"ref": ..., "port": ...}."""
    return {name: fn(side, net) for name, (side, net) in fleets.items()}


def _host(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(x, np.ndarray) else x


# ---------------------------------------------------------------- bootstrap
@pytest.mark.parametrize("name", ["ref", "port"])
def test_running_reaps_workers_when_body_raises(rt, name):
    side = _Side(name)
    if name == "port":
        side.core.init(num_workers=4)
    try:
        procs = []
        with pytest.raises(RuntimeError, match="boom"):
            with side.net.running(3) as net:
                procs = list(net._procs.values())
                assert len(procs) == 2 and all(p.is_alive() for p in procs)
                assert side.net.run_on(2, _probe).get(timeout=60) == 2
                raise RuntimeError("boom")
        assert side.net.current() is None, "runtime must be uninstalled"
        for p in procs:
            p.join(timeout=30)
        assert all(not p.is_alive() for p in procs), "workers must be reaped"
        with side.net.running(1) as net:  # degenerate single-locality bootstrap
            assert net.is_root() and net.n_localities == 1 and not net._procs
            assert side.net.run_on(0, _probe).get(timeout=60) == 0
        assert side.net.current() is None
    finally:
        if name == "port":
            side.core.finalize()


# -------------------------------------------------------------------- tests
def test_run_on_round_trip_zero_copy_array(fleets):
    def call(side, net):
        loc, back = side.net.run_on(1, echo_locality, side.array(1024)).get(timeout=60)
        return loc, back

    out = _both(fleets, call)
    assert out["port"][0] == out["ref"][0] == 1
    assert isinstance(out["port"][1], np.ndarray)  # a tensor comes home as numpy
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])


def test_apply_remote_object_on_worker(fleets):
    def call(side, net):
        key = side.net.run_on(1, register_payload, "net-test/obj1", 16).get(timeout=60)
        gid = side.agas.GID(*key)
        by_gid = side.net.apply_remote(tree_scale_sum, gid, 3).get(timeout=60)
        by_name = side.net.apply_remote(tree_scale_sum, "net-test/obj1", 2).get(timeout=60)
        return gid.locality, by_gid, by_name, side.net.owner_of("net-test/obj1")

    out = _both(fleets, call)
    assert out["port"] == out["ref"] == (1, float(np.arange(16).sum()) * 3,
                                         float(np.arange(16).sum()) * 2, 1)


def test_core_parcel_apply_is_locality_transparent(fleets):
    def call(side, net):
        key = side.net.run_on(2, register_payload, "net-test/obj2", 8).get(timeout=60)
        return side.parcel.apply(tree_scale_sum, side.agas.GID(*key), 10).get(timeout=60)

    out = _both(fleets, call)
    assert out["port"] == out["ref"] == pytest.approx(float(np.arange(8).sum()) * 10)


def test_remote_exception_propagates(fleets):
    def call(side, net):
        key = side.net.run_on(1, register_payload, "net-test/obj3", 4).get(timeout=60)
        fut = side.net.apply_remote(raise_value_error, side.agas.GID(*key), "boom-net")
        with pytest.raises(ValueError, match="boom-net") as ei:
            fut.get(timeout=60)
        return ei.value.args

    out = _both(fleets, call)
    assert out["port"] == out["ref"] == ("boom-net",)


def test_unknown_gid_fails_fast(fleets):
    def call(side, net):
        stale0 = net.c_stale.get_value()
        fut = side.net.apply_remote(tree_scale_sum, side.agas.GID(1, 987654321), 1)
        with pytest.raises(side.net.UnknownGid) as ei:
            fut.get(timeout=60)
        return ei.value.key, ei.value.locality, net.c_stale.get_value() - stale0

    out = _both(fleets, call)
    assert out["port"] == out["ref"]
    assert out["port"][0] == (1, 987654321)


def test_migrate_remote_keeps_gid_and_bumps_generation(fleets):
    def call(side, net):
        key = side.net.run_on(1, register_payload, "net-test/mig", 32).get(timeout=60)
        gid = side.agas.GID(*key)
        first = side.net.apply_remote(tree_scale_sum, gid, 1).get(timeout=60)
        gen0 = side.net.run_on(1, record_generation, "net-test/mig").get(timeout=60)
        gen = side.net.migrate_remote(gid, 2)
        after = side.net.apply_remote(tree_scale_sum, gid, 2).get(timeout=60)
        state = side.net.run_on(1, fetch_by_name, "net-test/mig").get(timeout=60)
        with pytest.raises(side.net.UnknownGid):
            net.send_parcel(1, side.remote._action_name(tree_scale_sum), tuple(key),
                            (1,)).get(timeout=60)
        meta = side.net.describe(gid)
        return (first, gen0, gen, after, _host(state["x"]), side.net.owner_of(gid),
                meta["gid"], meta["name"], meta["generation"])

    out = _both(fleets, call)
    p, r = out["port"], out["ref"]
    assert p[:4] == r[:4] and p[5:] == r[5:]
    np.testing.assert_array_equal(p[4], r[4])
    assert p[2] == p[1] + 1 and p[5] == 2 and p[8] == p[2]
    assert p[6] == list(p[6]) and tuple(p[6])[0] == 1  # the GID (minted at 1) is kept


def test_worker_to_worker_via_root_switch(fleets):
    def call(side, net):
        side.net.run_on(2, register_payload, "net-test/fwd", 5).get(timeout=60)
        before = net.c_forwarded.get_value()
        state = side.net.run_on(1, fetch_by_name, "net-test/fwd").get(timeout=60)
        return _host(state["x"]), net.c_forwarded.get_value() > before

    out = _both(fleets, call)
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    assert out["port"][1] and out["ref"][1]


def test_query_counters_remote_snapshot(fleets):
    def call(side, net):
        got = dict(side.net.query_counters(1, "/scheduler{*"))
        pp = dict(side.net.query_counters(2, "/net{locality#2*"))
        stats = side.net.query_counter_stats(2, "/net{locality#2}/actions/executed")
        export = side.net.query_counter_export(2, "/net{locality#2}/actions/executed")
        return (sorted(k for k in got if k.endswith("/tasks/executed")),
                sum(v for k, v in got.items() if k.endswith("/tasks/executed")) > 0,
                sorted(k.split("}")[-1] for k in pp), sorted(stats), sorted(export))

    out = _both(fleets, call)
    assert out["port"] == out["ref"]
    assert out["port"][1] and "/parcels/received" in out["port"][2]


def test_counter_sweep_over_every_locality(fleets):
    def call(side, net):
        sweep = side.net.query_counters(None, "/net{locality#*}/actions/executed")
        return sorted(sweep), [len(v) for _, v in sorted(sweep.items())]

    out = _both(fleets, call)
    assert out["port"] == out["ref"] == ([0, 1, 2], [1, 1, 1])


def test_fetch_remote_state(fleets):
    def call(side, net):
        side.net.run_on(1, register_payload, "net-test/fetch", 6).get(timeout=60)
        return _host(side.net.fetch("net-test/fetch")["x"])

    out = _both(fleets, call)
    np.testing.assert_array_equal(out["port"], out["ref"])
    assert out["port"].dtype == np.float64


def test_net_counters_on_root(fleets):
    def call(side, net):
        sent = dict(side.counters.query("/net{locality#0/peer#*}/parcels/sent"))
        recv = dict(side.counters.query("/net{locality#0/peer#*}/bytes/received"))
        return sorted(sent), sum(sent.values()) > 0, sum(recv.values()) > 0

    out = _both(fleets, call)
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["/net{locality#0/peer#1}/parcels/sent",
                              "/net{locality#0/peer#2}/parcels/sent"]


def test_local_dispatch_leaves_no_pending_entry(fleets):
    def call(side, net):
        gid = side.agas.default().register({"x": side.array(3)}, name="net-test/local")
        before = len(net._pending)
        got = side.net.apply_remote(tree_scale_sum, gid, 2).get(timeout=60)
        home = side.net.run_on(0, echo_locality, "home").get(timeout=60)
        return got, home, len(net._pending) <= before

    out = _both(fleets, call)
    assert out["port"] == out["ref"] == (6.0, (0, "home"), True)


def test_sweep_marks_a_dead_peer(fleets):
    """A worker of each fleet is killed outright: the strict read raises
    ``PortClosed``, the sweep marks the corpse instead of raising.  This
    case runs last in the module: it costs the fleets locality 2."""
    def crash(side, net):
        import time

        net._procs[2].kill()
        deadline = time.monotonic() + 30
        while 2 in net.live_ids() and time.monotonic() < deadline:
            time.sleep(0.05)
        sweep = side.net.query_counters([0, 1, 2], "/net{locality#*}/actions/executed")
        with pytest.raises(side.net.PortClosed):
            side.net.query_counters(2, "*")
        return (2 in net.live_ids(), sorted(sweep),
                isinstance(sweep[2], dict) and "error" in sweep[2],
                isinstance(sweep[0], list), isinstance(sweep[1], list))

    out = _both(fleets, crash)
    assert out["port"] == out["ref"] == (False, [0, 1, 2], True, True, True)
