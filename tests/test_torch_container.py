"""The port's partitioned vectors and segmented algorithms
(``repro_torch.container``) against the reference's
(``tests/test_container.py``): a 3-locality fleet of each package side by
side, the same seeded numpy data in both, and every algorithm on block,
cyclic and explicit layouts (an empty and a single-element segment among
them) compared value for value **and dtype for dtype** — the port follows
numpy's promotions here, as the reference's numpy segments do.  Also the
three distributions' geometry, element access, the two-way ``task``
policy, the empty vector, lambdas refused, ``free``, ``attach`` from a
worker, ``for_each`` moving no element bytes, and ``move_segment`` /
``rebalance`` under concurrent reads keeping the GID, the contents and the
segment's device (a tensor on ``cpu`` here; ``chip_smoke.py`` phase 11
holds ``cuda``).

Bodies and ops live at module level: segmented algorithms ship them to the
data pickled by reference, and workers of either package resolve them by
dotted name.  Each works on numpy scalars (the reference's segments) and
on tensors (the port's).  This module imports neither package at its top,
so a worker pays only for its own."""

import contextlib
import itertools
import operator
import threading

import numpy as np
import pytest


# ----------------------------------------------------- module-level bodies
def aff(x):
    return 3 * x + 1


def sq(x):
    return x * x


def is_even(x):
    return x % 2 == 0


def nonneg(x):
    return x >= 0


def touch(x):
    pass


def iota(idx):
    return idx.astype(np.float64)


def _side_of(rt):
    return _Side("port" if type(rt).__module__.startswith("repro_torch") else "ref")


def attach_probe(rt, name):
    """Runs on a worker: attach by name and read through the handle."""
    pv = _side_of(rt).PV.attach(name)
    return [len(pv), pv.nsegments, float(pv.get(0))]


def segment_kind(rt, key):
    """Runs at a segment's owner: what the segment is there."""
    side = _side_of(rt)
    obj = side.agas.default().resolve(side.agas.GID(*key))
    kind = type(obj).__module__.split(".")[0]
    return kind, str(obj.device) if kind == "torch" else "host"


# ----------------------------------------------------------- the two sides
class _Side:
    """One package's net, algorithms, policies and containers."""

    def __init__(self, name):
        self.name = name
        if name == "port":
            import repro_torch.core as core
            from repro_torch import net
            from repro_torch.container import PartitionedVector, distribution
            from repro_torch.core import agas
            from repro_torch.core import algorithms as alg
            from repro_torch.core.executor import par, par_task
            from repro_torch.core.future import Future
        else:
            import repro.core as core
            from repro import net
            from repro.container import PartitionedVector, distribution
            from repro.core import agas
            from repro.core import algorithms as alg
            from repro.core.executor import par, par_task
            from repro.core.future import Future
        self.core, self.net, self.PV, self.dist = core, net, PartitionedVector, distribution
        self.agas, self.alg, self.par, self.par_task, self.Future = agas, alg, par, par_task, Future

    def layout(self, spec):
        """``"block"`` / ``"cyclic"`` / ``("explicit", sizes, owners)``."""
        if isinstance(spec, tuple):
            return self.dist.explicit(spec[1], spec[2])
        return spec

    def create(self, name, length, dtype=np.float64, layout="block", **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.PV.create(name, length, dtype=dtype,
                              distribution=self.layout(layout), **kw)

    def vector(self, name, xs, layout="block", dtype=None):
        xs = np.asarray(xs, dtype=dtype)
        pv = self.create(name, len(xs), dtype=xs.dtype, layout=layout,
                         element_shape=xs.shape[1:])
        if len(xs):
            pv.set_slice(0, len(xs), xs)
        return pv


def _np(x):
    """A result as numpy: the port's CPU tensors, the reference's arrays."""
    if hasattr(x, "numpy") and not isinstance(x, np.ndarray):
        return x.numpy()
    return x


def _np_of(torch_dtype):
    import torch

    return torch.empty(0, dtype=torch_dtype).numpy().dtype


def _same(p, r, what, rtol=0.0):
    """The port's result ``p`` equals the reference's ``r``: type, dtype,
    shape and values."""
    if hasattr(r, "to_array"):  # a result vector
        assert _np_of(p.dtype) == r.dtype, (what, p.dtype, r.dtype)
        p, r = p.to_array(), r.to_array()
    p, r = _np(p), r
    if isinstance(r, np.ndarray):
        assert isinstance(p, np.ndarray) and p.dtype == r.dtype, (what, p, r)
        assert p.shape == r.shape, (what, p.shape, r.shape)
        np.testing.assert_allclose(p, r, rtol=rtol, atol=0, err_msg=what)
    else:
        assert type(p) is type(r), (what, type(p), type(r))
        if rtol:
            np.testing.assert_allclose(p, r, rtol=rtol, atol=0, err_msg=what)
        else:
            assert p == r, (what, p, r)


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


_uid = itertools.count()


def _both(fleets, fn):
    """``fn(side, net)`` on each package → {"ref": ..., "port": ...}."""
    return {name: fn(side, net) for name, (side, net) in fleets.items()}


N = 23
LAYOUTS = {"block": "block", "cyclic": "cyclic",
           # an empty and a single-element segment, owners not in order
           "explicit": ("explicit", [0, 1, N - 1], [2, 0, 1])}
DTYPES = ["int64", "int32", "float64", "float32"]


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(-50, 50, size=N)
    if dtype.startswith("float"):
        xs = xs / 4  # quarters: every sum and scan here is exact
    return xs.astype(dtype)


def _mul_data(dtype, seed=1):
    """Products of these stay within int32."""
    return np.random.default_rng(seed).choice([-1, 1, 1, 2], size=N).astype(dtype)


# ----------------------------------------------------- distribution geometry
@pytest.mark.parametrize("spec", [("block", 23, [0, 1, 2]), ("cyclic", 23, [0, 1, 2]),
                                  ("block", 2, [0, 1, 2]), ("cyclic", 0, [1, 0]),
                                  ("explicit", [0, 1, 4], [2, 0, 1]),
                                  ("explicit", [3, 0, 0, 5], [1, 1, 0, 2])])
def test_distribution_geometry_matches_reference(spec):
    from repro.container import distribution as rdist
    from repro_torch.container import distribution as tdist

    kind, a, b = spec
    r, t = getattr(rdist, kind)(a, b), getattr(tdist, kind)(a, b)
    assert (t.kind, t.length, t.sizes, t.owners, t.nsegments, t.contiguous, t.offsets) == \
        (r.kind, r.length, r.sizes, r.owners, r.nsegments, r.contiguous, r.offsets)
    assert t.to_meta() == r.to_meta()
    assert tdist.Distribution.from_meta(r.to_meta()) == t
    for j in range(t.nsegments):
        np.testing.assert_array_equal(t.global_indices(j), r.global_indices(j))
        assert t.global_indices(j).dtype == np.int64
    for i in range(t.length):
        assert t.segment_of(i) == r.segment_of(i)
    for lo, hi in ((0, t.length), (1, t.length - 1), (t.length, t.length)):
        if not 0 <= lo <= hi <= t.length:
            continue
        for (js, ls, ps), (jr, lr, pr) in zip(t.locate_range(lo, hi), r.locate_range(lo, hi),
                                              strict=True):
            assert js == jr
            np.testing.assert_array_equal(ls, lr)
            np.testing.assert_array_equal(ps, pr)
    for mod in (rdist, tdist):
        with pytest.raises(IndexError):
            getattr(mod, kind)(a, b).segment_of(t.length)


def test_distribution_errors_match_reference():
    from repro.container import distribution as rdist
    from repro_torch.container import distribution as tdist

    for call in (lambda m: m.explicit([1, 2], [0]), lambda m: m.explicit([-1], [0]),
                 lambda m: m.block(4, []), lambda m: m.cyclic(4, []),
                 lambda m: m.make("diagonal", 4, [0]), lambda m: m.make([1, 2], 4, [0]),
                 lambda m: m.make(m.block(3, [0]), 4, [0])):
        msgs = []
        for mod in (rdist, tdist):
            with pytest.raises(ValueError) as e:
                call(mod)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert tdist.make([2, 2], 4, [0, 1]).to_meta() == rdist.make([2, 2], 4, [0, 1]).to_meta()


# ------------------------------------------------------- creation and access
def test_create_access_and_attach_from_worker(fleets):
    xs = np.arange(20.0) * 2 - 5

    def call(side, net):
        pv = side.vector(f"tc/acc{next(_uid)}", xs)
        out = [_np(pv.to_array()), pv.get(7), pv[19], pv[-1]]
        pv.set(3, -99.0)
        pv[4] = -100.0
        pv[-2] = 123.0
        out += [_np(pv[3:6]), pv.get(18), sorted(pv.owners()), len(pv), pv.nsegments]
        with pytest.raises(ValueError, match="module level"):
            pv.fill_with(lambda idx: idx)  # loud, not a pickling traceback
        out.append(side.net.run_on(1, attach_probe, pv.name).get(timeout=60))
        return out

    out = _both(fleets, call)
    p, r = out["port"], out["ref"]
    for a, b in zip(p, r, strict=True):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b
    assert p[-1] == [20, 3, float(xs[0])]


def test_element_shaped_vector_matches_reference(fleets):
    """Array-valued elements: rows in and out, a segmented reduce and
    scans of rows, a transform, and the extrema (numpy's: over every
    component)."""
    xs = np.random.default_rng(2).integers(-9, 9, size=(10, 3)).astype(np.int64)

    def call(side, net):
        pv = side.vector(f"tc/rows{next(_uid)}", xs,
                         layout=side.layout(("explicit", [4, 0, 1, 5], [1, 2, 0, 1])))
        a = side.alg
        return [pv.get(4), pv.to_array(), a.reduce(side.par, pv, init=1),
                a.transform(side.par, pv, aff), a.inclusive_scan(side.par, pv),
                a.exclusive_scan(side.par, pv, init=0), a.min_element(side.par, pv),
                a.max_element(side.par, pv)]

    out = _both(fleets, call)
    for i, (p, r) in enumerate(zip(out["port"], out["ref"], strict=True)):
        _same(p, r, f"result {i}")


def test_create_without_cpu_raises_here(fleets):
    """No CUDA here: the default device is ``cuda``, and it raises."""
    side, _net = fleets["port"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        side.PV.create(f"tc/cuda{next(_uid)}", 4)
    pv = side.create(f"tc/cpu{next(_uid)}", 4)
    assert pv.device == "cpu" and side.PV.attach(pv.name).device == "cpu"
    with pytest.raises(TypeError, match="bfloat16"):
        import torch

        side.PV.create(f"tc/bf16{next(_uid)}", 4, dtype=torch.bfloat16, device="cpu")


# -------------------------------------------- segmented against the reference
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_segmented_algorithms_match_reference(fleets, layout, dtype):
    xs, ms = _data(dtype), _mul_data(dtype)

    def call(side, net):
        a, par = side.alg, side.par
        pv = side.vector(f"tc/alg{next(_uid)}", xs, LAYOUTS[layout])
        mv = side.vector(f"tc/mul{next(_uid)}", ms, LAYOUTS[layout])
        res = {
            "reduce": a.reduce(par, pv),
            "reduce init 5": a.reduce(par, pv, init=5),
            "reduce init 0.5": a.reduce(par, pv, init=0.5),
            "transform_reduce": a.transform_reduce(par, pv, sq, init=2),
            "count_if": a.count_if(par, pv, is_even),
            "all_of": a.all_of(par, pv, nonneg),
            "any_of": a.any_of(par, pv, is_even),
            "transform": a.transform(par, pv, aff),
            "predicate transform": a.transform(par, pv, is_even),
            "inclusive_scan": a.inclusive_scan(par, pv),
            "exclusive_scan init 7": a.exclusive_scan(par, pv, init=7),
            "exclusive_scan init 0.5": a.exclusive_scan(par, pv, init=0.5),
            "min_element": a.min_element(par, pv),
            "max_element": a.max_element(par, pv),
            "reduce mul": a.reduce(par, mv, 1, operator.mul),
            "inclusive_scan mul": a.inclusive_scan(par, mv, operator.mul),
            "exclusive_scan mul": a.exclusive_scan(par, mv, 2, operator.mul),
        }
        res = {k: (_np(v.to_array()), v) if hasattr(v, "to_array") else v
               for k, v in res.items()}
        a.sort(par, pv)
        res["sort"] = _np(pv.to_array())
        assert a.fill(par, pv, 9) is pv
        res["fill"] = _np(pv.to_array())
        return res

    out = _both(fleets, call)
    p, r = out["port"], out["ref"]
    assert p.keys() == r.keys()
    for k in r:
        if isinstance(r[k], tuple):  # a result vector: its handle's dtype too
            assert _np_of(p[k][1].dtype) == r[k][1].dtype, (k, p[k][1].dtype, r[k][1].dtype)
            _same(p[k][0], r[k][0], k)
        else:
            _same(p[k], r[k], k)


def test_scan_float_carry_over_int_segments_promotes(fleets):
    def call(side, net):
        pv = side.vector(f"tc/prom{next(_uid)}", [1, 2, 3, 4, 5, 6], dtype=np.int64)
        exc = side.alg.exclusive_scan(side.par, pv, init=0.5)
        return exc, _np(exc.to_array()), _np(exc.slice(0, 6))

    out = _both(fleets, call)
    want = [0.5, 1.5, 3.5, 6.5, 10.5, 15.5]
    for name, (exc, full, part) in out.items():
        assert full.tolist() == want and part.tolist() == want, name
        assert full.dtype == part.dtype == np.float64, name
    import torch

    assert out["port"][0].dtype == torch.float64 and out["ref"][0].dtype == np.float64


def test_segmented_empty_vector(fleets):
    def call(side, net):
        a, par = side.alg, side.par
        pv = side.vector(f"tc/empty{next(_uid)}", np.zeros(0))
        with pytest.raises(ValueError, match="empty") as e:
            a.min_element(par, pv)
        return [len(pv), _np(pv.to_array()), a.reduce(par, pv, init=3),
                a.count_if(par, pv, is_even), a.all_of(par, pv, is_even),
                a.any_of(par, pv, is_even),
                _np(a.exclusive_scan(par, pv, init=2).to_array()), str(e.value)]

    out = _both(fleets, call)
    p, r = out["port"], out["ref"]
    assert p[0] == r[0] == 0
    assert p[1].shape == r[1].shape == (0,) and p[1].dtype == r[1].dtype
    assert p[2:5] == r[2:5] == [3, 0, True]
    assert p[5] is r[5] is False
    assert p[6].size == r[6].size == 0 and p[6].dtype == r[6].dtype
    assert p[7] == r[7]


def test_segmented_two_way_task_policy(fleets):
    def call(side, net):
        pv = side.vector(f"tc/task{next(_uid)}", np.arange(12.0))
        f = side.alg.reduce(side.par_task, pv)
        f2 = side.alg.inclusive_scan(side.par_task, pv)
        f3 = side.alg.count_if(side.par_task, pv, is_even)
        f4 = side.alg.sort(side.par_task, pv)
        futs = [isinstance(x, side.Future) for x in (f, f2, f3, f4)]
        return (futs, f.get(timeout=60), _np(f2.get(timeout=120).to_array()),
                f3.get(timeout=60), f4.get(timeout=60) is pv)

    out = _both(fleets, call)
    p, r = out["port"], out["ref"]
    assert p[0] == r[0] == [True] * 4
    _same(p[1], r[1], "reduce")
    _same(p[2], r[2], "scan")
    assert p[3] == r[3] == 6 and p[4] and r[4]


def test_lambda_bodies_fail_loudly(fleets):
    def call(side, net):
        pv = side.vector(f"tc/lam{next(_uid)}", [1.0, 2.0])
        msgs = []
        for run in (lambda: side.alg.count_if(side.par, pv, lambda x: True),
                    lambda: side.alg.reduce(side.par, pv, 0, lambda x, y: x)):
            with pytest.raises(ValueError, match="module level") as e:
                run()
            msgs.append(str(e.value))
        return msgs

    out = _both(fleets, call)
    assert out["port"] == out["ref"]


def test_bodies_that_cannot_vectorize_raise(fleets):
    """A segment body runs as tensor code over the whole segment; one that
    needs a Python value of an element raises, naming the cause."""
    side, _net = fleets["port"]
    pv = side.vector(f"tc/novec{next(_uid)}", [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="cannot run as tensor code"):
        side.alg.count_if(side.par, pv, host_only)


def host_only(x):
    return float(x) > 1.5


def test_free_releases_segments_and_name(fleets):
    def call(side, net):
        pv = side.vector(f"tc/free{next(_uid)}", np.arange(6.0))
        name, gid0 = pv.name, pv.segment_gid(0)
        t = side.alg.transform(side.par, pv, aff)
        t_total = side.alg.reduce(side.par, t)
        t.free()
        with pytest.raises(side.net.UnknownGid):
            side.net.apply_remote(attach_probe, t.segment_gid(1)).get(timeout=60)
        pv.free()
        gone = (side.agas.default().contains(gid0), side.agas.default().contains(name))
        pv2 = side.create(name, 3)
        n = len(side.PV.attach(name))
        pv2.free()
        return t_total, gone, n

    out = _both(fleets, call)
    _same(out["port"][0], out["ref"][0], "total")
    assert out["port"][1:] == out["ref"][1:] == ((False, False), 3)


# --------------------------------------------------- work went to the data
def _wire_bytes(side, net):
    total = 0.0
    for loc in range(net.n_localities):
        total += sum(v for _k, v in side.net.query_counters(loc, "/net{*}/bytes/sent"))
    return total


def test_for_each_moves_no_element_bytes(fleets):
    n = 40_000  # 320 KB of float64 elements

    def call(side, net):
        pv = side.create(f"tc/bytes{next(_uid)}", n)
        pv.fill_with(iota)
        before = _wire_bytes(side, net)
        side.alg.for_each(side.par, pv, touch)
        mid = _wire_bytes(side, net)
        total = side.alg.reduce(side.par, pv)
        after_reduce = _wire_bytes(side, net)
        pv.to_array()
        after = _wire_bytes(side, net)
        return mid - before, after - after_reduce, after_reduce - mid, total

    out = _both(fleets, call)
    element_bytes = n * 8
    for name, (d_foreach, d_fetch_all, d_reduce, total) in out.items():
        assert d_fetch_all > 0.6 * element_bytes, f"{name}: fetch-all must move the data"
        assert d_foreach < element_bytes * 0.05, \
            f"{name}: for_each moved {d_foreach} bytes — work did not go to the data"
        assert d_foreach < d_fetch_all / 10
        assert d_reduce < element_bytes * 0.05
    _same(out["port"][3], out["ref"][3], "sum")


# ----------------------------------------------------- placement / rebalance
def test_move_segment_keeps_gid_contents_and_device(fleets):
    xs = np.arange(9.0)

    def call(side, net):
        pv = side.vector(f"tc/mv{next(_uid)}", xs)
        gid = pv.segment_gid(0)
        pv.move_segment(0, 2)
        kind = side.net.run_on(2, segment_kind, list(pv.segment_keys[0])).get(timeout=60)
        return pv.owner_of(0), pv.segment_gid(0) == gid, _np(pv.to_array()), kind

    out = _both(fleets, call)
    p, r = out["port"], out["ref"]
    assert p[:2] == r[:2] == (2, True)
    np.testing.assert_array_equal(p[2], xs)
    np.testing.assert_array_equal(r[2], xs)
    assert p[3] == ("torch", "cpu") and r[3] == ("numpy", "host")


def test_rebalance_preserves_contents_under_concurrent_reads(fleets):
    xs = np.arange(400.0)

    def call(side, net):
        pv = side.vector(f"tc/reb{next(_uid)}", xs)
        stop = threading.Event()
        errors = []

        def reader():
            rng = np.random.default_rng(0)
            while not stop.is_set():
                lo = int(rng.integers(0, 360))
                try:
                    got = _np(pv.slice(lo, lo + 32))
                    if not np.array_equal(got, xs[lo:lo + 32]):
                        errors.append((lo, got))
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        gids = [pv.segment_gid(j) for j in range(pv.nsegments)]
        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        try:
            moves = [pv.rebalance([1, 2, 0]), pv.rebalance([2, 0, 1])]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        kinds = [side.net.run_on(o, segment_kind, list(k)).get(timeout=60)
                 for o, k in zip(pv.owners(), pv.segment_keys)]
        return (errors, moves, pv.owners(), _np(pv.to_array()),
                [pv.segment_gid(j) for j in range(pv.nsegments)] == gids, kinds)

    out = _both(fleets, call)
    for name, (errors, moves, owners, arr, same_gids, kinds) in out.items():
        assert not errors, (name, errors[:3])
        assert moves == [[1, 2, 0], [2, 0, 1]] and owners == [2, 0, 1], name
        np.testing.assert_array_equal(arr, xs)
        assert same_gids, name
    assert out["port"][5] == [("torch", "cpu")] * 3
