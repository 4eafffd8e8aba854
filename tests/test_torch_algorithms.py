"""The port's C++17-style parallel algorithms (``repro_torch.core.algorithms``):
the reference's cases of ``test_core_algorithms.py`` on the port (every
policy agrees with the seq oracle; the reference's device-mesh policy waits
for the port's mesh, so its parametrisations drop out), and each algorithm
under each policy against the reference on the same numpy-seeded input —
the reference's ``vec`` on JAX's CPU beside the port's on CPU tensors.
Integers and orderings must be equal; fp32 sums and scans agree within
1e-6 of the sum of the magnitudes they add (both sides round each partial
sum to fp32, in different orders).

``vec`` runs on a tensor's own device, and data that is not a tensor
becomes one on ``cuda``: without CUDA it raises.  So these cases hand
``vec`` CPU tensors."""
import operator

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as rcore
import repro.core.executor as rexec
import repro_torch.core as core
from repro.core import algorithms as ralg
from repro_torch.core import algorithms as alg
from repro_torch.core.executor import par, par_task, seq, seq_task, vec
from repro_torch.core.future import Future

ints = st.lists(st.integers(-1000, 1000), min_size=1, max_size=200)


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def _t(xs, dtype=torch.int64):
    return torch.tensor(xs, dtype=dtype)


@settings(max_examples=20, deadline=None)
@given(ints)
def test_reduce_par_matches_seq(port_rt, xs):
    assert alg.reduce(par, xs) == alg.reduce(seq, xs) == sum(xs)


@settings(max_examples=20, deadline=None)
@given(ints)
def test_sort_par_matches_sorted(port_rt, xs):
    assert alg.sort(par, xs) == sorted(xs)
    assert alg.sort(vec, _t(xs)).tolist() == sorted(xs)


@settings(max_examples=20, deadline=None)
@given(ints)
def test_transform_policies_agree(port_rt, xs):
    f = lambda x: 3 * x + 1
    s = alg.transform(seq, xs, f)
    p = alg.transform(par, xs, f)
    v = alg.transform(vec, _t(xs), f).tolist()
    assert s == p == v


@settings(max_examples=20, deadline=None)
@given(ints)
def test_scans_match_numpy(port_rt, xs):
    inc = alg.inclusive_scan(seq, xs)
    assert inc == list(np.cumsum(xs))
    exc = alg.exclusive_scan(seq, xs, init=0)
    assert exc == [0] + list(np.cumsum(xs))[:-1]
    vinc = alg.inclusive_scan(vec, _t(xs)).tolist()
    assert vinc == inc


@settings(max_examples=20, deadline=None)
@given(ints)
def test_count_if_and_predicates(port_rt, xs):
    even = lambda x: x % 2 == 0
    n = alg.count_if(par, xs, even)
    assert n == sum(1 for x in xs if even(x))
    assert alg.any_of(par, xs, even) == (n > 0)
    assert alg.all_of(par, xs, even) == (n == len(xs))


def test_transform_reduce(port_rt):
    xs = list(range(100))
    assert alg.transform_reduce(par, xs, lambda x: x * x) == sum(x * x for x in xs)
    assert int(alg.transform_reduce(vec, torch.arange(100), lambda x: x * x)) == sum(
        x * x for x in xs)


def test_for_each_side_effects(port_rt):
    lock_free = [0] * 50
    alg.for_each(seq, range(50), lambda i: lock_free.__setitem__(i, i * 2))
    assert lock_free == [2 * i for i in range(50)]


def test_chunk_size_override(port_rt):
    xs = list(range(1000))
    assert alg.reduce(par.with_chunk_size(10), xs) == sum(xs)


# ---------------------------------------------------- cross-policy properties
POLICIES = [
    ("par", lambda: par),
    ("par_chunked", lambda: par.with_(chunk_size=3)),
    ("par_task", lambda: par_task),
    ("seq_task", lambda: seq_task),
    ("vec", lambda: vec),
]


def _data(name, xs):
    """vec takes a tensor (data that is not one would go to ``cuda``)."""
    return _t(xs) if name == "vec" else xs


def _val(x):
    """Materialize a policy result (Future under task policies, tensor
    under vec, list under host) into comparable python values."""
    if isinstance(x, Future):
        x = x.get(timeout=300)
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, (list, tuple)):
        return [float(v) for v in x]
    arr = torch.as_tensor(x)
    return float(arr) if arr.ndim == 0 else [float(v) for v in arr.tolist()]


@pytest.mark.parametrize("name,mk", POLICIES)
@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(-50, 50), min_size=0, max_size=60))
def test_every_algorithm_agrees_with_seq_oracle(port_rt, name, mk, xs):
    pol, d = mk(), _data(name, xs)
    fn = lambda x: 3 * x + 1
    even = lambda x: x % 2 == 0
    assert _val(alg.transform(pol, d, fn)) == _val(alg.transform(seq, xs, fn))
    assert _val(alg.reduce(pol, d)) == float(sum(xs))
    assert _val(alg.transform_reduce(pol, d, fn)) == float(sum(map(fn, xs)))
    assert _val(alg.sort(pol, d)) == [float(v) for v in sorted(xs)]
    assert _val(alg.count_if(pol, d, even)) == sum(1 for x in xs if even(x))
    assert _val(alg.all_of(pol, d, even)) == all(even(x) for x in xs)
    assert _val(alg.any_of(pol, d, even)) == any(even(x) for x in xs)
    assert _val(alg.copy(pol, d)) == [float(v) for v in xs]
    assert _val(alg.inclusive_scan(pol, d)) == _val(alg.inclusive_scan(seq, xs))
    assert _val(alg.exclusive_scan(pol, d, init=7)) == _val(
        alg.exclusive_scan(seq, xs, init=7))


@pytest.mark.parametrize("name,mk", POLICIES)
@pytest.mark.parametrize("xs", [[], [4]], ids=["empty", "one"])
def test_edge_inputs_agree(port_rt, name, mk, xs):
    pol, d = mk(), _data(name, xs)
    fn = lambda x: x * 2
    assert _val(alg.transform(pol, d, fn)) == [float(fn(x)) for x in xs]
    assert _val(alg.reduce(pol, d, init=5)) == float(5 + sum(xs))
    assert _val(alg.sort(pol, d)) == [float(x) for x in xs]
    assert _val(alg.inclusive_scan(pol, d)) == [float(v) for v in np.cumsum(xs)]
    # C++ semantics: an exclusive scan over an empty range writes nothing
    assert _val(alg.exclusive_scan(pol, d, init=2)) == ([2.0] if xs else [])
    assert _val(alg.count_if(pol, d, lambda x: x > 0)) == len(xs)
    assert _val(alg.all_of(pol, d, lambda x: x > 0)) is True  # vacuous on []
    assert _val(alg.any_of(pol, d, lambda x: x > 0)) is bool(xs)


# -------------------------------------------------------- par_task two-way
def test_par_task_returns_futures(port_rt):
    xs = list(range(64))
    for res in (alg.transform(par_task, xs, lambda x: x + 1),
                alg.reduce(par_task, xs),
                alg.sort(par_task, xs),
                alg.inclusive_scan(par_task, xs),
                alg.exclusive_scan(par_task, xs),
                alg.count_if(par_task, xs, lambda x: x % 3 == 0),
                alg.all_of(par_task, xs, lambda x: x >= 0),
                alg.for_each(par_task, xs, lambda x: None),
                alg.copy(par_task, xs)):
        assert isinstance(res, Future), res
        res.get(timeout=300)
    # eager policies return plain values
    assert not isinstance(alg.reduce(par, xs), Future)
    assert not isinstance(alg.transform(vec, _t(xs), lambda x: x), Future)


def test_task_futures_carry_exceptions(port_rt):
    def boom(x):
        raise RuntimeError("body failed")

    f = alg.transform(par_task, [1, 2, 3], boom)
    assert isinstance(f, Future)
    with pytest.raises(RuntimeError, match="body failed"):
        f.get(timeout=60)


# ------------------------------------------------- scans with generic ops
GENERIC_OPS = [("mul", operator.mul), ("min", torch.minimum), ("max", torch.maximum)]


@pytest.mark.parametrize("pname,mk", [("par", lambda: par), ("vec", lambda: vec)])
@pytest.mark.parametrize("oname,op", GENERIC_OPS)
def test_scans_generic_ops_match_seq(port_rt, pname, mk, oname, op):
    xs = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    pol = mk()
    d = _t(xs, torch.float32) if pname == "vec" else _t(xs, torch.float32).unbind()
    host = _t(xs, torch.float32).unbind()  # the seq oracle over 0-d tensors
    assert _val(alg.inclusive_scan(pol, d, op=op)) == pytest.approx(
        _val(alg.inclusive_scan(seq, host, op=op)))
    assert _val(alg.exclusive_scan(pol, d, init=torch.tensor(2.0), op=op)) == pytest.approx(
        _val(alg.exclusive_scan(seq, host, init=torch.tensor(2.0), op=op)))
    assert _val(alg.reduce(pol, d, init=torch.tensor(2.0), op=op)) == pytest.approx(
        _val(alg.reduce(seq, host, init=torch.tensor(2.0), op=op)))


def test_exclusive_scan_float_init_over_int_data_promotes(port_rt):
    # seq oracle: [0.5, 1.5, 3.5] — vec must promote, never truncate init
    want = [0.5, 1.5, 3.5]
    assert alg.exclusive_scan(seq, [1, 2, 3], init=0.5) == want
    assert _val(alg.exclusive_scan(vec, _t([1, 2, 3]), init=0.5)) == pytest.approx(want)


def test_batched_elements_agree_with_seq_oracle(port_rt):
    """Elements that are tensors (shape (3,)): the add fast paths must fold
    along dim 0, not collapse the element dimension."""
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
    want_red = alg.reduce(seq, list(rows), init=0.0)
    want_inc = torch.stack(alg.inclusive_scan(seq, list(rows)))
    got_red = alg.reduce(vec, rows, init=0.0)
    assert got_red.shape == (3,)
    torch.testing.assert_close(got_red, want_red, rtol=1e-5, atol=1e-6)
    got_inc = alg.inclusive_scan(vec, rows)
    assert got_inc.shape == (6, 3)
    torch.testing.assert_close(got_inc, want_inc, rtol=1e-5, atol=1e-6)
    got_exc = alg.exclusive_scan(vec, rows, init=0.0)
    want_exc = torch.cat([torch.zeros(1, 3), want_inc[:-1]])
    assert got_exc.shape == (6, 3)
    torch.testing.assert_close(got_exc, want_exc, rtol=1e-5, atol=1e-6)


def test_task_combine_and_vec_offload_respect_bound_pool(port_rt):
    """A policy bound to a named pool keeps *all* its work there: the task
    combine continuation and the vec dispatch both land on that pool."""
    from repro_torch.core import counters

    def executed(pool):
        return counters.get_value(f"/scheduler{{{pool}}}/tasks/executed")

    io_ex = port_rt.get_executor("io", fallback="default")
    before = executed("io")
    res = alg.sort(par_task.on(io_ex), [3, 1, 2]).get(timeout=60)
    assert res == [1, 2, 3]
    port_rt.drain(timeout=30)
    after_task = executed("io")
    assert after_task > before + 1  # chunks AND the combine ran on io
    out = alg.transform(vec.on(io_ex), torch.arange(8.0), lambda x: x * 2)
    assert out.tolist() == [2.0 * i for i in range(8)]
    assert executed("io") > after_task  # vec dispatch offloaded to io


def test_reduce_non_commutative_op_preserves_order(port_rt):
    """Associative but non-commutative op (batched matmul): the vec
    tree-fold must combine adjacent pairs, matching the seq fold order."""
    rng = np.random.default_rng(3)
    for n in (2, 3, 5, 8):  # even and odd lengths hit both fold branches
        mats = [rng.standard_normal((2, 2)).astype(np.float32) for _ in range(n)]
        want = np.eye(2, dtype=np.float32)
        for m in mats:
            want = want @ m
        got = alg.reduce(vec, torch.from_numpy(np.stack(mats)), init=torch.eye(2),
                         op=torch.matmul)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, err_msg=str(n))


def test_seq_on_executor_stays_sequenced(port_rt):
    """HPX seq.on(exec): still sequenced, just on that executor — bodies
    must observe in-order execution even when bound to a pool."""
    out = []
    pol = seq.on(port_rt.get_executor("default")).with_(chunk_size=5)
    alg.for_each(pol, range(100), out.append)
    assert out == list(range(100))
    # order-sensitive associative op: string concat must stay in order
    letters = [chr(ord("a") + i % 26) for i in range(60)]
    assert alg.reduce(pol, letters, init="") == "".join(letters)


def test_vec_scan_non_traceable_op_is_loud(port_rt):
    host_only = lambda a, b: a if float(a) > float(b) else b  # concretizes
    xs = _t([1.0, 2.0, 3.0], torch.float32)
    with pytest.raises(ValueError, match="vec policy"):
        alg.inclusive_scan(vec, xs, op=host_only)
    with pytest.raises(ValueError, match="vec policy"):
        alg.exclusive_scan(vec, xs, init=0.0, op=host_only)
    with pytest.raises(ValueError, match="vec policy"):
        alg.reduce(vec, xs, op=host_only)
    # shape-changing op: combines slices but not elementwise — also loud
    with pytest.raises(ValueError, match="elementwise"):
        alg.reduce(vec, _t([1.0, 2.0, 3.0, 4.0], torch.float32),
                   op=lambda a, b: torch.stack([a, b]))


# ----------------------------------------------------------- vec for_each
def test_for_each_vec_vectorizes_traceable_bodies(port_rt):
    # module contract: vectorizable bodies lower through torch.vmap (no
    # host loop)
    calls = []

    def body(x):
        calls.append(1)  # run exactly once, on the batch, not per element
        return x * 2.0

    assert alg.for_each(vec, torch.arange(64.0), body) is None
    assert len(calls) == 1, "body was vectorized, not looped per element"


def test_for_each_vec_non_traceable_raises(port_rt):
    out = []
    with pytest.raises(ValueError, match="seq/par"):
        alg.for_each(vec, _t([1, 2, 3]), lambda x: out.append(int(x)))
    assert out == []  # nothing silently executed sequentially


# ------------------------------------------- HPX staples: fill/min/max
@pytest.mark.parametrize("name,mk", POLICIES)
@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(-50, 50), min_size=1, max_size=60))
def test_staples_agree_with_seq_oracle(port_rt, name, mk, xs):
    pol = mk()
    d = _data(name, xs)
    assert _val(alg.min_element(pol, d)) == float(min(xs))
    assert _val(alg.max_element(pol, d)) == float(max(xs))
    filled = alg.fill(pol, list(xs) if name != "vec" else _t(xs), 3)
    assert _val(filled) == [3.0] * len(xs)


def test_fill_mutates_host_sequences_in_place(port_rt):
    xs = list(range(10))
    out = alg.fill(par, xs, -1)
    assert out is xs and xs == [-1] * 10
    # vec: a new filled tensor, dtype and device preserved, input untouched
    arr = torch.arange(10)
    out = alg.fill(vec, arr, 4)
    assert out.dtype == arr.dtype and out.tolist() == [4] * 10
    assert arr.tolist() == list(range(10))


def test_extrema_of_empty_range_raise(port_rt):
    for pol in (seq, par, vec):
        with pytest.raises(ValueError, match="empty"):
            alg.min_element(pol, [])
        with pytest.raises(ValueError, match="empty"):
            alg.max_element(pol, [])


def test_staples_two_way_futures(port_rt):
    xs = [5, 1, 9, 3]
    f_min = alg.min_element(par_task, xs)
    f_fill = alg.fill(par_task, list(xs), 0)
    assert isinstance(f_min, Future) and isinstance(f_fill, Future)
    assert f_min.get(timeout=60) == 1
    assert f_fill.get(timeout=60) == [0] * 4


# --------------------------------------------------------- vec's device
def test_vec_on_non_tensor_data_goes_to_cuda(port_rt):
    """Data that is not a tensor becomes one on ``cuda``; without CUDA that
    raises — never a quiet run on the CPU."""
    if torch.cuda.is_available():
        assert alg.reduce(vec, [1, 2, 3]).device.type == "cuda"
        return
    for call in (lambda: alg.reduce(vec, [1, 2, 3]),
                 lambda: alg.transform(vec, np.arange(4), lambda x: x),
                 lambda: alg.sort(vec, (3, 1, 2))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_vec_results_stay_on_the_tensors_device_and_copies_are_new(port_rt):
    x = torch.arange(12, dtype=torch.float32)
    c = alg.copy(vec, x)
    assert c.device == x.device and c.data_ptr() != x.data_ptr() and torch.equal(c, x)
    c[0] = -1.0
    assert x[0] == 0.0
    for out in (alg.transform(vec, x, lambda v: v + 1), alg.inclusive_scan(vec, x),
                alg.sort(vec, x), alg.fill(vec, x, 2.0)):
        assert isinstance(out, torch.Tensor) and out.device == x.device


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 16, 33, 100])
def test_associative_scan_matches_sequential_fold(port_rt, n):
    """The odd-even recursion against the seq fold, on a non-commutative
    op (batched 2×2 matmul) at lengths that hit every parity of the
    recursion, and on integer maximum, exactly."""
    rng = np.random.default_rng(n)
    mats = torch.from_numpy(rng.standard_normal((n, 2, 2)).astype(np.float64))
    want = torch.stack(alg.inclusive_scan(seq, list(mats), op=torch.matmul))
    got = alg.inclusive_scan(vec, mats, op=torch.matmul)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    ints_ = torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, size=n))
    want_max = torch.stack(alg.inclusive_scan(seq, list(ints_), op=torch.maximum))
    assert torch.equal(alg.inclusive_scan(vec, ints_, op=torch.maximum), want_max)
    want_exc = torch.stack(alg.exclusive_scan(seq, list(ints_), init=torch.tensor(-5),
                                              op=torch.maximum))
    assert torch.equal(alg.exclusive_scan(vec, ints_, init=-5, op=torch.maximum), want_exc)


# ------------------------------------------------------- port vs reference
def _policies(ref: bool):
    """(name → policy) in one package; the bound pool and priority policies
    use the package's own runtime."""
    ex = rexec if ref else core.executor
    get = (rcore if ref else core).get_runtime
    return {
        "seq": lambda: ex.seq,
        "par": lambda: ex.par,
        "seq_task": lambda: ex.seq_task,
        "par_task": lambda: ex.par_task,
        "par_chunk7_prio": lambda: ex.par.with_(chunk_size=7, priority=2),
        "par_on_io": lambda: ex.par.on(get().get_executor("io", fallback="default")),
        "vec": lambda: ex.vec,
        "vec_task_on_io": lambda: ex.vec.on(
            get().get_executor("io", fallback="default")).with_(task=True),
    }


POLICY_NAMES = list(_policies(False))


def _int_data(n=97, seed=0):
    return np.random.default_rng(seed).integers(-1000, 1000, size=n)


def _float_data(n=97, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=n).astype(np.float32)


def _as_input(arr, ref: bool, pol_name: str):
    """Host policies get a python list (the same list in both packages);
    vec gets the package's array type."""
    if not pol_name.startswith("vec"):
        return arr.tolist()
    if ref:
        import jax.numpy as jnp

        return jnp.asarray(arr)
    return torch.from_numpy(arr.copy())


ALGOS = {
    "for_each": lambda a, p, d: a.for_each(p, d, lambda x: x * 2),
    "transform": lambda a, p, d: a.transform(p, d, lambda x: 3 * x + 1),
    "reduce": lambda a, p, d: a.reduce(p, d, init=5),
    "transform_reduce": lambda a, p, d: a.transform_reduce(p, d, lambda x: x * x),
    "inclusive_scan": lambda a, p, d: a.inclusive_scan(p, d),
    "exclusive_scan": lambda a, p, d: a.exclusive_scan(p, d, init=7),
    "sort": lambda a, p, d: a.sort(p, d),
    "count_if": lambda a, p, d: a.count_if(p, d, lambda x: x > 0),
    "all_of": lambda a, p, d: a.all_of(p, d, lambda x: x > -2000),
    "any_of": lambda a, p, d: a.any_of(p, d, lambda x: x > 990),
    "fill": lambda a, p, d: a.fill(p, d, 3),
    "min_element": lambda a, p, d: a.min_element(p, d),
    "max_element": lambda a, p, d: a.max_element(p, d),
    "copy": lambda a, p, d: a.copy(p, d),
}
# results that add values up: fp32 sums agree to a tolerance, not exactly
SUMS = {"reduce", "transform_reduce", "inclusive_scan", "exclusive_scan"}


def _np(x):
    if isinstance(x, (Future, rcore.Future)):
        x = x.get(timeout=120)
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("pol_name", POLICY_NAMES)
@pytest.mark.parametrize("algo", list(ALGOS))
def test_algorithm_matches_reference(rt, port_rt, algo, pol_name):
    """Each algorithm under each policy, the port against the reference on
    the same numpy-seeded data: int64 exact, fp32 within 1e-6 of the sum
    of the magnitudes added."""
    call = ALGOS[algo]
    for arr in (_int_data(), _float_data()):
        want = _np(call(ralg, _policies(True)[pol_name](), _as_input(arr, True, pol_name)))
        got = _np(call(alg, _policies(False)[pol_name](), _as_input(arr, False, pol_name)))
        if want is None or isinstance(want, bool) or isinstance(got, bool):
            assert got == want
            continue
        want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
        assert got.shape == want.shape
        if arr.dtype == np.float32 and algo in SUMS:
            scale = np.abs(arr).astype(np.float64).sum() * (3 if algo == "transform_reduce" else 1) + 7
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
        else:
            np.testing.assert_array_equal(got, want)


REF_OPS = {"max": ("maximum",), "min": ("minimum",), "mul": ("multiply",)}


@pytest.mark.parametrize("oname", list(REF_OPS))
@pytest.mark.parametrize("algo", ["reduce", "inclusive_scan", "exclusive_scan"])
def test_generic_op_matches_reference(rt, port_rt, algo, oname):
    """vec's tree reduction and associative scan under a non-add op, the
    port against the reference's ``jax.lax.associative_scan``: integer
    min / max exact, fp32 products within 1e-6 relative."""
    import jax.numpy as jnp

    rops = {"max": jnp.maximum, "min": jnp.minimum, "mul": jnp.multiply}
    tops = {"max": torch.maximum, "min": torch.minimum, "mul": torch.mul}
    rng = np.random.default_rng(11)
    arr = (rng.uniform(0.9, 1.1, size=61).astype(np.float32) if oname == "mul"
           else rng.integers(-10 ** 6, 10 ** 6, size=61))
    kw_r = {} if algo == "inclusive_scan" else {"init": 1}
    want = np.asarray(getattr(ralg, algo)(rexec.vec, jnp.asarray(arr), op=rops[oname], **kw_r))
    got = getattr(alg, algo)(vec, torch.from_numpy(arr.copy()), op=tops[oname], **kw_r).numpy()
    assert got.shape == want.shape
    if oname == "mul":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


NARROW = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "int32": torch.int32, "bool": torch.bool}
DTYPE_ALGOS = {
    "reduce": lambda a, p, d, i: a.reduce(p, d, init=i),
    "transform_reduce": lambda a, p, d, i: a.transform_reduce(p, d, lambda x: x * 2, init=i),
    "inclusive_scan": lambda a, p, d, i: a.inclusive_scan(p, d),
    "exclusive_scan": lambda a, p, d, i: a.exclusive_scan(p, d, init=i),
}


@pytest.mark.parametrize("init", [3, 0.5], ids=["int_init", "float_init"])
@pytest.mark.parametrize("dname", list(NARROW))
@pytest.mark.parametrize("algo", list(DTYPE_ALGOS))
def test_vec_sum_dtype_matches_reference(rt, port_rt, algo, dname, init):
    """Under ``vec`` the sums and scans give the reference's dtype for
    bf16, fp16, int32 and bool inputs, with an integer and a float init
    (a Python number stays weak beside the total, as in jnp; the
    exclusive scan's init promotes strongly, as ``jnp.result_type`` does;
    bool and int32 sum to int32, not torch's int64), then the same values:
    small integers, exact in every one of these dtypes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    arr = rng.integers(0, 2 if dname == "bool" else 4, size=16)
    call = DTYPE_ALGOS[algo]
    want = jnp.asarray(call(ralg, rexec.vec, jnp.asarray(arr).astype(dname), init))
    got = torch.as_tensor(call(alg, vec, torch.from_numpy(arr).to(NARROW[dname]), init))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (algo, dname, init)
    np.testing.assert_array_equal(got.to(torch.float64).numpy(),
                                  np.asarray(want, np.float64))
