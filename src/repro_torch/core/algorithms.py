"""C++17-style parallel algorithms over the executor hierarchy (HPX P6) —
ported from the reference's ``core/algorithms.py``.

The paper: C++17 "support for parallel algorithms was added, which
coincidentally covers the need for data parallel algorithms"; HPX provides
the reference implementation.  The PyTorch analogue:

    for_each, transform, reduce, transform_reduce, inclusive_scan,
    exclusive_scan, sort, count_if, all_of/any_of, copy, fill,
    min_element, max_element

Each takes an :class:`~repro_torch.core.executor.ExecutionPolicy`; the
policy is a pure rewrite object and every host lowering dispatches through
the bound executor's ``bulk_async_execute``:

- ``seq``      — one chunk on a :class:`SequencedExecutor` (the oracle);
- ``par``      — chunks on a :class:`ThreadPoolExecutor` (named pool of the
  resource partitioner; ``par.on(rt.get_executor("io"))`` redirects);
- ``par_task`` — same lowering, *two-way*: returns a ``Future`` instead of
  joining (HPX ``par(task)``);
- ``vec``      — vectorized over the leading dimension of a tensor, on the
  tensor's own device: bodies through ``torch.vmap``, reductions and scans
  as O(log n) batched tensor ops.  Data that is not a tensor becomes one on
  :func:`~repro_torch._device.resolve_device` — ``cuda``, which raises
  without CUDA — as the reference's ``jnp.asarray`` lands on the default
  accelerator.  Results stay on the device.  Bodies that cannot vectorize
  (``.item()``, Python branches on data, side effects on the host) raise
  instead of silently degrading to a host loop.

Host policies index ``data`` element by element, so they belong to host
sequences; over a CUDA tensor they would copy one element at a time.

Under vec, binary ``op`` arguments combine *batched slices elementwise*
(``operator.add``, ``operator.mul``, ``torch.minimum``, ``torch.matmul`` of
batched matrices, …) — the combinator contract of the reference's
``jax.lax.associative_scan``.  Each ``op`` call is vectorized with
``torch.vmap``, so a host-only op raises loudly whatever the slice length.
"""

from __future__ import annotations

import builtins
import heapq
import operator
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.core.executor import (
    ExecutionPolicy,
    Executor,
    PriorityExecutor,
    SequencedExecutor,
    ThreadPoolExecutor,
)
from repro_torch.core.future import Future, Promise, make_ready_future, when_all

_SEQ_EXEC = SequencedExecutor()


# ------------------------------------------------------------------ dispatch
def _as_policy(policy: Any) -> ExecutionPolicy:
    if isinstance(policy, ExecutionPolicy):
        return policy
    raise TypeError(
        f"expected an ExecutionPolicy (seq/par/par_task/vec or "
        f"policy.on(executor)), got {policy!r}")


def _is_vec(policy: ExecutionPolicy) -> bool:
    return policy.flavor == "vec"


def _host_executor(policy: ExecutionPolicy) -> Executor:
    ex = policy.executor
    if ex is None:
        ex = _SEQ_EXEC if policy.flavor == "seq" else ThreadPoolExecutor()
    if policy.priority is not None:
        ex = PriorityExecutor(ex, policy.priority)
    return ex


def _chunks(n: int, chunk: int) -> List[tuple]:
    return [(i, min(i + chunk, n)) for i in range(0, n, chunk)]


def _chunk_size(policy: ExecutionPolicy, n: int, ex: Executor) -> int:
    if policy.flavor == "seq":
        # sequenced stays sequenced even when bound to a pool executor
        # (HPX seq.on(exec): one in-order task on that executor)
        return max(1, n)
    if policy.chunk_size:
        return policy.chunk_size
    p = max(1, ex.parallelism)
    return max(1, n) if p <= 1 else max(1, n // (4 * p))


def _bulk(policy: ExecutionPolicy, n: int,
          chunk_fn: Callable[[int, int], Any]) -> List[Future]:
    """Lower a loop of ``n`` iterations to per-chunk executor tasks."""
    ex = _host_executor(policy)
    return ex.bulk_async_execute(chunk_fn, _chunks(n, _chunk_size(policy, n, ex)))


def _join(policy: ExecutionPolicy, futs: List[Future],
          combine: Callable[[List[Any]], Any]):
    """Combine chunk results; under a ``task`` policy the combination is a
    continuation — posted on the *policy's own executor*, so a workload
    bound to a named pool never leaks its combine onto another pool."""
    if policy.task:
        return _then_on(policy, when_all(futs),
                        lambda ready: combine([f.get() for f in ready]))
    return combine([f.get() for f in futs])


def _offload(policy: ExecutionPolicy, thunk: Callable[[], Any]):
    """Produce a vec value, honoring the policy bindings: a bound executor
    runs the whole vectorized dispatch as one task on that pool
    (``vec.on(rt.get_executor("io"))`` — never silently inline), and
    ``task`` policies get a Future."""
    ex = policy.executor
    if ex is not None:
        if policy.priority is not None:
            ex = PriorityExecutor(ex, policy.priority)
        fut = ex.async_execute(thunk)
        return fut if policy.task else fut.get()
    return make_ready_future(thunk()) if policy.task else thunk()


class _LoweringError(ValueError):
    """A vec lowering violated its contract (already actionable)."""


def _traced(name: str, what: str, apply: Callable[[], Any]) -> Any:
    """Run a vectorized lowering; translate ``torch.vmap``'s refusals (and
    host-only bodies failing on batched tensors) into a loud, actionable
    error instead of silently degrading to a host loop."""
    try:
        return apply()
    except (_LoweringError, torch.cuda.OutOfMemoryError):
        raise
    except (RuntimeError, TypeError, ValueError, IndexError) as e:
        raise ValueError(
            f"{name}: {what} is not usable under the vec policy — it must be "
            f"vectorizable by torch.vmap and combine/transform tensor "
            f"elements (side effects, .item() and Python control flow on "
            f"data cannot vectorize). Use the seq/par policies for host-only "
            f"bodies.") from e


def _tensor(data: Any) -> torch.Tensor:
    """vec's operand: a tensor stays where it is; anything else becomes a
    tensor on ``resolve_device()`` (``cuda``; raises without CUDA)."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.as_tensor(data, device=resolve_device())


# The reference's jnp runs without x64, so its default integer is int32:
# jnp.sum widens bool and the narrow integers to int32 (torch.sum: int64)
# and jnp.cumsum widens bool to int32 (torch.cumsum: every integer to
# int64).  Here an int64 result stands for the reference's int32 only
# where an input was int64.
_NARROW_INTS = (torch.bool, torch.int8, torch.int16, torch.int32)


def _sum_dtype(dt: torch.dtype) -> Optional[torch.dtype]:
    """The dtype ``jnp.sum`` gives an input of ``dt`` (None: keep ``dt``)."""
    return torch.int32 if dt in _NARROW_INTS else None


def _cumsum_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype ``jnp.cumsum`` gives an input of ``dt``."""
    return torch.int32 if dt == torch.bool else dt


def _strong(dt: torch.dtype) -> torch.dtype:
    """``jnp.asarray(init).dtype`` for an init torch types as ``dt``: jnp
    without x64 makes 64-bit inits 32-bit."""
    return {torch.int64: torch.int32, torch.float64: torch.float32,
            torch.complex128: torch.complex64}.get(dt, dt)


def _with_init(op: Callable, init: Any, total: torch.Tensor) -> Any:
    """The reference's ``op(init, total)``.  A Python number is weak in jnp
    (the total's dtype wins within its kind), as it is beside a 0-dim
    tensor in torch; torch ops take no Python numbers where jnp's do, so
    both sides go in at that dtype.  Any other init promotes strongly, as
    torch promotes two tensors."""
    if isinstance(init, (bool, int, float, complex)):
        dt = torch.result_type(total, init)
        if dt == torch.int64 and total.dtype != torch.int64:
            dt = torch.int32
        return op(torch.as_tensor(init, dtype=dt, device=total.device),
                  total.to(dt))
    return op(torch.as_tensor(init, device=total.device), total)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _vmap(name: str, what: str, fn: Callable, arr: torch.Tensor) -> torch.Tensor:
    """``torch.vmap(fn)`` over the leading dimension of ``arr``; an empty
    ``arr`` maps one zero element to learn the output's element shape and
    dtype (``torch.vmap`` takes no batch of size 0)."""
    if arr.shape[0] == 0:
        probe = arr.new_zeros((1,) + tuple(arr.shape[1:]))
        return _traced(name, what, lambda: torch.vmap(fn)(probe))[:0]
    return _traced(name, what, lambda: torch.vmap(fn)(arr))


# ---------------------------------------------------------------- for_each
def for_each(policy: ExecutionPolicy, data: Sequence[Any],
             fn: Callable[[Any], Any]) -> Any:
    """Apply ``fn`` to every element (result discarded).

    Under ``vec`` the body is vectorized with ``torch.vmap`` as a
    side-effect-free application — a body that cannot vectorize raises
    (module contract: no silent sequential fallback).  Host side effects
    belong under ``seq``/``par``."""
    policy = _as_policy(policy)
    if _is_vec(policy):
        def body(x):
            fn(x)
            return x

        def thunk() -> None:
            arr = _tensor(data)
            if arr.shape[0]:
                _traced("for_each", f"body {getattr(fn, '__name__', fn)!r}",
                        lambda: torch.vmap(body)(arr))
                _sync(arr)
            return None

        return _offload(policy, thunk)

    n = len(data)

    def _run(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            fn(data[i])

    return _join(policy, _bulk(policy, n, _run), lambda parts: None)


# ---------------------------------------------------------------- transform
def transform(policy: ExecutionPolicy, data: Any, fn: Callable[[Any], Any]) -> Any:
    policy = _as_policy(policy)
    if _is_vec(policy):
        return _offload(policy, lambda: _vmap("transform", "body", fn, _tensor(data)))

    n = len(data)

    def _run(lo: int, hi: int) -> List[Any]:
        return [fn(data[i]) for i in range(lo, hi)]

    return _join(policy, _bulk(policy, n, _run),
                 lambda parts: [x for p in parts for x in p])


# ------------------------------------------------------------------- reduce
def _combiner(name: str, op: Callable) -> Callable:
    """``op`` over two equal-length batches of elements, vectorized with
    ``torch.vmap``; an op that changes the shape is a contract violation."""
    vop = torch.vmap(op)

    def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = vop(a, b)
        if out.shape != a.shape:
            raise _LoweringError(
                f"{name}: op changed the element shape {tuple(a.shape)} -> "
                f"{tuple(out.shape)}; it must combine batched slices "
                f"elementwise")
        return out

    return combine


def _vec_tree_reduce(name: str, op: Callable, arr: torch.Tensor) -> torch.Tensor:
    """Pairwise associative fold, vectorized: O(log n) batched ``op`` calls.

    ``op`` must combine equal-length batched slices elementwise (the same
    contract as the scans' combinator)."""
    combine = _combiner(name, op)

    def _fold():
        a = arr
        while a.shape[0] > 1:
            half = a.shape[0] // 2
            # combine *adjacent* pairs — (x0⊕x1), (x2⊕x3), … — so operand
            # order is preserved for associative non-commutative ops
            combined = combine(a[0:2 * half:2], a[1:2 * half:2])
            a = (torch.cat([combined, a[2 * half:]], dim=0)
                 if a.shape[0] % 2 else combined)
        return a[0]

    return _traced(name, f"op {op!r}", _fold)


def reduce(
    policy: ExecutionPolicy,
    data: Any,
    init: Any = 0,
    op: Callable[[Any, Any], Any] = operator.add,
) -> Any:
    policy = _as_policy(policy)
    if _is_vec(policy):
        def thunk():
            arr = _tensor(data)
            if arr.shape[0] == 0:
                return init
            total = (torch.sum(arr, dim=0, dtype=_sum_dtype(arr.dtype))  # elements may be batched
                     if op is operator.add
                     else _vec_tree_reduce("reduce", op, arr))
            return _with_init(op, init, total)

        return _offload(policy, thunk)

    n = len(data)

    def _run(lo: int, hi: int) -> Any:
        acc = data[lo]
        for i in range(lo + 1, hi):
            acc = op(acc, data[i])
        return acc

    def _combine(parts: List[Any]) -> Any:
        acc = init
        for p in parts:  # op must be associative (C++ requirement)
            acc = op(acc, p)
        return acc

    return _join(policy, _bulk(policy, n, _run), _combine)


def transform_reduce(
    policy: ExecutionPolicy,
    data: Any,
    fn: Callable[[Any], Any],
    init: Any = 0,
    op: Callable[[Any, Any], Any] = operator.add,
) -> Any:
    policy = _as_policy(policy)
    if _is_vec(policy):
        def thunk():
            arr = _tensor(data)
            if arr.shape[0] == 0:
                return init
            mapped = _vmap("transform_reduce", "body", fn, arr)
            if mapped.dtype == torch.int64 and arr.dtype in _NARROW_INTS:
                # torch's default integer where the body's jnp gives int32
                mapped = mapped.to(torch.int32)
            total = (torch.sum(mapped, dim=0, dtype=_sum_dtype(mapped.dtype))
                     if op is operator.add
                     else _vec_tree_reduce("transform_reduce", op, mapped))
            return _with_init(op, init, total)

        return _offload(policy, thunk)

    n = len(data)

    def _run(lo: int, hi: int) -> Any:
        acc = fn(data[lo])
        for i in range(lo + 1, hi):
            acc = op(acc, fn(data[i]))
        return acc

    def _combine(parts: List[Any]) -> Any:
        acc = init
        for p in parts:
            acc = op(acc, p)
        return acc

    return _join(policy, _bulk(policy, n, _run), _combine)


# -------------------------------------------------------------------- scans
def _local_inclusive(data: Any, op: Callable, lo: int, hi: int) -> List[Any]:
    """In-order inclusive scan of one chunk (the two-pass scans' pass 1)."""
    out: List[Any] = []
    acc: Optional[Any] = None
    for i in range(lo, hi):
        acc = data[i] if acc is None else op(acc, data[i])
        out.append(acc)
    return out


_NO_SEED = object()


def _two_pass_scan(ex: Executor, bounds: List[tuple], data: Any, op: Callable,
                   exclusive: bool, init: Any = _NO_SEED) -> List[Any]:
    """Shared two-pass parallel scan: local inclusive scans per chunk, a
    sequential fold of chunk totals into per-chunk offsets (seeded with
    ``init`` for exclusive scans), then a bulk offset-apply pass."""
    locals_ = [f.get() for f in ex.bulk_async_execute(
        lambda lo, hi: _local_inclusive(data, op, lo, hi), bounds)]
    offsets: List[Any] = [init] * len(bounds)
    carry = init
    for c in range(len(bounds) - 1):
        carry = (locals_[c][-1] if carry is _NO_SEED
                 else op(carry, locals_[c][-1]))
        offsets[c + 1] = carry

    def _apply(c: int) -> List[Any]:
        off = offsets[c]
        if exclusive:  # chunk c emits [off, off⊕x0, ..., off⊕x_{k-2}]
            return [off] + [op(off, v) for v in locals_[c][:-1]]
        if off is _NO_SEED:
            return locals_[c]
        return [op(off, v) for v in locals_[c]]

    parts = [f.get() for f in ex.bulk_async_execute(_apply, range(len(bounds)))]
    return [x for p in parts for x in p]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, …] from ``len(even) ∈ {len(odd), len(odd) + 1}``."""
    k = odd.shape[0]
    pairs = torch.stack([even[:k], odd], dim=1).reshape((2 * k,) + tuple(odd.shape[1:]))
    return torch.cat([pairs, even[k:]], dim=0) if even.shape[0] > k else pairs


def _assoc_scan(name: str, op: Callable, arr: torch.Tensor) -> torch.Tensor:
    """Inclusive scan under an associative ``op`` in O(log n) levels of
    batched ``op`` calls — the odd-even recursion of
    ``jax.lax.associative_scan``, which PyTorch lacks: fold adjacent pairs,
    scan the half-length result (every odd position's prefix), then one
    more batched call gives the even positions.  Loud for ops that cannot
    vectorize or that change the shape — never a silent host loop."""
    combine = _combiner(name, op)

    def _scan(a: torch.Tensor) -> torch.Tensor:
        n = a.shape[0]
        if n < 2:
            return a
        odd = _scan(combine(a[0:n - 1:2], a[1::2]))  # prefixes ending at 1, 3, …
        # prefixes ending at 2, 4, …: the odd prefix before each, ⊕ x_2i
        even = combine(odd[:(n - 1) // 2], a[2::2])
        return _interleave(torch.cat([a[:1], even], dim=0), odd)

    return _traced(name, f"op {op!r}", lambda: _scan(arr))


def inclusive_scan(policy: ExecutionPolicy, data: Any,
                   op: Callable = operator.add) -> Any:
    policy = _as_policy(policy)
    if _is_vec(policy):
        def thunk():
            arr = _tensor(data)
            if arr.shape[0] == 0:
                return arr
            return (torch.cumsum(arr, dim=0, dtype=_cumsum_dtype(arr.dtype))
                    if op is operator.add
                    else _assoc_scan("inclusive_scan", op, arr))

        return _offload(policy, thunk)

    if policy.task:  # two-way: run the joining scan as one pool task
        eager = policy.with_(task=False)
        return _host_executor(policy).async_execute(
            lambda: inclusive_scan(eager, data, op))

    n = len(data)
    ex = _host_executor(policy)
    chunk = _chunk_size(policy, n, ex)
    if ex.parallelism <= 1 or chunk >= n:
        out: List[Any] = []
        acc: Optional[Any] = None
        for x in data:
            acc = x if acc is None else op(acc, x)
            out.append(acc)
        return out

    return _two_pass_scan(ex, _chunks(n, chunk), data, op, exclusive=False)


def exclusive_scan(policy: ExecutionPolicy, data: Any, init: Any = 0,
                   op: Callable = operator.add) -> Any:
    policy = _as_policy(policy)
    if _is_vec(policy):
        def thunk():
            arr = _tensor(data)
            if arr.shape[0] == 0:  # C++: empty exclusive scan writes nothing
                return arr
            # promote like the seq oracle would (a float init over int data
            # yields floats — never silently truncate init to the data
            # dtype), strongly as the reference's jnp.result_type does, and
            # broadcast init to the element shape
            init_t = torch.as_tensor(init, device=arr.device)
            dt = torch.promote_types(arr.dtype, _strong(init_t.dtype))
            arr2 = arr.to(dt)
            init_el = init_t.to(dt).broadcast_to(arr2.shape[1:])[None]
            if op is operator.add:
                scan = torch.cumsum(arr2, dim=0, dtype=_cumsum_dtype(dt))
                return torch.cat([init_el, init_el + scan[:-1]])
            # scan [init, x0, ..., x_{n-2}]: prefix folds seeded with init
            ext = torch.cat([init_el, arr2[:-1]])
            return _assoc_scan("exclusive_scan", op, ext)

        return _offload(policy, thunk)

    if policy.task:
        eager = policy.with_(task=False)
        return _host_executor(policy).async_execute(
            lambda: exclusive_scan(eager, data, init, op))

    n = len(data)
    ex = _host_executor(policy)
    chunk = _chunk_size(policy, n, ex)
    if ex.parallelism <= 1 or chunk >= n:
        out: List[Any] = []
        acc = init
        for x in data:
            out.append(acc)
            acc = op(acc, x)
        return out

    return _two_pass_scan(ex, _chunks(n, chunk), data, op,
                          exclusive=True, init=init)


# --------------------------------------------------------------------- sort
def sort(policy: ExecutionPolicy, data: Any) -> Any:
    """Parallel merge-ish sort: chunk-sort on pool tasks, k-way merge."""
    policy = _as_policy(policy)
    if _is_vec(policy):
        return _offload(policy, lambda: torch.sort(_tensor(data), dim=-1).values)

    n = len(data)

    def _run(lo: int, hi: int) -> List[Any]:
        return builtins.sorted(data[lo:hi])

    return _join(policy, _bulk(policy, n, _run),
                 lambda parts: list(heapq.merge(*parts)))


# --------------------------------------------------------------- predicates
def _count_body(pred: Callable[[Any], Any]) -> Callable[[Any], Any]:
    def body(x):
        hit = pred(x)
        return (hit if isinstance(hit, torch.Tensor)
                else torch.as_tensor(hit, device=x.device)).to(torch.int64)

    return body


def count_if(policy: ExecutionPolicy, data: Any,
             pred: Callable[[Any], Any]) -> Any:
    policy = _as_policy(policy)
    body = (  # one lowering: transform_reduce owns the vec dispatch
        _count_body(pred) if _is_vec(policy)
        else (lambda x: 1 if pred(x) else 0))
    res = transform_reduce(policy, data, body, init=0)
    return _then_on(policy, res, int) if policy.task else int(res)


def _then_on(policy: ExecutionPolicy, fut: Future,
             fn: Callable[[Any], Any]) -> Future:
    """Continuation on the *policy's* executor (``Future.then`` would land
    on the global default pool, leaking off the bound pool)."""
    ex = _host_executor(policy)
    promise: Promise = Promise()

    def _fire(ready: Future) -> None:
        def _run() -> None:
            try:
                promise.set_value(fn(ready.get()))
            except BaseException as e:  # noqa: BLE001
                promise.set_exception(e)

        ex.post(_run)

    fut._on_ready(_fire)
    return promise.future()


def _predicate_result(policy: ExecutionPolicy, counted: Any,
                      check: Callable[[int], bool]):
    if isinstance(counted, Future):
        return _then_on(policy, counted, check)
    return check(counted)


def all_of(policy: ExecutionPolicy, data: Any, pred: Callable[[Any], Any]) -> Any:
    n = len(data)
    return _predicate_result(policy, count_if(policy, data, pred),
                             lambda c: c == n)


def any_of(policy: ExecutionPolicy, data: Any, pred: Callable[[Any], Any]) -> Any:
    return _predicate_result(policy, count_if(policy, data, pred),
                             lambda c: c > 0)


# --------------------------------------------------------------------- fill
def fill(policy: ExecutionPolicy, data: Any, value: Any) -> Any:
    """Assign ``value`` to every element (C++ ``std::fill``).

    Host policies mutate ``data`` in place (it must be a mutable sequence)
    and return it; vec returns a new filled tensor of ``data``'s shape,
    dtype and device and leaves ``data`` as it was, as the reference does."""
    policy = _as_policy(policy)
    if _is_vec(policy):
        def thunk():
            arr = _tensor(data)
            return torch.full(arr.shape, value, dtype=arr.dtype, device=arr.device)

        return _offload(policy, thunk)

    n = len(data)

    def _run(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            data[i] = value

    return _join(policy, _bulk(policy, n, _run), lambda parts: data)


# ---------------------------------------------------------------- extrema
def _extremum(policy: ExecutionPolicy, data: Any, name: str,
              host_pick: Callable, vec_pick: Callable) -> Any:
    policy = _as_policy(policy)
    if len(data) == 0:  # C++ returns last; we are value-returning, so raise
        raise ValueError(f"{name} of an empty range")
    if _is_vec(policy):
        # scalars → the element; batched elements → elementwise extremum
        # (no total order on tensors)
        return _offload(policy, lambda: vec_pick(_tensor(data), dim=0))

    def _run(lo: int, hi: int) -> Any:
        return host_pick(data[i] for i in range(lo, hi))

    return _join(policy, _bulk(policy, len(data), _run), host_pick)


def min_element(policy: ExecutionPolicy, data: Any) -> Any:
    """Smallest element's value (C++ ``min_element``, dereferenced)."""
    return _extremum(policy, data, "min_element", builtins.min, torch.amin)


def max_element(policy: ExecutionPolicy, data: Any) -> Any:
    """Largest element's value (C++ ``max_element``, dereferenced)."""
    return _extremum(policy, data, "max_element", builtins.max, torch.amax)


# --------------------------------------------------------------------- copy
def copy(policy: ExecutionPolicy, data: Any) -> Any:
    """A copy of ``data``; under vec a new tensor on ``data``'s device."""
    policy = _as_policy(policy)
    if _is_vec(policy):
        return _offload(policy, lambda: _tensor(data).clone())
    n = len(data)

    def _run(lo: int, hi: int) -> List[Any]:
        return list(data[lo:hi])

    return _join(policy, _bulk(policy, n, _run),
                 lambda parts: [x for p in parts for x in p])
