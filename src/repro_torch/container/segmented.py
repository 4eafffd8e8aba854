"""Segmented parallel algorithms over :class:`PartitionedVector` — the
work-to-data lowering of ``repro_torch.core.algorithms`` (HPX's segmented
algorithm layer on ``partitioned_vector``), ported from the reference's
``container/segmented.py``.

Every public function here has the same shape as its ``core.algorithms``
counterpart, which dispatches to it whenever the data argument is a
partitioned vector.  The lowering is uniform:

1. **ship the body, not the bytes** — one object-targeted parcel per
   segment carries the (pickled-by-reference) body/op to the segment's
   owning locality, where it runs on that locality's own executor pools
   against the segment where it lives (its device memory);
2. **combine on the caller through dataflow** — per-segment partials come
   home as small host values (numpy scalars, or numpy arrays for
   array-valued elements) and a ``dataflow`` continuation folds them
   exactly as the reference does; under a ``task`` policy the un-joined
   Future is returned (two-way).

Segment bodies run as tensor code over the whole segment, on its device:
a body (``fn``, ``pred``) through ``torch.vmap``, ``operator.add`` as one
``sum`` / ``cumsum``, any other ``op`` as a log-depth tree of batched
calls (the port's ``vec`` lowerings) — never a Python loop over elements,
which on a CUDA segment would launch a kernel per element.  A body or op
that cannot vectorize raises, naming the cause.  ``op`` also folds the
partials on the caller, as in the reference, so it must accept host
values too (``operator.add``, ``operator.mul``, …).

Dtypes follow numpy's rules, not ``vec``'s: the reference's segments are
numpy arrays, so its sums widen as ``ndarray.sum`` / ``np.cumsum`` do, a
scan's carry promotes as ``np.asarray(off) + segment`` does (an int64
segment scanned with ``init=0.5`` gives float64), and the result dtypes of
the offset fix-up are asked of numpy on one-element probes.  A body's own
arithmetic is torch's (``x * 0.5`` on int64 gives float32 here, float64 in
the reference).

Result placement follows HPX: ``transform`` and the scans produce a *new*
partitioned vector with the same geometry, each result segment registered
at the source segment's owner on its device — results stay distributed,
nothing gathers.

Correctness contracts per distribution:

- order-free algorithms (``reduce``/``transform_reduce`` with their C++
  GENERALIZED_SUM associativity+commutativity-up-to-grouping license,
  ``count_if``, ``all_of``/``any_of``, ``min/max_element``, ``fill``,
  ``for_each``, elementwise ``transform``) are segment-decomposable under
  every distribution;
- the **scans** are order-dependent: on contiguous layouts (block /
  explicit) they run the true two-pass distributed scan — local inclusive
  scan per segment, an exclusive carry combine of segment totals on the
  caller, then a parallel offset-fixup parcel per segment.  On cyclic
  layouts segments interleave in global order, so scans fall back to
  gather → scan on the caller → scatter, as the reference does (correct,
  and the one path that is not work-to-data);
- ``sort`` distributes the per-segment sorts, then merges the sorted runs
  on the caller and scatters the result back in place.
"""

from __future__ import annotations

import builtins
import heapq
import operator
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.container.partitioned_vector import (
    PartitionedVector,
    _check_shippable,
    _publish_descriptor,
    _seg_read,
    _TIMEOUT,
    derived_name,
    host_tensor,
    np_dtype,
    torch_dtype,
)
from repro_torch.core import agas as _agas
from repro_torch.core import algorithms as _alg
from repro_torch.core import executor as _executor
from repro_torch.core import parcel as _parcel
from repro_torch.core.dataflow import dataflow
from repro_torch.core.executor import ExecutionPolicy
from repro_torch.core.future import Future


def _apply_on(key, fn: Callable[..., Any], *args: Any) -> Future:
    """Object-targeted parcel on an arbitrary segment key (used for result
    segments that are not part of a client handle yet)."""
    from repro_torch import net as _net

    return _net.apply_remote(fn, _agas.GID(*key), *args)


def _compute(fn: Callable[[], Any]) -> Any:
    """Run a segment body on the owner's compute pool (the parcel itself
    executes on the "io" pool — heavy work hops to "default")."""
    from repro_torch.obs import trace as _trace

    if _trace._enabled:
        # segment bodies are closures inside the _seg_* actions; the
        # enclosing function name is the algorithm ("for_each", "reduce")
        label = getattr(fn, "__qualname__", "segment").split(".")[0]
        with _trace.span(f"segment:{label.lstrip('_')}", "container"):
            return _executor.get_executor("default").sync_execute(fn)
    return _executor.get_executor("default").sync_execute(fn)


# ------------------------------------------------------ vectorized bodies
def _vectorized(name: str, what: Any, thunk: Callable[[], Any]) -> Any:
    """Run a segment body as tensor code; a body or op that cannot
    vectorize raises, naming the cause, instead of degrading to a loop
    over the segment's elements."""
    try:
        return thunk()
    except torch.cuda.OutOfMemoryError:
        raise
    except (RuntimeError, TypeError, ValueError, IndexError) as e:
        raise ValueError(
            f"segmented {name}: {getattr(what, '__qualname__', what)!r} cannot "
            f"run as tensor code over a segment — it must be vectorizable by "
            f"torch.vmap and combine/transform tensor elements (side effects, "
            f".item() and Python control flow on data cannot vectorize)") from e


def _map(name: str, fn: Callable[[Any], Any], obj: torch.Tensor) -> torch.Tensor:
    """``fn`` over every element of a (non-empty) segment."""
    return _vectorized(name, fn, lambda: torch.vmap(fn)(obj))


def _tree_reduce(name: str, op: Callable, arr: torch.Tensor) -> torch.Tensor:
    """``op`` folded over a segment in O(log n) batched calls (``vec``'s)."""
    return _vectorized(name, op, lambda: _alg._vec_tree_reduce(name, op, arr))


def _tree_scan(name: str, op: Callable, arr: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of a segment under ``op`` in O(log n) levels (``vec``'s)."""
    return _vectorized(name, op, lambda: _alg._assoc_scan(name, op, arr))


# -------------------------------------------------------- numpy's dtypes
def _probe(obj: torch.Tensor) -> np.ndarray:
    """One zero element of the segment's numpy dtype and element shape."""
    return np.zeros((1, *obj.shape[1:]), dtype=np_dtype(obj.dtype))


def _home(t: torch.Tensor) -> Any:
    """A segment's partial as the reference's host value: a numpy scalar,
    or a numpy array for array-valued elements."""
    arr = t.detach().cpu().numpy()
    return arr[()] if arr.ndim == 0 else arr


def _result(x: Any) -> Any:
    """A caller-side result in the port's idiom: an array (array-valued
    elements) becomes a CPU tensor, a scalar stays numpy's."""
    return torch.from_numpy(x) if isinstance(x, np.ndarray) and x.ndim else x


def _on(obj: torch.Tensor, value: Any, dt: np.dtype) -> torch.Tensor:
    """A host value as a tensor of numpy dtype ``dt`` on ``obj``'s device."""
    return torch.as_tensor(np.asarray(value, dtype=dt), device=obj.device)


# ---------------------------------------------------------- segment actions
@_parcel.action
def _seg_for_each(obj: torch.Tensor, fn: Callable[[Any], Any]) -> int:
    def body(x):
        fn(x)
        return x

    def run() -> int:
        _vectorized("for_each", fn, lambda: torch.vmap(body)(obj))
        return int(obj.shape[0])

    return _compute(run)


@_parcel.action
def _seg_transform(obj: torch.Tensor, fn: Callable[[Any], Any],
                   name: str) -> Tuple[List[int], str]:
    """Map a segment at its owner; register the result segment *here*, on
    the segment's device (the result vector inherits the source's
    placement)."""

    def run():
        out = _map("transform", fn, obj)
        gid = _agas.default().register(out, name=name)
        return [gid.locality, gid.seq], np_dtype(out.dtype).str

    return _compute(run)


@_parcel.action
def _seg_reduce(obj: torch.Tensor, op: Callable[[Any, Any], Any]) -> Any:
    def run():
        if obj.shape[0] == 0:
            return None
        if op is operator.add:  # ndarray.sum widens as numpy does
            dt = torch_dtype(_probe(obj).sum(axis=0).dtype)
            return _home(torch.sum(obj, dim=0, dtype=dt))
        return _home(_tree_reduce("reduce", op, obj))

    return _compute(run)


@_parcel.action
def _seg_transform_reduce(obj: torch.Tensor, fn: Callable[[Any], Any],
                          op: Callable[[Any, Any], Any]) -> Any:
    def run():
        if obj.shape[0] == 0:
            return None
        mapped = _map("transform_reduce", fn, obj)
        if op is operator.add and mapped.dtype != torch.bool:
            # the reference adds element by element, which keeps the dtype
            return _home(torch.sum(mapped, dim=0, dtype=mapped.dtype))
        return _home(_tree_reduce("transform_reduce", op, mapped))

    return _compute(run)


@_parcel.action
def _seg_count_if(obj: torch.Tensor, pred: Callable[[Any], Any]) -> int:
    return _compute(lambda: int((_map("count_if", pred, obj) != 0).sum()))


@_parcel.action
def _seg_fill(obj: torch.Tensor, value: Any) -> int:
    obj[...] = host_tensor(value).to(device=obj.device, dtype=obj.dtype)
    return int(obj.shape[0])


@_parcel.action
def _seg_extremum(obj: torch.Tensor, which: str) -> Any:
    if obj.shape[0] == 0:
        return None
    return _compute(lambda: _home(obj.min() if which == "min" else obj.max()))


@_parcel.action
def _seg_scan_local(obj: torch.Tensor, op: Callable[[Any, Any], Any],
                    name: str) -> Tuple[List[int], Any, str]:
    """Two-pass scan, pass 1: local inclusive scan registered at the owner;
    returns (result-segment key, segment total or None when empty, dtype)."""

    def run():
        if obj.shape[0] == 0:
            out = torch.empty_like(obj)
        elif op is operator.add:  # np.cumsum widens as numpy does
            dt = torch_dtype(np.cumsum(_probe(obj), axis=0).dtype)
            out = torch.cumsum(obj, dim=0, dtype=dt)
        else:
            out = _tree_scan("inclusive_scan", op, obj)
        gid = _agas.default().register(out, name=name)
        return ([gid.locality, gid.seq],
                (_home(out[-1]) if out.shape[0] else None),
                np_dtype(out.dtype).str)

    return _compute(run)


@_parcel.action
def _seg_apply_offset(obj: torch.Tensor, key: List[int],
                      op: Callable[[Any, Any], Any], off: Any,
                      exclusive: bool) -> Optional[str]:
    """Two-pass scan, pass 2: fold the carried-in offset into the locally
    scanned segment.  ``off is None`` ⇒ no offset (first inclusive chunk).
    The fixup rebinds (dtype may promote: a float carry over int data);
    returns the rebound dtype, or None when nothing was rebound.  Each
    result dtype is the one the reference's numpy expression gives, asked
    of numpy on a one-element probe of the segment."""

    def run() -> Optional[str]:
        if obj.shape[0] == 0 or (off is None and not exclusive):
            return None  # no rebind: pass-1 dtype stands
        probe = _probe(obj)
        if op is operator.add:
            d_sum = (np.asarray(off) + probe).dtype
            if exclusive:  # [off, off+x0, ..., off+x_{k-2}]
                dt = np.promote_types(np.asarray(off).dtype, d_sum)
                head = _on(obj, off, dt).expand(obj.shape[1:])[None]
                vals = torch.cat([head, (_on(obj, off, d_sum)
                                         + obj[:-1].to(torch_dtype(d_sum))).to(torch_dtype(dt))])
            else:
                vals = _on(obj, off, d_sum) + obj.to(torch_dtype(d_sum))
        else:
            d_op = np.asarray(op(off, probe[0])).dtype

            def fold(x: torch.Tensor) -> torch.Tensor:
                x = x.to(torch_dtype(d_op))
                return _alg._combiner("scan", op)(_on(obj, off, d_op).expand(x.shape), x)

            if exclusive:  # [off, off⊕x0, ..., off⊕x_{k-2}]
                dt = (np.asarray([off]).dtype if obj.shape[0] == 1
                      else np.asarray([off, op(off, probe[0])]).dtype)
                head = _on(obj, off, dt).expand(obj.shape[1:])[None]
                vals = torch.cat([head, _vectorized("exclusive_scan", op,
                                                    lambda: fold(obj[:-1]))
                                  .to(torch_dtype(dt))])
            else:
                vals = _vectorized("inclusive_scan", op, lambda: fold(obj))
        _agas.default().rebind(_agas.GID(*key), vals)
        return np_dtype(vals.dtype).str

    return _compute(run)


@_parcel.action
def _seg_adopt_values(obj: torch.Tensor, name: str,
                      values: Any) -> Tuple[List[int], str]:
    """Register ``values`` at this (the source segment's) locality, on the
    segment's device — the scatter half of the cyclic-scan fallback."""
    out = host_tensor(values).to(obj.device)
    gid = _agas.default().register(out, name=name)
    return [gid.locality, gid.seq], np_dtype(out.dtype).str


@_parcel.action
def _seg_sort_inplace(obj: torch.Tensor) -> int:
    _compute(lambda: obj.copy_(torch.sort(obj, dim=0).values))
    return int(obj.shape[0])


# ------------------------------------------------------------------ plumbing
def _deliver(policy: ExecutionPolicy, fut: Future) -> Any:
    """Honor two-way policies: ``task`` returns the Future, else join."""
    return fut if policy.task else fut.get(timeout=_TIMEOUT)


def _fanout(pv: PartitionedVector, fn: Callable[..., Any], *args: Any,
            seg_args: Optional[Callable[[int], Tuple[Any, ...]]] = None,
            only_nonempty: bool = True) -> Tuple[List[int], List[Future]]:
    for a in args:
        _check_shippable(a)
    segs = [j for j in range(pv.nsegments)
            if pv.dist.sizes[j] or not only_nonempty]
    return segs, [pv._apply(fn, j, *args, *(seg_args(j) if seg_args else ()))
                  for j in segs]


def _derived(pv: PartitionedVector, keyed: List[Tuple[List[int], str]],
             segs: List[int], name: str) -> PartitionedVector:
    """Assemble the client handle for a result vector whose segments were
    registered owner-side.  Empty source segments produced no remote call,
    so their zero-length result segments are created at the source's
    *initial* owner, and the result's placement mirrors the source's."""
    from repro_torch import net as _net
    from repro_torch.container.partitioned_vector import _create_segment

    keys: List[Optional[Tuple[int, int]]] = [None] * pv.nsegments
    dtypes = []
    for j, (key, dt) in zip(segs, keyed):
        keys[j] = tuple(key)
        dtypes.append(np.dtype(dt))
    dt = np.result_type(*dtypes).str if dtypes else pv.dtype_str
    empty = [j for j in range(pv.nsegments) if keys[j] is None]
    futs = [_net.run_on(pv.dist.owners[j], _create_segment,
                        f"{name}/seg{j}", 0, dt, pv.element_shape, pv.device)
            for j in empty]
    for j, f in zip(empty, futs):
        keys[j] = tuple(f.get(timeout=_TIMEOUT))
    out = PartitionedVector(name, pv.dist, dt, pv.element_shape, keys, pv.device)
    _publish_descriptor(name, pv.dist, dt, out.element_shape, out.segment_keys,
                        pv.device)
    return out


# ------------------------------------------------------------- order-free ops
def for_each(policy: ExecutionPolicy, pv: PartitionedVector,
             fn: Callable[[Any], Any]) -> Any:
    _segs, futs = _fanout(pv, _seg_for_each, fn)
    return _deliver(policy, dataflow(lambda *parts: None, *futs))


def transform(policy: ExecutionPolicy, pv: PartitionedVector,
              fn: Callable[[Any], Any]) -> Any:
    """→ new PartitionedVector, same geometry, segments at the same owners
    as the source (zero element bytes on the wire)."""
    name = derived_name(pv.name)
    segs, futs = _fanout(pv, _seg_transform, fn,
                         seg_args=lambda j: (f"{name}/seg{j}",))
    return _deliver(policy, dataflow(
        lambda *keyed: _derived(pv, list(keyed), segs, name), *futs))


def _fold_parts(init: Any, parts, op: Callable[[Any, Any], Any]) -> Any:
    acc = init
    for p in parts:
        if p is None:  # empty segment
            continue
        acc = op(acc, p)
    return _result(acc)


def reduce(policy: ExecutionPolicy, pv: PartitionedVector, init: Any = 0,
           op: Callable[[Any, Any], Any] = operator.add) -> Any:
    _segs, futs = _fanout(pv, _seg_reduce, op)
    return _deliver(policy, dataflow(
        lambda *parts: _fold_parts(init, parts, op), *futs))


def transform_reduce(policy: ExecutionPolicy, pv: PartitionedVector,
                     fn: Callable[[Any], Any], init: Any = 0,
                     op: Callable[[Any, Any], Any] = operator.add) -> Any:
    _segs, futs = _fanout(pv, _seg_transform_reduce, fn, op)
    return _deliver(policy, dataflow(
        lambda *parts: _fold_parts(init, parts, op), *futs))


def count_if(policy: ExecutionPolicy, pv: PartitionedVector,
             pred: Callable[[Any], Any]) -> Any:
    _segs, futs = _fanout(pv, _seg_count_if, pred)
    return _deliver(policy, dataflow(lambda *parts: int(sum(parts)), *futs))


def fill(policy: ExecutionPolicy, pv: PartitionedVector, value: Any) -> Any:
    _segs, futs = _fanout(pv, _seg_fill, value)
    return _deliver(policy, dataflow(lambda *parts: pv, *futs))


def _extremum(policy: ExecutionPolicy, pv: PartitionedVector,
              which: str) -> Any:
    if len(pv) == 0:
        raise ValueError(f"{which}_element of an empty partitioned vector")
    _segs, futs = _fanout(pv, _seg_extremum, which)
    pick = builtins.min if which == "min" else builtins.max

    def combine(*parts):
        vals = [p for p in parts if p is not None]
        return pick(vals)

    return _deliver(policy, dataflow(combine, *futs))


def min_element(policy: ExecutionPolicy, pv: PartitionedVector) -> Any:
    return _extremum(policy, pv, "min")


def max_element(policy: ExecutionPolicy, pv: PartitionedVector) -> Any:
    return _extremum(policy, pv, "max")


# ------------------------------------------------------------------- scans
def _carries(totals: List[Any], op: Callable[[Any, Any], Any],
             exclusive: bool, init: Any) -> List[Any]:
    """Exclusive carry combine of segment totals (the caller-side middle
    pass).  Inclusive: chunk 0 gets no offset (None); exclusive: chunk 0
    is seeded with ``init``."""
    offs: List[Any] = [init if exclusive else None] * len(totals)
    carry: Any = init if exclusive else None
    for j in range(len(totals) - 1):
        t = totals[j]
        if t is not None:
            carry = t if carry is None else op(carry, t)
        offs[j + 1] = carry
    return offs


def _scan_contiguous(policy: ExecutionPolicy, pv: PartitionedVector,
                     op: Callable[[Any, Any], Any], exclusive: bool,
                     init: Any) -> Any:
    name = derived_name(pv.name)
    segs, futs = _fanout(pv, _seg_scan_local, op,
                         seg_args=lambda j: (f"{name}/seg{j}",))

    def fixup(*keyed) -> PartitionedVector:
        keys: dict = {}
        totals: List[Any] = [None] * pv.nsegments
        dts: dict = {}
        for j, (key, total, dt) in zip(segs, keyed):
            keys[j], totals[j], dts[j] = key, total, dt
        offs = _carries(totals, op, exclusive, init)
        fixed = [j for j in range(pv.nsegments) if j in keys]
        fix = [_apply_on(keys[j], _seg_apply_offset, list(keys[j]), op,
                         offs[j], exclusive) for j in fixed]
        for j, f in zip(fixed, fix):
            rebound_dt = f.get(timeout=_TIMEOUT)
            if rebound_dt is not None:  # the fixup may promote the dtype
                dts[j] = rebound_dt
        keyed_dt = [(keys[j], dts[j]) for j in fixed]
        return _derived(pv, keyed_dt, segs, name)

    return _deliver(policy, dataflow(fixup, *futs))


def _scan_gather(policy: ExecutionPolicy, pv: PartitionedVector,
                 op: Callable[[Any, Any], Any], exclusive: bool,
                 init: Any) -> Any:
    """Cyclic layouts interleave global order across segments, so the
    two-pass decomposition does not apply: gather, scan at the caller over
    the host values (the reference's loop, so its dtypes), scatter the
    result back to the source owners (O(n) wire bytes, still a
    distributed *result*)."""
    name = derived_name(pv.name)

    def run() -> PartitionedVector:
        data = pv.to_array().numpy()
        out: List[Any] = []
        if exclusive:
            acc = init
            for v in data:
                out.append(acc)
                acc = op(acc, v)
        else:
            acc = None
            for v in data:
                acc = v if acc is None else op(acc, v)
                out.append(acc)
        arr = (np.asarray(out) if out
               else np.empty((0, *pv.element_shape), dtype=np_dtype(pv.dtype)))
        segs = list(range(pv.nsegments))
        futs = [pv._apply(_seg_adopt_values, j, f"{name}/seg{j}",
                          arr[pv.dist.global_indices(j)]) for j in segs]
        keyed = [f.get(timeout=_TIMEOUT) for f in futs]
        return _derived(pv, keyed, segs, name)

    if policy.task:
        return _executor.get_executor("default").async_execute(run)
    return run()


def inclusive_scan(policy: ExecutionPolicy, pv: PartitionedVector,
                   op: Callable[[Any, Any], Any] = operator.add) -> Any:
    if pv.dist.contiguous:
        return _scan_contiguous(policy, pv, op, exclusive=False, init=None)
    return _scan_gather(policy, pv, op, exclusive=False, init=None)


def exclusive_scan(policy: ExecutionPolicy, pv: PartitionedVector,
                   init: Any = 0,
                   op: Callable[[Any, Any], Any] = operator.add) -> Any:
    if pv.dist.contiguous:
        return _scan_contiguous(policy, pv, op, exclusive=True, init=init)
    return _scan_gather(policy, pv, op, exclusive=True, init=init)


# -------------------------------------------------------------------- sort
def sort(policy: ExecutionPolicy, pv: PartitionedVector) -> Any:
    """In-place: distributed per-segment sorts, k-way merge on the caller,
    scatter back in global order.  Returns ``pv``."""
    if pv.element_shape != ():
        raise ValueError("sort needs scalar elements (no total order on "
                         "array-valued elements)")

    def run() -> PartitionedVector:
        segs, futs = _fanout(pv, _seg_sort_inplace)
        for f in futs:
            f.get(timeout=_TIMEOUT)
        reads = [pv._apply(_seg_read, j) for j in segs]  # issue all, then join
        runs = [host_tensor(f.get(timeout=_TIMEOUT)) for f in reads]
        merged = torch.tensor(list(heapq.merge(*[r.tolist() for r in runs])),
                              dtype=pv.dtype)
        if len(pv):
            pv.set_slice(0, len(pv), merged)
        return pv

    if policy.task:
        return _executor.get_executor("default").async_execute(run)
    return run()
