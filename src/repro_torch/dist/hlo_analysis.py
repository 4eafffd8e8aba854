"""Static profiler of one step's dispatched torch ops — the port's
counterpart of the reference's ``dist/hlo_analysis.py``, which parses
post-SPMD HLO text.  The port has no HLO: it profiles the aten ops, the
``repro_torch::`` kernel ops and the c10d functional collectives that one
call of a step function dispatches on one rank (a ``TorchDispatchMode``,
:class:`OpProfiler`), usually under ``FakeTensorMode`` on a fake process
group (``launch/dryrun.py``).  From that trace it produces, per rank:

- a per-collective inventory (:class:`CollectiveSummary`): operand and
  result bytes, ring-model wire bytes, group size, the number of calls,
  and whether the group spans pods (:func:`_crosses_pod`);
- ``dot_flops``: matmul FLOPs (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
  plus each kernel op's own formula (``kernels/ops.py::FLOP_FORMULAS``),
  and ``flops``, every op ``FlopCounterMode`` has a formula for;
- ``memory_traffic``: an HBM traffic proxy, the result bytes of every op
  that materialises a tensor.  Views and aliases do not count; an
  in-place update counts its update (the values an ``index_put_`` or a
  ``copy_`` writes).

A Python loop runs each of its iterations, so a loop body is counted once
per iteration by execution; the reference applies while-loop trip counts
for the same.  DTensor ops are seen after DTensor has turned them into
local ops and collectives, so every figure is per rank, as the
reference's post-SPMD shapes are per device.

The trace (:attr:`OpProfiler.trace`) is a list of plain records, one per
distinct (op, arguments) with its count, that ``json`` can write;
:func:`analyze_trace` derives all three figures from it alone, so
``analysis/reanalyze.py`` refines a record without tracing again.

Wire-byte model (bidirectional ring), as in the reference:

    all-reduce          2 · B · (g−1)/g      (reduce-scatter + all-gather)
    all-gather          B_operand · (g−1)
    reduce-scatter      B_result  · (g−1)
    all-to-all          B · (g−1)/g
    collective-permute  B

with ``B`` the per-rank operand bytes and ``g`` the group size.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import POD_SIZE


@dataclass
class CollectiveOp:
    """One collective call site (its calls per step in ``trip_count``)."""

    kind: str
    name: str
    operand_bytes: int
    result_bytes: int
    group_size: int
    trip_count: int
    crosses_pod: bool

    @property
    def wire_bytes_per_device(self) -> int:
        """Ring-model wire bytes for ONE call (multiply by ``trip_count``
        for the per-step total)."""
        g = max(self.group_size, 1)
        if self.kind == "all-reduce":
            return 2 * self.operand_bytes * (g - 1) // g
        if self.kind == "all-gather":
            return self.operand_bytes * (g - 1)
        if self.kind == "reduce-scatter":
            return self.result_bytes * (g - 1)
        if self.kind == "all-to-all":
            return self.operand_bytes * (g - 1) // g
        return self.operand_bytes  # collective-permute

    @property
    def total_wire_bytes(self) -> int:
        return self.wire_bytes_per_device * self.trip_count


@dataclass
class CollectiveSummary:
    ops: List[CollectiveOp] = field(default_factory=list)

    def count(self) -> int:
        """Collective calls per step."""
        return sum(o.trip_count for o in self.ops)

    def total_wire(self, crosses_pod: Optional[bool] = None) -> int:
        return sum(o.total_wire_bytes for o in self.ops
                   if crosses_pod is None or o.crosses_pod == crosses_pod)

    def total_operand(self) -> int:
        return sum(o.operand_bytes * o.trip_count for o in self.ops)

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for o in self.ops:
            out[o.kind] = out.get(o.kind, 0) + o.total_wire_bytes
        return out


def _crosses_pod(groups: List[List[int]], n_devices: int,
                 pod_size: int = POD_SIZE) -> bool:
    """Whether any group spans more than one pod of ``pod_size`` ranks."""
    if n_devices <= pod_size:
        return False
    for g in groups:
        pods = {d // pod_size for d in g}
        if len(pods) > 1:
            return True
    return False


@contextlib.contextmanager
def hidden_shape_propagation() -> Iterator[None]:
    """DTensor derives each op's global output shape by running the op on
    global-shape fake tensors; every dispatch mode would see that run as
    if it were the rank's own (a profiler, ``MemTracker``,
    ``FlopCounterMode``).  For the block, that run happens with the modes
    set aside (``ShardingPropagator``'s tensor-meta propagation, wrapped),
    in a fake mode of its own."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    orig = getattr(ShardingPropagator, name)

    @functools.wraps(orig)
    def unseen(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)

    setattr(ShardingPropagator, name, unseen)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


# ------------------------------------------------------------------ the trace
# c10d functional collectives → the reference's HLO collective kinds
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
# the c10d ops behind ``torch.distributed``'s in-place calls (the
# pod-manual gradient reduction's ``dist.all_reduce``): operand = result
_C10D = {"allreduce_": "all-reduce", "allgather_": "all-gather",
         "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter", "alltoall_base_": "all-to-all",
         "broadcast_": "collective-permute"}
_DOTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
_NO_TRAFFIC = ("aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided", "aten::detach",
               "aten::lift_fresh", "aten::_local_scalar_dense", "aten::alias",
               "_c10d_functional::wait_tensor")
# in-place writers whose update is one argument: (op, index of the update)
_UPDATE_ARG = {"aten::index_put_": 2, "aten::copy_": 1, "aten::index_copy_": 3,
               "aten::index_add_": 3, "aten::scatter_": 3, "aten::scatter_add_": 3,
               "aten::masked_scatter_": 2}


def _nbytes(t: Any) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _out_bytes(out: Any) -> int:
    if isinstance(out, torch.Tensor):
        return _nbytes(out)
    if isinstance(out, (tuple, list)):
        return sum(_out_bytes(o) for o in out)
    return 0


def _arg(a: Any) -> Any:
    """A trace entry for one argument: a tensor as [shape, dtype], a
    scalar as itself, anything else by its type's name."""
    if isinstance(a, torch.Tensor):
        return [list(a.shape), str(a.dtype)[6:]]
    if isinstance(a, (bool, int, float, str)) or a is None:
        return a
    if isinstance(a, (list, tuple)):
        return [_arg(x) for x in a]
    return type(a).__name__


class OpProfiler(TorchDispatchMode):
    """Records every op one rank dispatches while the mode is on.

    ``trace`` holds one record per distinct op call: ``op`` (its
    ``namespace::name``), ``n`` (its calls), ``out`` (result bytes),
    ``view`` (the result aliases an input), ``write`` (the update bytes of
    an in-place op, else null), ``args`` and ``outs`` (shapes, dtypes and
    scalars) and,
    for a collective, ``kind``, ``operand``, ``result`` and ``group`` (its
    ranks).  A decode kernel's record adds ``live``, its live K/V rows
    (``kernels/ops.py``).  DTensor ops pass through to DTensor, whose local
    ops and collectives come back through the mode."""

    def __init__(self) -> None:
        super().__init__()
        self._index: Dict[Any, Dict[str, Any]] = {}
        self.trace: List[Dict[str, Any]] = []
        self._groups: Dict[str, List[int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _group_ranks(self, group: Any) -> List[int]:
        """The global ranks of a group, by its name (functional
        collectives) or its ``ProcessGroup`` (c10d ops)."""
        import torch.distributed as dist

        if not isinstance(group, str):  # the c10d op's boxed ProcessGroup
            return list(dist.get_process_group_ranks(dist.ProcessGroup.unbox(group)))
        if group not in self._groups:
            from torch.distributed.distributed_c10d import _resolve_process_group

            self._groups[group] = list(dist.get_process_group_ranks(
                _resolve_process_group(group)))
        return self._groups[group]

    def _record(self, func, args, kwargs, out) -> None:
        schema = func._schema
        ns, name = schema.name.split("::")
        op = f"{ns}::{name}"
        rec: Dict[str, Any] = {"op": op, "args": [_arg(a) for a in args], "outs": _arg(out)}
        short = name + ("_" if func._overloadname.endswith("_") else "")
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            group = next(a for a in reversed(args) if isinstance(a, str))
            inp = args[0]
            operand = (sum(_nbytes(t) for t in inp) if isinstance(inp, (list, tuple))
                       else _nbytes(inp))
            rec.update(kind=_COLLECTIVES[name], operand=operand, result=_out_bytes(out),
                       group=self._group_ranks(group))
        elif ns == "_c10d_functional" and short in _COLLECTIVES:
            group = next(a for a in reversed(args) if isinstance(a, str))
            rec.update(kind=_COLLECTIVES[short], operand=_nbytes(args[0]),
                       result=_nbytes(args[0]), group=self._group_ranks(group))
        elif ns == "c10d" and name in _C10D:
            tensors = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            nbytes = sum(_nbytes(t) for t in tensors)
            rec.update(kind=_C10D[name], operand=nbytes, result=nbytes,
                       group=self._group_ranks(args[1]))
        if ns == "repro_torch" and name in ("decode_attention", "paged_decode_attention"):
            from repro_torch.kernels.ops import _live_rows

            lengths, extent = args[-1], (args[1].shape[1] if name == "decode_attention"
                                         else args[3].shape[1] * args[1].shape[1])
            rec["live"] = _live_rows(lengths, extent)
        rec["view"] = bool(func.is_view) or any(
            a.alias_info is not None and not a.alias_info.is_write
            for a in schema.returns)
        mutated = [i for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        rec["write"] = None
        if mutated:
            j = _UPDATE_ARG.get(op)
            if j is not None and j < len(args):
                v = args[j]
                rec["write"] = _nbytes(v) if isinstance(v, torch.Tensor) else 0
            else:
                rec["write"] = sum(_nbytes(args[i]) for i in mutated if i < len(args))
        rec["out"] = 0 if mutated and not schema.returns else _out_bytes(out)
        key = repr(rec)
        hit = self._index.get(key)
        if hit is None:
            rec["n"] = 1
            self._index[key] = rec
            self.trace.append(rec)
        else:
            hit["n"] += 1

    def analysis(self, n_devices: int, pod_size: int = POD_SIZE) -> "TraceAnalysis":
        return analyze_trace(self.trace, n_devices, pod_size)


# --------------------------------------------------------------- analysis
def _is_tensor_entry(a: Any) -> bool:
    return (isinstance(a, list) and len(a) == 2 and isinstance(a[0], list)
            and isinstance(a[1], str))


def _shape(a: Any) -> Any:
    """A traced argument back as a shape (tensors) or itself (scalars)."""
    if _is_tensor_entry(a):
        return torch.Size(a[0])
    if isinstance(a, list):
        return [_shape(x) for x in a]
    return a


def _meta(a: Any) -> Any:
    """A traced argument back as a meta tensor of its shape and dtype
    (tensors) or itself (scalars): what a kernel op's FLOP formula reads."""
    if _is_tensor_entry(a):
        return torch.empty(a[0], dtype=getattr(torch, a[1]), device="meta")
    if isinstance(a, list):
        return [_meta(x) for x in a]
    return a


def record_flops(rec: Dict[str, Any], dots_only: bool = True) -> int:
    """The FLOPs one call of a traced op counts: towards ``dot_flops``
    2·m·n·k for a matmul and its formula for a kernel op; with
    ``dots_only`` False, also every other op ``FlopCounterMode`` has a
    formula for (convolutions, SDPA)."""
    from torch.utils.flop_counter import flop_registry

    ns, name = rec["op"].split("::")
    if ns == "repro_torch":
        from repro_torch.kernels import ops

        if "live" in rec:
            _b, H, Dh = _shape(rec["args"][0])
            return 4 * Dh * H * int(rec["live"])
        return int(ops.FLOP_FORMULAS[name](*[_meta(a) for a in rec["args"]], out_val=None))
    args = [_shape(a) for a in rec["args"]]
    if ns != "aten" or (dots_only and rec["op"] not in _DOTS):
        return 0
    formula = flop_registry.get(getattr(torch.ops.aten, name))
    if formula is None:
        return 0
    return int(formula(*args, out_val=_shape(rec.get("outs"))))


def record_traffic(rec: Dict[str, Any]) -> int:
    """The HBM bytes one call of a traced op counts towards
    ``memory_traffic``."""
    if rec["op"] in _NO_TRAFFIC or rec["view"]:
        return 0
    if rec["write"] is not None:
        return int(rec["write"])
    return int(rec["out"])


@dataclass
class TraceAnalysis:
    collectives: CollectiveSummary
    dot_flops: int
    memory_traffic: int
    kernel_calls: Dict[str, int]
    flops: int  # every op with a FLOP formula (``cost_analysis_raw``)


def analyze_trace(trace: List[Dict[str, Any]], n_devices: int,
                  pod_size: int = POD_SIZE) -> TraceAnalysis:
    """Collectives, ``dot_flops``, ``memory_traffic`` and the kernel ops'
    call counts of one rank's step, from its trace alone."""
    coll: List[CollectiveOp] = []
    flops = all_flops = traffic = 0
    kernels: Dict[str, int] = {}
    for rec in trace:
        n = int(rec["n"])
        if "kind" in rec:
            coll.append(CollectiveOp(
                kind=rec["kind"], name=rec["op"], operand_bytes=int(rec["operand"]),
                result_bytes=int(rec["result"]), group_size=len(rec["group"]),
                trip_count=n,
                crosses_pod=_crosses_pod([rec["group"]], n_devices, pod_size)))
        if rec["op"].startswith("repro_torch::"):
            name = rec["op"].split("::")[1]
            kernels[name] = kernels.get(name, 0) + n
        flops += record_flops(rec) * n
        all_flops += record_flops(rec, dots_only=False) * n
        traffic += record_traffic(rec) * n
    return TraceAnalysis(CollectiveSummary(coll), int(flops), int(traffic), kernels,
                         int(all_flops))


def collectives_record(coll: CollectiveSummary) -> Dict[str, Any]:
    """The dry-run record's ``collectives`` field."""
    return {
        "count": coll.count(),
        "wire_bytes_total": int(coll.total_wire()),
        "wire_bytes_ici": int(coll.total_wire(crosses_pod=False)),
        "wire_bytes_dci": int(coll.total_wire(crosses_pod=True)),
        "operand_bytes_total": int(coll.total_operand()),
        "by_kind": {k: int(v) for k, v in coll.by_kind().items()},
    }


def profile(fn, *args, n_devices: int = 1, pod_size: int = POD_SIZE, **kwargs
            ) -> Tuple[Any, TraceAnalysis, List[Dict[str, Any]]]:
    """Run ``fn(*args, **kwargs)`` once under :class:`OpProfiler`: (its
    result, the analysis, the trace)."""
    prof = OpProfiler()
    with hidden_shape_propagation(), prof:
        out = fn(*args, **kwargs)
    return out, prof.analysis(n_devices, pod_size), prof.trace
