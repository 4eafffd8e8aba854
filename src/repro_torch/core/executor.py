"""Executors & execution policies (HPX P6 substrate).

C++17 parallel algorithms take an *execution policy*; HPX extends these
with *executors* that bind a policy to concrete execution resources, and a
resource partitioner that carves workers into named thread pools.  This
module is that surface:

**Executors** (where work runs) — all expose the HPX executor protocol
``post`` / ``async_execute`` / ``sync_execute`` / ``bulk_async_execute``:

- :class:`SequencedExecutor`   — inline, in the calling thread;
- :class:`ThreadPoolExecutor`  — a named pool of the resource partitioner
  (:meth:`repro_torch.core.scheduler.Runtime.get_executor` hands these out);
- :class:`PriorityExecutor`    — wraps any executor with a scheduler
  priority (HPX ``annotating_executor`` / thread_priority);
- :class:`MeshExecutor`        — the device plane: data sharded over one
  axis of a torch ``DeviceMesh`` (a DTensor, ``Shard(0)`` on the axis's
  1-D submesh), bodies run per local shard, reductions finished by a
  collective over the axis's process group (the HPX distributed
  executor's analogue; :func:`mesh_policy`).

**Policies** (how algorithms lower) are *pure rewrite objects* — they carry
no resources of their own, only a lowering flavor plus executor/parameter
bindings:

    par.on(rt.get_executor("io"))              # bind to a resource
    par.with_(chunk_size=1024, priority=2)     # tune parameters
    par_task                                    # two-way: algorithms
                                                #   return Futures
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import scheduler as _sched
from repro_torch.core.future import Future, make_exceptional_future, make_ready_future


# ------------------------------------------------------------------ executors
class Executor:
    """HPX executor protocol.

    ``plane`` distinguishes host executors (chunked Python bodies on a
    thread pool) from device executors (whole-array sharded dispatch).
    ``bulk_async_execute(fn, args_seq)`` launches one task per element of
    ``args_seq`` (a tuple element is splatted as ``fn(*elem)``) — the
    algorithms library lowers every parallel loop through it.
    """

    plane = "host"

    # -- submission core (subclasses implement) ---------------------------
    def _submit(self, fn: Callable[..., Any], args: Tuple[Any, ...],
                kwargs: dict, priority: Optional[int]) -> Future[Any]:
        raise NotImplementedError

    def _post(self, fn: Callable[..., Any], args: Tuple[Any, ...],
              kwargs: dict, priority: Optional[int]) -> None:
        """Fire-and-forget core.  Failures must stay loud: inline executors
        propagate, pool executors report via ``/scheduler{pool}/tasks/failed``
        — never an exception parked in a Future nobody reads."""
        fn(*args, **kwargs)

    @property
    def parallelism(self) -> int:
        """Concurrent tasks this executor can make progress on (chunking hint)."""
        return 1

    # -- HPX executor surface ---------------------------------------------
    def post(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        """Fire-and-forget (``hpx::post``)."""
        self._post(fn, args, kwargs, None)

    def async_execute(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Future[Any]:
        """Schedule ``fn(*args, **kwargs)``; returns its Future (``hpx::async``)."""
        return self._submit(fn, args, kwargs, None)

    def sync_execute(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Schedule and join (``hpx::sync``)."""
        return self.async_execute(fn, *args, **kwargs).get()

    def bulk_async_execute(self, fn: Callable[..., Any],
                           args_seq: Sequence[Any]) -> List[Future[Any]]:
        """One task per element; tuples splat as ``fn(*elem)``."""
        return [
            self._submit(fn, a if isinstance(a, tuple) else (a,), {}, None)
            for a in args_seq
        ]


class SequencedExecutor(Executor):
    """Runs everything inline in the calling thread (the ``seq`` resource).

    Futures it returns are already resolved — it exists so sequential and
    parallel lowerings share one code path in the algorithms library."""

    def _submit(self, fn, args, kwargs, priority):
        try:
            return make_ready_future(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 — futures carry any error
            return make_exceptional_future(e)

    def sync_execute(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)


class ThreadPoolExecutor(Executor):
    """Binds a *named* pool of the resource partitioner.

    The pool is resolved late — at submission, against ``runtime`` (or the
    global runtime when ``runtime`` is None) — so a module-level executor
    stays valid across runtime restarts.  ``fallback`` names a pool to use
    when the requested one was never partitioned (e.g. "io" consumers on a
    bare single-pool runtime)."""

    def __init__(self, pool: Optional[str] = None, *,
                 runtime: Optional["_sched.Runtime"] = None,
                 fallback: Optional[str] = None,
                 priority: Optional[int] = None):
        self.pool_name = pool
        self.fallback = fallback
        self.priority = priority
        self._runtime = runtime

    def _pool(self) -> "_sched.ThreadPool":
        rt = self._runtime if self._runtime is not None else _sched.get_runtime()
        return rt.pool(self.pool_name, fallback=self.fallback)

    @property
    def parallelism(self) -> int:
        return self._pool().num_workers

    def _submit(self, fn, args, kwargs, priority):
        prio = priority if priority is not None else self.priority
        return self._pool().spawn(
            fn, *args,
            priority=_sched.PRIORITY_NORMAL if prio is None else prio,
            **kwargs)

    def _post(self, fn, args, kwargs, priority):
        prio = priority if priority is not None else self.priority
        if args or kwargs:
            self._pool().spawn_raw(lambda: fn(*args, **kwargs), priority=prio)
        else:
            self._pool().spawn_raw(fn, priority=prio)

    def __repr__(self) -> str:
        return f"ThreadPoolExecutor({self.pool_name!r})"


class PriorityExecutor(Executor):
    """Wraps any executor, stamping a scheduler priority on its tasks
    (HPX ``thread_priority`` annotation).  Priority-oblivious executors
    (sequenced, mesh) run unchanged."""

    def __init__(self, inner: Executor, priority: int):
        self.inner = inner
        self.priority = priority

    @property
    def plane(self) -> str:  # type: ignore[override]
        return self.inner.plane

    @property
    def parallelism(self) -> int:
        return self.inner.parallelism

    def _submit(self, fn, args, kwargs, priority):
        return self.inner._submit(fn, args, kwargs,
                                  self.priority if priority is None else priority)

    def _post(self, fn, args, kwargs, priority):
        self.inner._post(fn, args, kwargs,
                         self.priority if priority is None else priority)

    def __repr__(self) -> str:
        return f"PriorityExecutor({self.inner!r}, priority={self.priority})"


class MeshExecutor(Executor):
    """Device-plane executor: data sharded over one mesh axis, algorithm
    bodies run per local shard through ``torch.vmap``, sums finished by an
    ``all_reduce`` over the axis's group.  SPMD: every rank of the mesh
    calls the same algorithm with the same (global) data, and each keeps
    its own rows; nothing is copied to split it.

    Host-protocol calls (``post``/``async_execute``) run the Python callable
    inline — device work is enqueued asynchronously already, so the host
    side of a device computation never needs a worker thread."""

    plane = "device"

    def __init__(self, mesh: Any, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis

    @property
    def parallelism(self) -> int:
        return self.mesh.size(list(self.mesh.mesh_dim_names).index(self.axis))

    def _submit(self, fn, args, kwargs, priority):
        try:
            return make_ready_future(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001
            return make_exceptional_future(e)

    # -- device-plane dispatch (used by repro_torch.core.algorithms) -------
    def submesh(self) -> Any:
        """The 1-D mesh of the executor's axis (this rank's row of it)."""
        return self.mesh if self.mesh.ndim == 1 else self.mesh[self.axis]

    def device(self) -> torch.device:
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def put(self, arr: Any) -> Any:
        """Shard ``arr`` (dim 0) over the executor's axis: a DTensor whose
        local part is this rank's rows.  ``arr`` is the same on every
        rank, so no collective runs; a DTensor already so placed stays."""
        from torch.distributed.tensor import DTensor, Shard, distribute_tensor

        sub = self.submesh()
        if isinstance(arr, DTensor):
            if arr.device_mesh == sub and list(arr.placements) == [Shard(0)]:
                return arr
            arr = arr.full_tensor()
        t = torch.as_tensor(arr).to(self.device())
        return distribute_tensor(t, sub, [Shard(0)], src_data_rank=None)

    def vmap_apply(self, fn: Callable[[Any], Any], arr: Any,
                   vmap: Optional[Callable[[Callable, Any], Any]] = None) -> Any:
        """Elementwise map: sharded in, sharded out (``Shard(0)``), the
        body vectorized over the local rows by ``vmap(fn, local)`` (default
        ``torch.vmap``)."""
        from torch.distributed.tensor import DTensor, Shard

        x = self.put(arr)
        local = (vmap or (lambda f, a: torch.vmap(f)(a)))(fn, x.to_local())
        shape = torch.Size((x.shape[0],) + tuple(local.shape[1:]))
        return DTensor.from_local(local, x.device_mesh, [Shard(0)], run_check=False,
                                  shape=shape, stride=_contiguous_stride(shape))

    def sum_total(self, arr: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Global sum over dim 0: each rank's partial sum of its rows, then
        an ``all_reduce`` over the axis's group.  A plain tensor, the same
        on every rank."""
        import torch.distributed as dist

        x = self.put(arr)
        total = torch.sum(x.to_local(), dim=0, dtype=dtype)  # elements may be batched
        dist.all_reduce(total, group=self.submesh().get_group())
        return total

    def extremum_total(self, arr: Any, largest: bool) -> torch.Tensor:
        """Global elementwise min (max with ``largest``) over dim 0: each
        rank's own rows, then an ``all_reduce`` MIN / MAX; a rank with no
        rows brings the dtype's identity."""
        import torch.distributed as dist

        x = self.put(arr)
        local = x.to_local()
        if local.shape[0]:
            part = (torch.amax if largest else torch.amin)(local, dim=0)
        else:
            info = (torch.finfo if local.dtype.is_floating_point else torch.iinfo)(local.dtype)
            part = torch.full(tuple(local.shape[1:]), info.min if largest else info.max,
                              dtype=local.dtype, device=local.device)
        dist.all_reduce(part, op=dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN,
                        group=self.submesh().get_group())
        return part

    def __repr__(self) -> str:
        return f"MeshExecutor(axis={self.axis!r}, mesh={self.mesh!r})"


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def get_executor(pool: Optional[str] = None, priority: Optional[int] = None,
                 fallback: Optional[str] = None,
                 runtime: Optional["_sched.Runtime"] = None) -> Executor:
    """Executor over a named pool of the resource partitioner.

    This (via ``Runtime.get_executor``) is the sanctioned way for code
    outside :mod:`repro_torch.core` to reach scheduler pools."""
    ex: Executor = ThreadPoolExecutor(pool, runtime=runtime, fallback=fallback)
    if priority is not None:
        ex = PriorityExecutor(ex, priority)
    return ex


# ------------------------------------------------------------------- policies
_FLAVORS = ("seq", "par", "vec")


class ExecutionPolicy:
    """A pure rewrite object: lowering flavor + executor/parameter bindings.

    - ``flavor``     "seq" (inline loop), "par" (chunked over an executor's
      pool), "vec" (vectorized over a batch dimension);
    - ``executor``   where chunks go (None → seq inline, par default pool;
      a device-plane executor switches any flavor to sharded lowering);
    - ``chunk_size`` / ``priority``  executor parameters (``with_``);
    - ``task``       two-way execution: algorithms return ``Future``s
      instead of joining (HPX ``par(task)``).
    """

    __slots__ = ("flavor", "executor", "chunk_size", "priority", "task")

    def __init__(self, flavor: Optional[str] = None, chunk_size: Optional[int] = None,
                 *, executor: Optional[Executor] = None,
                 priority: Optional[int] = None, task: bool = False):
        flavor = flavor or "seq"
        if flavor not in _FLAVORS:
            raise ValueError(f"unknown policy flavor {flavor!r}; choose from {_FLAVORS}")
        object.__setattr__(self, "flavor", flavor)
        object.__setattr__(self, "executor", executor)
        object.__setattr__(self, "chunk_size", None if chunk_size is None else int(chunk_size))
        object.__setattr__(self, "priority", priority)
        object.__setattr__(self, "task", bool(task))

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("ExecutionPolicy is immutable; use .on()/.with_()")

    def _replace(self, **kw: Any) -> "ExecutionPolicy":
        cur = {s: getattr(self, s) for s in self.__slots__}
        cur.update(kw)
        return ExecutionPolicy(cur["flavor"], chunk_size=cur["chunk_size"],
                               executor=cur["executor"],
                               priority=cur["priority"], task=cur["task"])

    # -- rewrites ---------------------------------------------------------
    def on(self, executor: Executor) -> "ExecutionPolicy":
        """Bind to an executor (HPX ``policy.on(exec)``)."""
        if not isinstance(executor, Executor):
            raise TypeError(f"policy.on() takes an Executor, got {executor!r}")
        return self._replace(executor=executor)

    def with_(self, chunk_size: Optional[int] = None,
              priority: Optional[int] = None,
              task: Optional[bool] = None) -> "ExecutionPolicy":
        """Rebind executor parameters (HPX ``policy.with_(params)``)."""
        kw: dict = {}
        if chunk_size is not None:
            kw["chunk_size"] = int(chunk_size)
        if priority is not None:
            kw["priority"] = priority
        if task is not None:
            kw["task"] = bool(task)
        return self._replace(**kw)

    def with_chunk_size(self, n: int) -> "ExecutionPolicy":
        """Back-compat alias for ``with_(chunk_size=n)``."""
        return self.with_(chunk_size=n)

    # -- readers ----------------------------------------------------------
    @property
    def kind(self) -> str:
        """"mesh" when bound to a device-plane executor, else the flavor."""
        if self.executor is not None and self.executor.plane == "device":
            return "mesh"
        return self.flavor

    @property
    def mesh(self) -> Any:
        return getattr(self.executor, "mesh", None)

    @property
    def axis(self) -> Optional[str]:
        return getattr(self.executor, "axis", None)

    def __repr__(self) -> str:
        bits = [self.flavor]
        if self.task:
            bits.append("task")
        if self.executor is not None:
            bits.append(f"on={self.executor!r}")
        if self.chunk_size is not None:
            bits.append(f"chunk_size={self.chunk_size}")
        if self.priority is not None:
            bits.append(f"priority={self.priority}")
        return f"ExecutionPolicy({', '.join(bits)})"

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, ExecutionPolicy)
                and all(getattr(self, s) == getattr(other, s) for s in self.__slots__))

    def __hash__(self) -> int:
        return hash((self.flavor, id(self.executor), self.chunk_size,
                     self.priority, self.task))


seq = ExecutionPolicy("seq")
par = ExecutionPolicy("par")
vec = ExecutionPolicy("vec")
seq_task = ExecutionPolicy("seq", task=True)
par_task = ExecutionPolicy("par", task=True)  # HPX par(task): two-way algorithms


def mesh_policy(mesh: Any, axis: str = "data") -> ExecutionPolicy:
    """Device-plane policy: ``vec`` lowered through a :class:`MeshExecutor`."""
    return vec._replace(executor=MeshExecutor(mesh, axis))

