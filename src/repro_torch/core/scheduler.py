"""Work-stealing task scheduler + resource partitioner (HPX P2, paper §2.1).

The paper's thread manager offers interchangeable scheduling policies:

- ``static``       one queue per core, **no stealing**;
- ``local``        (default) one queue per core + work stealing from
                   neighbours + high-priority queues;
- ``hierarchical`` a tree of queues — tasks enqueue at the root and
                   *trickle down* as cores fetch work.

HPX's *resource partitioner* carves the machine's processing units into
**named thread pools** so different concerns never compete for the same
workers (the HPX+LCI case study keeps communication progress off the
compute pool).  Ours is :class:`Runtime`: a container of named
:class:`ThreadPool`\\ s, e.g.::

    rt = init(pools={"default": 4, "io": 1, "prefill": 1})
    ex = rt.get_executor("io")          # the only public way into a pool
    ex.async_execute(write_checkpoint)  # host I/O never steals compute slots

GPU adaptation: there are no user-level threads inside a CUDA stream, so
these pools run on the *host orchestration plane*: they drive device-step
dispatch (asynchronous in PyTorch — the host thread returns once the
kernels are enqueued while the GPU computes), host I/O and serving
continuations.  The paper's "oversubscribing execution resources" maps to
launching many more logical tasks than workers; blocked tasks *help along*
(see :meth:`ThreadPool._help_until`), the analogue of HPX suspending a
user-level thread instead of an OS thread.

Performance counters published per pool (HPX names, §2.4)::

    /scheduler{<pool>}/tasks/spawned
    /scheduler{<pool>}/tasks/executed
    /scheduler{<pool>}/tasks/stolen
    /scheduler{<pool>}/tasks/pending        (instantaneous)
    /scheduler{<pool>}/task/duration        (timer)

Utilization accounting (HPX ``/threads{...}/idle-rate`` parity): every
worker accumulates *monotonic* busy/idle wall time at its own state
transitions — two clock reads per task, no locks, written only by the
owning worker and read racily by the counters (a torn read is one task
wide).  Published per pool::

    /scheduler{<pool>}/idle-rate            fraction [0,1] since pool start
    /scheduler{<pool>}/utilization          1 - idle-rate
    /scheduler{<pool>}/time/busy            cumulative busy seconds (counter)
    /scheduler{<pool>}/time/idle            cumulative idle seconds (counter)
    /scheduler{<pool>}/steals/victim#V/thief#T   steal matrix (counters)
    /scheduler{<pool>}/queue/worker#I/depth      per-worker queue gauge
    /scheduler{<pool>}/queue/high/depth          shared hi-prio queue gauge

The cumulative ``time/*`` counters are the windowed form: the fleet
sampler's positive-delta *rates* of busy vs idle give utilization over
any window (``FleetView.pool_utilization``), which is what adaptive
policies predicate on — the instantaneous fraction counters are the
since-birth summary an operator reads.  ``accounting=False`` disables
the transition bookkeeping (and skips registering the counters) for A/B
overhead measurement; the measured cost is gated ≤2% on the algorithms
bench (``BENCH_algorithms.json: sched_accounting``).

Outside :mod:`repro_torch.core`, tasks reach a pool exclusively through the
executors of :mod:`repro_torch.core.executor` (``Runtime.get_executor``); the
``spawn``/``spawn_raw`` entry points here are the runtime's internal
substrate (enforced by ``tests/test_api_guard.py``).
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core import counters as _counters
from repro_torch.core.future import Future, Promise
from repro_torch.obs import trace as _trace

# Task priorities (HPX: thread_priority::{low,normal,high,boost}).
PRIORITY_LOW = 0
PRIORITY_NORMAL = 1
PRIORITY_HIGH = 2

_POLICIES = ("static", "local", "hierarchical")

DEFAULT_POOL = "default"

# Worker-thread identity: which pool owns the calling thread (module-level so
# a Runtime can route help-along to whichever of its pools is blocking).
_tls = threading.local()


class _Task:
    __slots__ = ("fn", "promise", "priority")

    def __init__(self, fn: Callable[[], Any], promise: Optional[Promise], priority: int):
        self.fn = fn
        self.promise = promise
        self.priority = priority

    def run(self) -> None:
        if self.promise is None:
            self.fn()
            return
        try:
            self.promise.set_value(self.fn())
        except BaseException as e:  # noqa: BLE001
            self.promise.set_exception(e)


class ThreadPool:
    """One named worker pool: per-worker queues, stealing, counters.

    This is the unit the resource partitioner hands out.  Pools are reached
    through :meth:`Runtime.get_executor`; direct construction is for the
    runtime (and scheduler micro-benchmarks/tests).
    """

    def __init__(
        self,
        name: str = DEFAULT_POOL,
        num_workers: int = 4,
        policy: str = "local",
        steal_seed: int = 0,
        accounting: bool = True,
    ):
        if policy not in _POLICIES:
            raise ValueError(f"unknown scheduling policy {policy!r}; choose from {_POLICIES}")
        self.policy = policy
        self.num_workers = max(1, int(num_workers))
        self.name = name
        self._runtime: Optional["Runtime"] = None  # owning partitioner, if any
        self._queues: List[Deque[_Task]] = [collections.deque() for _ in range(self.num_workers)]
        self._hi_queue: Deque[_Task] = collections.deque()  # shared high-priority queue
        self._root_queue: Deque[_Task] = collections.deque()  # hierarchical root
        self._lock = threading.Lock()
        self._work_available = threading.Condition(self._lock)
        self._shutdown = False
        self._threads: List[threading.Thread] = []
        self._rng = random.Random(steal_seed)
        self._rr = 0

        # --- utilization accounting (single-writer per worker, racy reads)
        self.accounting = bool(accounting)
        now = time.perf_counter()
        self._busy = [0.0] * self.num_workers   # cumulative busy seconds
        self._idle = [0.0] * self.num_workers   # cumulative idle seconds
        self._mark = [now] * self.num_workers   # last state-transition time
        self._state = [0] * self.num_workers    # 0 = idle, 1 = busy
        # victim -> thief steal matrix; incremented under self._lock (the
        # steal itself happens there), read via steal_matrix()/counters
        self._steals: Dict[Tuple[int, int], int] = {}

        reg = _counters.default()
        p = f"/scheduler{{{name}}}"
        self.c_spawned = reg.counter(f"{p}/tasks/spawned")
        self.c_executed = reg.counter(f"{p}/tasks/executed")
        self.c_stolen = reg.counter(f"{p}/tasks/stolen")
        self.c_failed = reg.counter(f"{p}/tasks/failed")
        self.t_task = reg.timer(f"{p}/task/duration")
        reg.register_callable(f"{p}/tasks/pending", self._pending_count)
        if self.accounting:
            reg.register_callable(f"{p}/idle-rate", self.idle_rate)
            reg.register_callable(f"{p}/utilization", self.utilization)
            reg.register_callable(f"{p}/time/busy",
                                  lambda: self.time_totals()[0],
                                  kind="counter")
            reg.register_callable(f"{p}/time/idle",
                                  lambda: self.time_totals()[1],
                                  kind="counter")
            reg.register_callable(f"{p}/queue/high/depth",
                                  lambda: float(len(self._hi_queue)))
            for i in range(self.num_workers):
                reg.register_callable(
                    f"{p}/queue/worker#{i}/depth",
                    lambda q=self._queues[i]: float(len(q)))
            # the steal matrix is published pairwise only on small pools —
            # a 64-worker pool would mint 4k counters for no reader
            if self.policy == "local" and 1 < self.num_workers <= 16:
                for v in range(self.num_workers):
                    for t in range(self.num_workers):
                        if v == t:
                            continue
                        reg.register_callable(
                            f"{p}/steals/victim#{v}/thief#{t}",
                            lambda k=(v, t): float(self._steals.get(k, 0)),
                            kind="counter")

        for i in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(i,), daemon=True,
                                 name=f"repro-{name}-w{i}")
            self._threads.append(t)
            t.start()

    # ------------------------------------------------------------------ api
    def spawn(
        self,
        fn: Callable[..., Any],
        *args: Any,
        priority: int = PRIORITY_NORMAL,
        worker_hint: Optional[int] = None,
        **kwargs: Any,
    ) -> Future[Any]:
        """``hpx::async`` — schedule ``fn(*args, **kwargs)``, return a Future."""
        promise: Promise[Any] = Promise()
        task = _Task((lambda: fn(*args, **kwargs)) if (args or kwargs) else fn, promise, priority)
        self._enqueue(task, worker_hint)
        return promise.future()

    def spawn_raw(self, fn: Callable[[], Any], priority: Optional[int] = None,
                  worker_hint: Optional[int] = None) -> None:
        """Fire-and-forget task with no promise (continuation plumbing)."""
        self._enqueue(_Task(fn, None, priority if priority is not None else PRIORITY_NORMAL), worker_hint)

    def on_worker_thread(self) -> bool:
        return getattr(_tls, "pool", None) is self

    def current_worker(self) -> Optional[int]:
        return getattr(_tls, "worker_id", None) if self.on_worker_thread() else None

    def pending(self) -> int:
        return int(self._pending_count())

    # ------------------------------------------------- utilization accounting
    def utilization_snapshot(self) -> Dict[str, Any]:
        """Per-worker busy/idle seconds with a live correction for the
        in-progress interval (a worker 10 s into a long task reads as 10 s
        busier than its last transition recorded).  Reads are lock-free and
        may tear by one task — monotonic accumulators make that benign."""
        now = time.perf_counter()
        busy, idle = [], []
        for i in range(self.num_workers):
            b, d, m, s = (self._busy[i], self._idle[i],
                          self._mark[i], self._state[i])
            live = max(0.0, now - m)
            busy.append(b + (live if s else 0.0))
            idle.append(d + (0.0 if s else live))
        return {"busy": busy, "idle": idle}

    def time_totals(self) -> Tuple[float, float]:
        """(cumulative busy seconds, cumulative idle seconds) across all
        workers — the monotonic counters whose *rates* give windowed
        utilization."""
        snap = self.utilization_snapshot()
        return sum(snap["busy"]), sum(snap["idle"])

    def idle_rate(self) -> float:
        """Fraction of worker wall time spent idle since pool start
        (HPX ``/threads{...}/idle-rate``, as a [0,1] fraction)."""
        busy, idle = self.time_totals()
        total = busy + idle
        return idle / total if total > 0.0 else 0.0

    def utilization(self) -> float:
        return 1.0 - self.idle_rate()

    def steal_matrix(self) -> Dict[Tuple[int, int], int]:
        """Copy of the (victim, thief) -> count steal matrix."""
        with self._lock:
            return dict(self._steals)

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            self._work_available.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=10.0)

    # ----------------------------------------------------------- internals
    def _pending_count(self) -> float:
        with self._lock:
            return float(
                sum(len(q) for q in self._queues) + len(self._hi_queue) + len(self._root_queue)
            )

    def _enqueue(self, task: _Task, worker_hint: Optional[int]) -> None:
        self.c_spawned.increment()
        with self._lock:
            if task.priority >= PRIORITY_HIGH:
                self._hi_queue.append(task)
            elif self.policy == "hierarchical":
                # tasks always enqueue at the root and trickle down
                self._root_queue.append(task)
            else:
                wid = worker_hint
                if wid is None:
                    wid = self.current_worker()  # child tasks stay local (work-first)
                if wid is None:
                    wid = self._rr % self.num_workers
                    self._rr += 1
                self._queues[wid % self.num_workers].append(task)
            self._work_available.notify()

    def _try_pop(self, wid: int) -> Optional[_Task]:
        """Pop under self._lock. Order: high-prio, own queue (LIFO), then
        policy-dependent acquisition (steal FIFO / trickle from root)."""
        if self._hi_queue:
            return self._hi_queue.popleft()
        q = self._queues[wid]
        if q:
            return q.pop()  # LIFO for locality
        if self.policy == "hierarchical":
            if self._root_queue:
                task = self._root_queue.popleft()
                # trickle a small batch down into the local queue
                for _ in range(min(3, len(self._root_queue))):
                    q.append(self._root_queue.popleft())
                return task
            return None
        if self.policy == "local":
            # steal FIFO (oldest = largest granularity) from a random victim
            offs = self._rng.randrange(1, self.num_workers) if self.num_workers > 1 else 0
            for k in range(self.num_workers - 1):
                vid = (wid + offs + k) % self.num_workers
                if vid == wid:
                    continue
                victim = self._queues[vid]
                if victim:
                    self.c_stolen.increment()
                    key = (vid, wid)
                    self._steals[key] = self._steals.get(key, 0) + 1
                    if _trace._enabled:
                        _trace.instant("task/steal", "sched", pool=self.name,
                                       thief=wid, victim=vid)
                    return victim.popleft()
        return None  # static: never steal

    def _run_task(self, task: _Task) -> None:
        if _trace._enabled:
            with _trace.span("task/run", "sched", pool=self.name):
                self._run_task_body(task)
        else:  # hot path: one flag test, zero tracing cost
            self._run_task_body(task)

    def _run_task_body(self, task: _Task) -> None:
        with self.t_task.time():
            try:
                task.run()
            except BaseException:  # noqa: BLE001 — promise-less task raised:
                # report loudly but never kill the worker (a dead worker on a
                # 1-worker pool would silently hang every later task)
                import traceback

                self.c_failed.increment()
                traceback.print_exc()
        self.c_executed.increment()

    def _worker(self, wid: int) -> None:
        _tls.pool = self
        _tls.worker_id = wid
        acct = self.accounting
        perf = time.perf_counter  # bound method: the accounting hot path
        while True:
            with self._lock:
                task = self._try_pop(wid)
                if task is None:
                    if self._shutdown:
                        return
                    self._work_available.wait(timeout=0.05)
                    continue
            if acct:
                # idle -> busy transition (two clock reads per task total;
                # written only by this worker, read racily by counters)
                now = perf()
                self._idle[wid] += now - self._mark[wid]
                self._mark[wid] = now
                self._state[wid] = 1
            self._run_task(task)
            if acct:
                now = perf()
                self._busy[wid] += now - self._mark[wid]
                self._mark[wid] = now
                self._state[wid] = 0

    def _help_until(self, future: Future, timeout: Optional[float]) -> None:
        """Help-along loop: a worker blocked on ``future`` executes other
        tasks from *its own pool* instead of idling (HPX user-thread
        suspension analogue)."""
        wid = self.current_worker()
        if wid is None:
            return
        import time as _time

        deadline = None if timeout is None else _time.perf_counter() + timeout
        while not future.is_ready():
            with self._lock:
                task = self._try_pop(wid)
            if task is not None:
                self._run_task(task)
            else:
                if deadline is not None and _time.perf_counter() > deadline:
                    return
                future.wait_passive(0.002)

    def drain(self, timeout: float = 60.0) -> None:
        """Block until no tasks are pending (test/benchmark helper)."""
        import time as _time

        deadline = _time.perf_counter() + timeout
        while self._pending_count() > 0:
            if _time.perf_counter() > deadline:
                raise TimeoutError("scheduler drain timed out")
            _time.sleep(0.001)


class Runtime:
    """An HPX-style runtime instance: the resource partitioner's output.

    Holds one or more named :class:`ThreadPool`\\ s.  Use as a context
    manager, or via module-level :func:`init`/:func:`finalize`::

        with Runtime(pools={"default": 4, "io": 1}) as rt:
            f = rt.get_executor("io").async_execute(lambda: 2 + 2)
            assert f.get() == 4

    Single-pool construction (``Runtime(num_workers=4)``) is kept for the
    scheduler tests/benchmarks; the partitioned form is ``pools={...}``.
    Pools are reached through :meth:`get_executor` — the queues themselves
    are not part of the public surface.
    """

    def __init__(
        self,
        num_workers: int = 4,
        policy: str = "local",
        pool_name: str = DEFAULT_POOL,
        steal_seed: int = 0,
        pools: Optional[Dict[str, int]] = None,
        accounting: bool = True,
    ):
        if pools is None:
            pools = {pool_name: num_workers}
        if not pools:
            raise ValueError("resource partitioner needs at least one pool")
        self._pools: Dict[str, ThreadPool] = {}
        self._pool_lock = threading.Lock()
        self.policy = policy
        self.accounting = bool(accounting)
        self._default_name = (
            pool_name if pool_name in pools
            else (DEFAULT_POOL if DEFAULT_POOL in pools else next(iter(pools)))
        )
        for name, n in pools.items():
            p = ThreadPool(name=name, num_workers=n, policy=policy,
                           steal_seed=steal_seed, accounting=accounting)
            p._runtime = self
            self._pools[name] = p

    # -------------------------------------------------- resource partitioner
    def pool_names(self) -> List[str]:
        with self._pool_lock:
            return list(self._pools)

    def pool(self, name: str = None, fallback: Optional[str] = None) -> ThreadPool:
        """Resolve a named pool (``None`` → the default pool).

        ``fallback`` names a pool to use when ``name`` was never partitioned
        (lets consumers declare an affinity — "io", "prefill" — that
        degrades gracefully on an unpartitioned runtime); a fallback that is
        itself unpartitioned resolves to the runtime's default pool."""
        name = name or self._default_name
        with self._pool_lock:
            p = self._pools.get(name)
            if p is None and fallback is not None:
                p = (self._pools.get(fallback)
                     or self._pools.get(self._default_name))
            if p is None:
                raise KeyError(
                    f"no thread pool {name!r} in this runtime (pools: "
                    f"{sorted(self._pools)}); partition it via "
                    f"init(pools={{...}}) or Runtime.add_pool")
            return p

    def add_pool(self, name: str, num_workers: int, policy: Optional[str] = None) -> ThreadPool:
        """Idempotently add a pool to a live runtime (elastic partitioning).

        Returns the existing pool unchanged if ``name`` is already
        partitioned — consumers use this to declare the pools they need."""
        with self._pool_lock:
            p = self._pools.get(name)
            if p is None:
                p = ThreadPool(name=name, num_workers=num_workers,
                               policy=policy or self.policy,
                               accounting=self.accounting)
                p._runtime = self
                self._pools[name] = p
            return p

    def get_executor(self, pool: str = None, priority: Optional[int] = None,
                     fallback: Optional[str] = None):
        """The sanctioned entry point to a pool: an executor bound to it.

        Returns a :class:`~repro_torch.core.executor.ThreadPoolExecutor` (wrapped
        in a :class:`~repro_torch.core.executor.PriorityExecutor` when ``priority``
        is given)."""
        from repro_torch.core import executor as _executor  # deferred, avoids cycle

        return _executor.get_executor(pool, priority=priority,
                                      fallback=fallback, runtime=self)

    # ------------------------------------------- default-pool compatibility
    @property
    def pool_name(self) -> str:
        return self._default_name

    @property
    def num_workers(self) -> int:
        return self.pool().num_workers

    def spawn(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Future[Any]:
        return self.pool().spawn(fn, *args, **kwargs)

    def spawn_raw(self, fn: Callable[[], Any], priority: Optional[int] = None,
                  worker_hint: Optional[int] = None) -> None:
        self.pool().spawn_raw(fn, priority=priority, worker_hint=worker_hint)

    def on_worker_thread(self) -> bool:
        # lock-free hot path: Future.get/wait probe this on every join
        p = getattr(_tls, "pool", None)
        return p is not None and p._runtime is self

    def current_worker(self) -> Optional[int]:
        return getattr(_tls, "worker_id", None) if self.on_worker_thread() else None

    def pending(self) -> int:
        with self._pool_lock:
            pools = list(self._pools.values())
        return sum(p.pending() for p in pools)

    def _help_until(self, future: Future, timeout: Optional[float]) -> None:
        """Route help-along to whichever of our pools owns the calling
        worker thread (a blocked io worker helps io, not compute)."""
        p = getattr(_tls, "pool", None)
        if p is not None and p._runtime is self:
            p._help_until(future, timeout)

    def drain(self, timeout: float = 60.0) -> None:
        with self._pool_lock:
            pools = list(self._pools.values())
        for p in pools:
            p.drain(timeout)

    def shutdown(self, wait: bool = True) -> None:
        with self._pool_lock:
            pools = list(self._pools.values())
        for p in pools:
            p.shutdown(wait=wait)
        global _runtime
        with _runtime_lock:
            if _runtime is self:
                _runtime = None

    def __enter__(self) -> "Runtime":
        _set_runtime(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False


# --------------------------------------------------------------- module api
_runtime: Optional[Runtime] = None
_runtime_lock = threading.Lock()

# Pools a bare init() partitions: compute + one host-I/O progress worker
# (checkpoint writes, prefetch assembly) so I/O never steals compute slots.
DEFAULT_POOLS = {"io": 1}


def _set_runtime(rt: Runtime) -> None:
    global _runtime
    with _runtime_lock:
        _runtime = rt


def init(num_workers: int = 4, policy: str = "local",
         pools: Optional[Dict[str, int]] = None) -> Runtime:
    """``hpx::init`` — bring up (or return) the global runtime.

    ``pools`` is the resource-partitioner spec (name → workers), e.g.
    ``init(pools={"default": 8, "io": 1, "prefill": 2})``, honored exactly
    as given (an explicit partition never grows hidden pools; consumers
    with a pool affinity fall back to the runtime's default pool).
    Omitted, it defaults to ``{"default": num_workers, **DEFAULT_POOLS}``.
    On an already-running runtime the requested pools are added
    idempotently (elastic partitioning), never shrunk."""
    global _runtime
    with _runtime_lock:
        rt = _runtime
        if rt is None:
            if pools is None:
                pools = {DEFAULT_POOL: num_workers, **DEFAULT_POOLS}
            rt = _runtime = Runtime(policy=policy, pools=pools)
            return rt
    # existing runtime: elastic, idempotent partition growth
    if pools:
        for name, n in pools.items():
            rt.add_pool(name, n, policy=policy)
    return rt


def finalize() -> None:
    """``hpx::finalize`` — tear down the global runtime."""
    global _runtime
    with _runtime_lock:
        rt, _runtime = _runtime, None
    if rt is not None:
        rt.shutdown()


def current_runtime() -> Optional[Runtime]:
    return _runtime


def get_runtime() -> Runtime:
    """Global runtime, creating a default one on first use."""
    return init()


def spawn(fn: Callable[..., Any], *args: Any, executor: Any = None,
          **kwargs: Any) -> Future[Any]:
    """``hpx::async`` — on ``executor`` when given, else the default pool."""
    if executor is not None:
        return executor.async_execute(fn, *args, **kwargs)
    return get_runtime().spawn(fn, *args, **kwargs)


async_ = spawn  # HPX spelling
