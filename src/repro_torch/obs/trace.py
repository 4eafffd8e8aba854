"""Task/parcel trace recorder — the APEX introspection tier (paper §2.4).

HPX ships with APEX, whose task timers and OTF2/Chrome exporters are what
the shared-memory task-scheduling study (Diehl et al., arXiv:2302.07191)
and the HPX+LCI parcel study (Yan et al., arXiv:2503.12774) use to answer
"where does the time go".  This module is the recorder half of our
adaptation: a **lock-cheap per-thread ring buffer** of trace events that
the instrumented subsystems append to —

- scheduler worker loop: one complete span per task (pool, steals);
- parcelport: serialize/send/recv/execute spans with wire byte counts,
  and *flow events* stitching a parcel's send span to its remote
  execution span;
- serve engine: per-request async spans (admission → finish), a span
  per prefill and per decode step, each split into the host's enqueue
  and its wait for the device;
- trainer step loop and segmented-algorithm per-segment actions.

Cost model (the observability contract):

- **Disabled** (the default): every recording entry point checks the
  module-level ``_enabled`` flag first and returns immediately — no
  allocation, no clock read, no lock.  Instrumentation call sites on hot
  paths additionally guard with ``if trace._enabled:`` so the disabled
  cost is one attribute load + branch.
- **Enabled**: events append to a *per-thread* ring buffer (single
  writer, no lock on the append path; the global registry lock is taken
  once per thread, at buffer creation).  The ring overwrites the oldest
  events on wraparound and counts drops — tracing never blocks and never
  grows unbounded.

Trace context propagation: every span publishes ``(locality, span_id)``
as the thread's current context; the net tier copies it into the parcel
header (``tc``) so the receiving locality records a causally-linked child
span plus a Chrome flow-event pair (``ph:"s"`` at the sender inside the
send span, ``ph:"f"`` at the receiver inside the execute span) that
Perfetto draws as an arrow across localities.

This module is a leaf: no package imports at module scope (the
scheduler imports it, so it must sit below everything).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# Module-level flag, checked before ANY event is recorded (the ISSUE's
# near-zero-disabled-cost contract).  Instrumentation sites read it as
# ``trace._enabled`` — one attribute load — before touching anything else.
_enabled = False

DEFAULT_CAPACITY = 65536

_lock = threading.Lock()
_buffers: List["TraceBuffer"] = []
_capacity = DEFAULT_CAPACITY
_epoch = 0          # bumped by clear(): stale thread-local buffers re-register
_locality = 0       # stamped into span/flow ids; refreshed by enable()
_seq = itertools.count(1)  # span / flow id allocator (process-wide)

_tls = threading.local()

# Event tuples: (ph, name, cat, ts, dur, id, args)
#   ph  — Chrome trace-event phase: "X" complete span, "i" instant,
#         "s"/"f" flow start/finish, "b"/"n"/"e" async begin/instant/end
#   id  — flow id (loc, seq) for s/f, async id (int) for b/n/e, else None
#   ts/dur in seconds (perf_counter domain); export converts to µs.


class TraceBuffer:
    """One thread's ring of trace events.  Single writer (the owning
    thread), lock-free append; readers (the exporter) take a snapshot and
    tolerate the benign race of the writer lapping the oldest slots."""

    __slots__ = ("events", "capacity", "idx", "tid", "thread_name", "epoch")

    def __init__(self, capacity: int, tid: int, thread_name: str, epoch: int):
        self.events: List[Optional[tuple]] = [None] * capacity
        self.capacity = capacity
        self.idx = 0  # monotone write cursor; slot = idx % capacity
        self.tid = tid
        self.thread_name = thread_name
        self.epoch = epoch

    def append(self, ev: tuple) -> None:
        i = self.idx
        self.events[i % self.capacity] = ev
        self.idx = i + 1

    def snapshot(self) -> Tuple[List[tuple], int]:
        """(events oldest-first, dropped-count).  Safe from any thread."""
        n = self.idx
        if n <= self.capacity:
            evs = self.events[:n]
        else:
            k = n % self.capacity
            evs = self.events[k:] + self.events[:k]
        return [e for e in evs if e is not None], max(0, n - self.capacity)


def _buf() -> TraceBuffer:
    b = getattr(_tls, "buf", None)
    if b is None or b.epoch != _epoch or b.capacity != _capacity:
        t = threading.current_thread()
        b = TraceBuffer(_capacity, t.ident or 0, t.name, _epoch)
        with _lock:
            _buffers.append(b)
        _tls.buf = b
    return b


def _detect_locality() -> int:
    try:
        from repro_torch.core import agas as _agas

        a = _agas.peek()
        return a.locality if a is not None else _agas._default_locality
    except Exception:  # pragma: no cover - agas import failure
        return 0


# ------------------------------------------------------------------ control
def recorded_events() -> int:
    """Events currently resident across every thread's ring."""
    with _lock:
        bufs = list(_buffers)
    return sum(min(b.idx, b.capacity) for b in bufs)


def dropped_events() -> int:
    """Events overwritten by ring wraparound (lost to the exporter)."""
    with _lock:
        bufs = list(_buffers)
    return sum(max(0, b.idx - b.capacity) for b in bufs)


def _register_counters(locality: int) -> None:
    """Publish ring occupancy/drop gauges so lossiness is visible *live*
    (before any export) — ``/obs{locality#L}/trace/{events,dropped}``."""
    try:
        from repro_torch.core import counters as _counters

        reg = _counters.default()
        prefix = f"/obs{{locality#{locality}}}/trace"
        reg.register_callable(f"{prefix}/events", recorded_events)
        reg.register_callable(f"{prefix}/dropped", dropped_events)
    except Exception:  # pragma: no cover - counters tier not initialised
        pass


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Turn the recorder on (idempotent).  ``capacity`` is per thread."""
    global _enabled, _capacity, _locality
    with _lock:
        _capacity = int(capacity)
    _locality = _detect_locality()
    _register_counters(_locality)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop every recorded event (buffers re-register lazily)."""
    global _epoch
    with _lock:
        _epoch += 1
        _buffers.clear()


def new_id() -> Tuple[int, int]:
    """Allocate a globally-unique span/flow id: (locality, seq)."""
    return (_locality, next(_seq))


def current_context() -> Optional[Tuple[int, int]]:
    """The innermost open span's id on this thread (the trace context a
    parcel carries in its header), or None outside any span."""
    return getattr(_tls, "ctx", None)


class with_context:
    """Install a foreign trace context (the receiver side of propagation):
    spans opened inside become children of the remote parent."""

    __slots__ = ("ctx", "prev")

    def __init__(self, ctx: Optional[Tuple[int, int]]):
        self.ctx = tuple(ctx) if ctx is not None else None

    def __enter__(self) -> "with_context":
        self.prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self

    def __exit__(self, *exc) -> bool:
        _tls.ctx = self.prev
        return False


# ---------------------------------------------------------------- recording
class _Span:
    __slots__ = ("name", "cat", "args", "flow_in", "flow_out",
                 "t0", "t1", "sid", "prev", "cpu", "c0")

    def __init__(self, name, cat, flow_in, flow_out, args, cpu=False):
        self.name = name
        self.cat = cat
        self.flow_in = flow_in
        self.flow_out = flow_out
        self.args = args
        self.cpu = cpu

    def set(self, **args: Any) -> None:
        """Add arguments known only once the span's work has run; they are
        recorded at its exit."""
        self.args = {**(self.args or {}), **args}

    def __enter__(self) -> "_Span":
        self.prev = getattr(_tls, "ctx", None)
        self.sid = new_id()
        _tls.ctx = self.sid
        self.t0 = time.perf_counter()
        if self.cpu:  # inside the wall interval, so cpu_s never exceeds it
            self.c0 = time.thread_time()
        # flow markers share the span's start timestamp so they bind to
        # this slice in Perfetto (binding point "enclosing slice")
        if self.flow_in is not None:
            _buf().append(("f", self.name, self.cat, self.t0, 0.0,
                           tuple(self.flow_in), None))
        if self.flow_out is not None:
            _buf().append(("s", self.name, self.cat, self.t0, 0.0,
                           tuple(self.flow_out), None))
        return self

    def __exit__(self, *exc) -> bool:
        cpu_s = time.thread_time() - self.c0 if self.cpu else None
        self.t1 = t1 = time.perf_counter()
        _tls.ctx = self.prev
        if _enabled:  # disabled mid-span: drop silently
            args = self.args
            if self.prev is not None or cpu_s is not None:
                args = dict(args) if args else {}
            if self.prev is not None:
                args["parent"] = f"{self.prev[0]}:{self.prev[1]}"
            if cpu_s is not None:
                args["cpu_s"] = cpu_s
            _buf().append(("X", self.name, self.cat, self.t0, t1 - self.t0,
                           self.sid, args))
        return False


class _NullSpan:
    """Shared no-op returned while disabled: __enter__/__exit__ do nothing,
    ``set`` drops its arguments, and its bounds read 0."""

    __slots__ = ()
    sid = None
    t0 = t1 = 0.0

    def set(self, **args: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, cat: str = "task",
         flow_in: Optional[Tuple[int, int]] = None,
         flow_out: Optional[Tuple[int, int]] = None, *, cpu: bool = False,
         **args: Any):
    """Context manager recording one complete span (Chrome ``"X"``).

    ``flow_in``/``flow_out`` additionally record a flow finish/start bound
    to this span — the cross-locality arrow.  ``cpu=True`` also records
    ``args["cpu_s"]``, the thread's CPU time inside the span
    (``time.thread_time``): its wall time less ``cpu_s`` is the time the
    thread spent off the CPU, waiting for the interpreter's lock or
    blocked in a system call.  The span's bounds (``t0``, ``t1``) stay
    readable after its exit.  Disabled → shared no-op."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, flow_in, flow_out, args or None, cpu)


def instant(name: str, cat: str = "task", **args: Any) -> None:
    """Zero-duration marker (steals, wire receipts)."""
    if not _enabled:
        return
    _buf().append(("i", name, cat, time.perf_counter(), 0.0, None,
                   args or None))


def complete(name: str, cat: str, t0: float,
             flow_out: Optional[Tuple[int, int]] = None, **args: Any) -> None:
    """Record a span from a caller-held start time (for sites where a
    context manager would obscure control flow, e.g. the send pump)."""
    if not _enabled:
        return
    t1 = time.perf_counter()
    b = _buf()
    if flow_out is not None:
        b.append(("s", name, cat, t0, 0.0, tuple(flow_out), None))
    b.append(("X", name, cat, t0, t1 - t0, None, args or None))


def async_begin(name: str, aid: int, cat: str = "serve", **args: Any) -> None:
    """Open a per-object async span (e.g. one serving request's lifetime:
    admission → ... → finish).  ``aid`` must be unique per (cat, locality)."""
    if not _enabled:
        return
    _buf().append(("b", name, cat, time.perf_counter(), 0.0, int(aid),
                   args or None))


def async_instant(name: str, aid: int, cat: str = "serve", **args: Any) -> None:
    if not _enabled:
        return
    _buf().append(("n", name, cat, time.perf_counter(), 0.0, int(aid),
                   args or None))


def async_end(name: str, aid: int, cat: str = "serve", **args: Any) -> None:
    if not _enabled:
        return
    _buf().append(("e", name, cat, time.perf_counter(), 0.0, int(aid),
                   args or None))


# ------------------------------------------------------------------- drain
def export_buffers() -> List[Dict[str, Any]]:
    """Snapshot every thread's ring: a list of
    ``{"tid", "thread_name", "dropped", "events"}`` dicts (events are the
    raw tuples — :mod:`repro_torch.obs.export` converts to Chrome form).  The
    payload is picklable, so it travels over the parcelport as-is."""
    with _lock:
        bufs = list(_buffers)
    out = []
    for b in bufs:
        events, dropped = b.snapshot()
        out.append({"tid": b.tid, "thread_name": b.thread_name,
                    "dropped": dropped, "events": events})
    return out


def events() -> List[tuple]:
    """Flat, time-ordered view of every recorded event (test helper)."""
    evs: List[tuple] = []
    for b in export_buffers():
        evs.extend(b["events"])
    evs.sort(key=lambda e: e[3])
    return evs
