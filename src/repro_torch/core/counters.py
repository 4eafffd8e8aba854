"""APEX-style performance-counter framework (HPX §2.4).

HPX exposes *intrinsic* performance counters under hierarchical symbolic
names such as ``/threads{locality#0/total}/count/cumulative``; counters are
registered with AGAS so they are readable from any locality, and they feed
runtime-adaptivity decisions.

This module is the PyTorch port's copy: counters sample host-side runtime
metrics (task counts, steals, queue depths, step latencies, kernel
launches) published by the runtime and the serving stack.  They are registered into :mod:`repro_torch.core.agas` under their
symbolic name so they resolve exactly like any other global object.

Counter kinds
-------------
- ``Counter``        monotonically increasing value (``.../cumulative``)
- ``Gauge``          instantaneous value (``.../instantaneous``)
- ``TimerCounter``   accumulates durations; exposes count/total/mean/max
- ``Histogram``      log-bucketed distribution; exposes p50/p95/p99
- callable counters  lazily evaluated on read (e.g. queue length probes)

Every counter created through the default registry — whether via
``register`` or the ``counter()/gauge()/timer()/histogram()`` get-or-create
helpers — is published into AGAS under ``/counters<name>``, so
``net.query_counters`` resolves all of them, not just the explicitly
registered few.
"""

from __future__ import annotations

import fnmatch
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

_log = logging.getLogger(__name__)


class Counter:
    """Monotonic cumulative counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, initial: float = 0.0):
        self.name = name
        self._value = initial
        self._lock = threading.Lock()

    def increment(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    # HPX counters are read through a uniform ``get_value`` interface.
    def get_value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Instantaneous value counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, initial: float = 0.0):
        self.name = name
        self._value = initial
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def get_value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        self.set(0.0)


class Histogram:
    """Log-bucketed distribution counter: p50/p95/p99 at O(1) per sample.

    Positive samples land in bucket ``floor(log(v) / log(growth))`` —
    geometric buckets, so the quantile estimate (the bucket's geometric
    midpoint, clamped to the observed [min, max]) carries a bounded
    *relative* error of ``growth**0.5`` (≈4% at the default growth 1.08)
    across the full dynamic range, from microseconds to minutes.  This is
    the same trick HDR-style histograms and APEX task timers use.  Samples
    ``<= 0`` are counted in a separate underflow bucket.
    """

    __slots__ = ("name", "growth", "_log_growth", "_buckets", "_zero",
                 "count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, growth: float = 1.08):
        if growth <= 1.0:
            raise ValueError(f"histogram growth must be > 1, got {growth}")
        self.name = name
        self.growth = growth
        self._log_growth = math.log(growth)
        self._buckets: Dict[int, int] = {}
        self._zero = 0  # samples <= 0 (log-bucketing needs positives)
        self.count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if v <= 0.0:
                self._zero += 1
            else:
                idx = int(math.floor(math.log(v) / self._log_growth))
                self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        q = min(1.0, max(0.0, q))
        # nearest-rank at 0-based index floor(q*(n-1)) — matches a sorted
        # array oracle, which is what the property test checks against
        target = int(math.floor(q * (self.count - 1))) + 1
        cum = self._zero
        if cum >= target:
            return self._min if self._min < 0.0 else 0.0
        for idx in sorted(self._buckets):
            cum += self._buckets[idx]
            if cum >= target:
                mid = math.exp((idx + 0.5) * self._log_growth)
                return min(max(mid, self._min), self._max)
        return self._max  # pragma: no cover - counts always sum to count

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def percentiles(self) -> Dict[str, float]:
        with self._lock:
            return {"p50": self._quantile_locked(0.50),
                    "p95": self._quantile_locked(0.95),
                    "p99": self._quantile_locked(0.99)}

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "count": float(self.count),
                "mean": self._sum / self.count if self.count else 0.0,
                "min": self._min if self.count else 0.0,
                "max": self._max if self.count else 0.0,
                "p50": self._quantile_locked(0.50),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
            }

    def get_value(self) -> float:  # median, for the uniform interface
        return self.quantile(0.5)

    def _buckets_locked(self) -> List[Tuple[float, int]]:
        out: List[Tuple[float, int]] = []
        if self._zero:
            out.append((0.0, self._zero))
        for idx in sorted(self._buckets):
            out.append((math.exp((idx + 1) * self._log_growth),
                        self._buckets[idx]))
        return out

    def buckets(self) -> List[Tuple[float, int]]:
        """Occupied buckets as ``[(upper_bound, count), ...]`` ascending —
        the raw material for a native Prometheus histogram.  Bucket ``idx``
        holds samples in ``[growth**idx, growth**(idx+1))`` so its upper
        bound is ``growth**(idx+1)``; samples ``<= 0`` surface as an
        explicit leading ``(0.0, n)`` bucket."""
        with self._lock:
            return self._buckets_locked()

    def export(self) -> Dict[str, Any]:
        """Typed export record (kind + raw buckets + sum/count) — what the
        OpenMetrics exposition tier ships over the wire, since
        ``snapshot_stats`` collapses the distribution to quantiles.  One
        lock hold: bucket counts always sum to ``count`` (the +Inf bucket
        of the rendered histogram must equal ``_count`` exactly)."""
        with self._lock:
            return {"kind": "histogram", "sum": self._sum, "count": self.count,
                    "buckets": self._buckets_locked()}

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._zero = 0
            self.count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf


class TimerCounter:
    """Duration accumulator: count/total/mean/max, with EMA for adaptivity.

    The exponentially-weighted mean is what the straggler detector and the
    auto-tuner consume (cheap, windowless).  With ``percentiles=True`` the
    timer additionally feeds a :class:`Histogram`, so ``stats()`` reports
    p50/p95/p99 — the serve-engine latency timers use this to answer "why
    is p99 bad" without a trace.
    """

    __slots__ = ("name", "count", "total", "max", "ema", "ema_alpha",
                 "_hist", "_lock")

    def __init__(self, name: str, ema_alpha: float = 0.2,
                 percentiles: bool = False):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.ema: Optional[float] = None
        self.ema_alpha = ema_alpha
        self._hist = Histogram(name) if percentiles else None
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            self.max = max(self.max, seconds)
            self.ema = (
                seconds
                if self.ema is None
                else self.ema_alpha * seconds + (1.0 - self.ema_alpha) * self.ema
            )
        if self._hist is not None:  # histogram has its own lock
            self._hist.add(seconds)

    def time(self):
        """Context manager measuring a block."""
        return _TimerCtx(self)

    def enable_percentiles(self) -> None:
        """Attach a histogram to an already-created timer (idempotent)."""
        with self._lock:
            if self._hist is None:
                self._hist = Histogram(self.name)

    def quantile(self, q: float) -> float:
        """Histogram quantile in seconds (0.0 without percentiles=True) —
        the live p99 the flight-recorder trigger polls."""
        h = self._hist
        return h.quantile(q) if h is not None else 0.0

    def get_value(self) -> float:  # mean, for the uniform interface
        with self._lock:
            return self.total / self.count if self.count else 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            mean = self.total / self.count if self.count else 0.0
            out = {
                "count": float(self.count),
                "total": self.total,
                "mean": mean,
                "max": self.max,
                "ema": self.ema if self.ema is not None else 0.0,
            }
        if self._hist is not None:
            out.update(self._hist.percentiles())
        return out

    def export(self) -> Dict[str, Any]:
        """Typed export record: with ``percentiles=True`` the attached
        histogram's raw buckets ride along (rendered as a native Prometheus
        histogram in seconds); without, count/total still expose the
        ``_count``/``_sum`` pair."""
        h = self._hist
        if h is not None:
            rec = h.export()
            rec["kind"] = "timer"
            return rec
        with self._lock:
            return {"kind": "timer", "sum": self.total,
                    "count": self.count, "buckets": None}

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.max = 0.0
            self.ema = None
        if self._hist is not None:
            self._hist.reset()


class _TimerCtx:
    __slots__ = ("timer", "t0")

    def __init__(self, timer: TimerCounter):
        self.timer = timer

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.add(time.perf_counter() - self.t0)
        return False


@dataclass
class CounterRegistry:
    """Registry of hierarchically-named counters (the APEX analogue).

    Names follow the HPX convention ``/object{instance}/metric``, e.g.::

        /scheduler{default}/tasks/executed
        /scheduler{io}/tasks/stolen
        /agas{root}/objects/count
        /train{step}/duration
        /parcel{port#0}/bytes/sent
    """

    _counters: Dict[str, Any] = field(default_factory=dict)
    _lock: threading.RLock = field(default_factory=threading.RLock)

    def _publish(self, name: str, counter: Any) -> None:
        """Mirror a counter into AGAS under ``/counters<name>`` — the ONE
        registration path every creation route funnels through, so anything
        in the registry resolves via ``net.query_counters`` name lookup.

        Must be called OUTSIDE ``self._lock``: AGAS construction creates its
        own gauges through this registry, so publishing while holding the
        registry lock inverts the lock order against ``agas.default()``.
        Bare registries (unit tests) stay out of the global namespace.
        """
        if self is not _default:
            return
        from repro_torch.core import agas as _agas

        inst = _agas.peek()
        if inst is None:
            # The one expected miss: AGAS not constructed yet (or mid-
            # construction on this very thread).  agas.default() runs a
            # republish sweep right after construction, so nothing is lost.
            return
        try:
            inst.register_name(f"/counters{name}", counter, replace=True)
        except Exception:
            _log.exception("failed to publish counter %r into AGAS", name)

    def register(self, counter: Any, name: Optional[str] = None) -> Any:
        name = name or counter.name
        with self._lock:
            self._counters[name] = counter
        self._publish(name, counter)
        return counter

    def _get_or_create(self, name: str, factory: Callable[[str], Any]) -> Any:
        created = None
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = created = factory(name)
                self._counters[name] = c
        if created is not None:
            self._publish(name, created)
        return c

    def counter(self, name: str) -> Counter:
        """Get-or-create a cumulative counter."""
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def timer(self, name: str, percentiles: bool = False) -> TimerCounter:
        t = self._get_or_create(
            name, lambda n: TimerCounter(n, percentiles=percentiles))
        if percentiles and isinstance(t, TimerCounter):
            t.enable_percentiles()  # upgrade a pre-existing plain timer
        return t

    def histogram(self, name: str, growth: float = 1.08) -> Histogram:
        return self._get_or_create(name, lambda n: Histogram(n, growth=growth))

    def register_callable(self, name: str, fn: Callable[[], float],
                          kind: str = "gauge") -> None:
        """Lazily-evaluated counter (e.g. instantaneous queue length).

        ``kind`` declares the exposition semantics: ``"gauge"`` (default,
        may go up or down) or ``"counter"`` (monotonic — e.g. the
        scheduler's cumulative busy/idle time, computed on read)."""
        c = _CallableCounter(name, fn, kind=kind)
        with self._lock:
            self._counters[name] = c
        self._publish(name, c)

    def get(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._counters.get(name)

    def get_value(self, name: str) -> float:
        c = self.get(name)
        if c is None:
            raise KeyError(f"no such performance counter: {name}")
        return c.get_value()

    def query(self, pattern: str) -> List[Tuple[str, float]]:
        """Glob query, HPX ``--hpx:print-counter`` style: ``/scheduler*``.

        The ``(name, counter)`` pairs are copied under the lock, then
        evaluated outside it: ``get_value`` may run a callable counter that
        takes other locks or registers further counters (pump threads do),
        so evaluating while holding the registry lock would deadlock or
        die with "dict changed size during iteration"."""
        with self._lock:
            items = [(n, self._counters[n]) for n in sorted(self._counters)
                     if fnmatch.fnmatch(n, pattern)]
        return [(n, c.get_value()) for n, c in items]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._counters)

    def reset_all(self) -> None:
        with self._lock:
            for c in self._counters.values():
                if hasattr(c, "reset"):
                    c.reset()

    def snapshot(self, pattern: str = "*") -> Dict[str, float]:
        """Consistent point-in-time copy: membership is fixed under the
        lock, values are read outside it (see :meth:`query` for why).  This
        is also the payload of the remote-snapshot action — a locality's
        counters are read across the parcelport via
        ``repro_torch.net.query_counters``."""
        return dict(self.query(pattern))

    def snapshot_stats(self, pattern: str = "*") -> Dict[str, Dict[str, float]]:
        """Like :meth:`snapshot` but keeps full per-counter statistics:
        timers/histograms contribute mean/max/p50/p95/p99, scalar kinds a
        single ``{"value": v}``.  Payload of ``net.query_counter_stats`` and
        the ``--print-counters`` end-of-run report."""
        with self._lock:
            items = [(n, self._counters[n]) for n in sorted(self._counters)
                     if fnmatch.fnmatch(n, pattern)]
        out: Dict[str, Dict[str, float]] = {}
        for n, c in items:
            stats = c.stats() if hasattr(c, "stats") else None
            out[n] = stats if stats is not None else {"value": c.get_value()}
        return out

    def snapshot_export(self, pattern: str = "*") -> Dict[str, Dict[str, Any]]:
        """Typed export records for every matching counter — the payload of
        ``net.query_counter_export`` and the ``/metrics`` endpoint.  Unlike
        :meth:`snapshot_stats` this keeps histogram *buckets* (native
        Prometheus rendering needs them) and each counter's kind.
        Membership is fixed under the lock, values read outside it (see
        :meth:`query`); a counter whose read raises contributes an
        ``{"kind": "error"}`` record instead of killing the scrape."""
        with self._lock:
            items = [(n, self._counters[n]) for n in sorted(self._counters)
                     if fnmatch.fnmatch(n, pattern)]
        out: Dict[str, Dict[str, Any]] = {}
        for n, c in items:
            try:
                out[n] = export_record(c)
            except Exception as e:  # noqa: BLE001 — probe racing teardown
                out[n] = {"kind": "error", "error": repr(e)}
        return out

    def republish_to_agas(self) -> int:
        """Publish every registered counter into AGAS (idempotent rebinds).

        ``agas.default()`` calls this right after constructing the instance:
        counters created before AGAS existed (the scheduler's, typically)
        become resolvable the moment the resolver is up."""
        with self._lock:
            items = list(self._counters.items())
        for n, c in items:
            self._publish(n, c)
        return len(items)


class _CallableCounter:
    __slots__ = ("name", "_fn", "kind")

    def __init__(self, name: str, fn: Callable[[], float],
                 kind: str = "gauge"):
        self.name = name
        self._fn = fn
        self.kind = kind

    def get_value(self) -> float:
        return float(self._fn())

    def reset(self) -> None:
        pass


def export_record(c: Any) -> Dict[str, Any]:
    """One counter -> a typed, wire-friendly export record.

    ``kind`` drives the OpenMetrics rendering: ``counter`` (monotonic,
    ``_total`` suffix), ``gauge``, ``histogram``/``timer`` (native
    Prometheus histogram from the log buckets).  Callable counters carry
    their declared kind; reading one may raise (a probe racing teardown),
    which the caller maps to an error record rather than dropping the
    whole sweep."""
    if isinstance(c, (Histogram, TimerCounter)):
        return c.export()
    if isinstance(c, Counter):
        return {"kind": "counter", "value": c.get_value()}
    if isinstance(c, _CallableCounter):
        return {"kind": c.kind, "value": c.get_value()}
    return {"kind": "gauge", "value": c.get_value()}


_default: Optional[CounterRegistry] = None
_default_lock = threading.Lock()


def default() -> CounterRegistry:
    """Process-wide registry (lives across runtime init/finalize)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = CounterRegistry()
        return _default


def counter(name: str) -> Counter:
    return default().counter(name)


def gauge(name: str) -> Gauge:
    return default().gauge(name)


def timer(name: str, percentiles: bool = False) -> TimerCounter:
    return default().timer(name, percentiles=percentiles)


def histogram(name: str, growth: float = 1.08) -> Histogram:
    return default().histogram(name, growth=growth)


def query(pattern: str) -> List[Tuple[str, float]]:
    return default().query(pattern)


def get_value(name: str) -> float:
    return default().get_value(name)
