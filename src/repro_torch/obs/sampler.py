"""Fleet counter sampler — scalar counters become time series, ported from
the reference's ``obs/sampler.py``.

The paper's §2.4 adaptivity story needs *history*: a cumulative counter
read once says "1.2M tasks executed", read on a cadence it says "tasks/s,
and it dipped 40% when locality 2 started migrating".  The sampler runs on
locality 0, snapshots every locality's counters over the parcelport
(``net.query_counters`` — the same AGAS-published names the rest of the
runtime uses), and keeps a fixed-depth ring of ``(t, value)`` points per
``(locality, counter)``:

- ``rate(loc, name)`` — positive-delta rate over the retained window.
  Counter *resets* (process restart, ``reset_all``) appear as negative
  deltas; those samples contribute the post-reset value instead of being
  summed as a huge negative, so rates stay truthful across restarts.
- ``series(loc, name)`` — the raw retained points, for plotting.

The loop is a daemon thread (in-process observer, not a transport — the
parcelport does the remote reads), started with :meth:`FleetSampler.start`
and stopped either explicitly or by garbage collection of the runtime.
``sample_once()`` is public so tests and the ``--print-counters`` report
can drive sampling synchronously without a thread.
"""

from __future__ import annotations

import collections
import fnmatch
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.core import counters as _counters


class FleetSampler:
    """Periodic counter snapshots across all localities, bounded history."""

    def __init__(self, pattern: str = "*", interval: float = 1.0,
                 depth: int = 240, net=None,
                 registry: Optional[_counters.CounterRegistry] = None,
                 timeline=None):
        self.pattern = pattern
        self.interval = interval
        self.depth = depth
        self.net = net
        self.registry = registry or _counters.default()
        # optional repro_torch.obs.timeseries.TimelineWriter — every sweep this
        # sampler takes is also offered to the on-disk timeline
        self.timeline = timeline
        # (locality, counter name) → ring of (perf_counter, value)
        self._histories: Dict[Tuple[int, str],
                              Deque[Tuple[float, float]]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0
        self.sample_errors = 0

    # ------------------------------------------------------------ sampling
    def _localities(self) -> List[int]:
        if self.net is None:
            return [0]
        return self.net.live_ids()

    def sample_once(self) -> int:
        """One parallel sweep over every *live* locality; returns points
        recorded.  Rides the fault-tolerant sweep form of
        ``net.query_counters``: a locality dying mid-sweep contributes an
        error marker, not an exception — the flight recorder (and the
        fleet controller driving it) outlives individual crashes, and an
        elastic join shows up as a new locality on the next sweep."""
        now = time.perf_counter()
        points = 0
        if self.net is None:
            sweep: Dict[int, Any] = {0: self.registry.query(self.pattern)}
        else:
            from repro_torch.net import remote as _remote

            sweep = _remote.query_counters(
                None, self.pattern, timeout=max(30.0, self.interval * 4))
        for loc, pairs in sweep.items():
            if isinstance(pairs, dict):  # {"error": ...} — peer went away
                self.sample_errors += 1
                continue
            with self._lock:
                for name, value in pairs:
                    ring = self._histories.get((loc, name))
                    if ring is None:
                        ring = collections.deque(maxlen=self.depth)
                        self._histories[(loc, name)] = ring
                    ring.append((now, float(value)))
                    points += 1
        if self.timeline is not None:
            try:
                self.timeline.append(sweep, now=now)
            except ValueError:  # writer closed mid-run — stop offering
                self.timeline = None
        self.samples_taken += 1
        return points

    # ----------------------------------------------------------- the loop
    def start(self) -> "FleetSampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-obs-sampler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(5.0, self.interval * 2))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.sample_once()

    # ------------------------------------------------------------- queries
    def series(self, locality: int, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            ring = self._histories.get((locality, name))
            return list(ring) if ring else []

    def keys(self) -> List[Tuple[int, str]]:
        with self._lock:
            return sorted(self._histories)

    def latest(self, locality: int, name: str) -> Optional[float]:
        """Most recent sampled value, or ``None`` if never seen — the
        policy layer's gauge read (occupancy, queue depth)."""
        with self._lock:
            ring = self._histories.get((locality, name))
            return ring[-1][1] if ring else None

    def rate(self, locality: int, name: str) -> float:
        """Per-second rate of a cumulative counter over the retained window.

        Sums positive inter-sample deltas; a negative delta means the
        counter was reset between samples, so that interval contributes the
        post-reset value (everything counted since the reset) rather than
        poisoning the sum."""
        pts = self.series(locality, name)
        if len(pts) < 2:
            return 0.0
        span = pts[-1][0] - pts[0][0]
        if span <= 0.0:
            return 0.0
        total = 0.0
        for (_, v0), (_, v1) in zip(pts, pts[1:]):
            d = v1 - v0
            total += d if d >= 0.0 else v1
        return total / span

    def rates(self, pattern: Optional[str] = None) -> Dict[Tuple[int, str], float]:
        pat = pattern or "*"
        return {(loc, name): self.rate(loc, name)
                for loc, name in self.keys()
                if fnmatch.fnmatch(name, pat)}


# ------------------------------------------------------- end-of-run report
def print_counter_report(pattern: str = "*", net=None,
                         sampler: Optional[FleetSampler] = None,
                         file=None) -> List[str]:
    """HPX ``--hpx:print-counter`` parity: dump every matching counter on
    every locality — value, rate (when a sampler retained history), and
    p50/p95/p99 for timers/histograms.  The SLOW blame histograms
    (``/obs{blame/...}``) ride along regardless of ``pattern`` — once an
    analysis folded them, the report shows p50/p95/p99 *blame* next to
    whatever was asked for.  Output is sorted by locality then counter
    path (stable diffs in CI logs).  Returns the printed lines."""
    blame_pat = "/obs{blame/*"
    if net is None:
        sweep = {0: _counters.default().snapshot_stats(pattern)}
        blame = {0: _counters.default().snapshot_stats(blame_pat)}
    else:
        from repro_torch.net import remote as _remote

        # fault-tolerant sweep form: a dead peer contributes an
        # {"error": ...} marker, not an exception — the report says so
        # explicitly instead of silently shrinking the fleet
        sweep = _remote.query_counter_stats(None, pattern)
        blame = _remote.query_counter_stats(None, blame_pat)

    def _unreachable(result) -> bool:
        # counter names always start with "/" so the shapes can't collide
        return ("error" in result
                and not any(k.startswith("/") for k in result))

    lines = [f"{'counter':<58} {'value':>12} {'rate/s':>10} "
             f"{'p50':>9} {'p95':>9} {'p99':>9}"]
    for loc in sorted(sweep):
        stats = sweep[loc]
        if _unreachable(stats):
            lines.append(f"locality#{loc} UNREACHABLE ({stats['error']})")
            continue
        extra = blame.get(loc, {})
        if not _unreachable(extra):
            stats.update(extra)
        for name, st in sorted(stats.items()):
            value = st.get("value", st.get("count", 0.0))
            rate = sampler.rate(loc, name) if sampler is not None else None
            cells = [f"L{loc} {name:<55.55}"[:58].ljust(58),
                     f"{value:>12.4g}",
                     f"{rate:>10.4g}" if rate is not None else f"{'-':>10}"]
            for q in ("p50", "p95", "p99"):
                cells.append(f"{st[q] * 1e3:>8.3g}m" if q in st
                             else f"{'-':>9}")
            lines.append(" ".join(cells))
    for ln in lines:
        print(ln, file=file)
    return lines
