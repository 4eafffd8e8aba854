"""Persisted counter timelines — every run leaves a queryable record.
Ported from the reference's ``obs/timeseries.py`` (standard library only).

The sampler's rings answer "what happened in the last four minutes"; this
module answers "what happened during *that run last Tuesday*".  A
:class:`TimelineWriter` attached to a :class:`repro_torch.obs.sampler.
FleetSampler` appends one JSONL record per sweep:

    {"kind": "header", "version": 1, "pattern": "*", ...}     # line 1
    {"t": 12.03, "wall": 1754650000.1, "stride": 1,
     "sweep": {"0": {"/scheduler{default}/idle-rate": 0.12, ...}},
     "errors": []}                                            # per sweep

**Bounded by stride-doubling downsample** — the file can never grow
without limit: when the retained record count would exceed
``max_records`` the writer drops every second retained record, doubles
its sampling stride (record every 2nd sweep, then every 4th, ...), and
atomically rewrites the file.  A week-long serve run converges to ≤
``max_records`` records at coarser-and-coarser resolution instead of an
unbounded log — same trick trace rings use for time, applied to disk.

Readers: :func:`read_timeline` / :func:`series` for plotting,
:func:`summarize` for the ``repro_torch.obs.analyze --timeline`` report
(per-counter stats plus *derived* per-pool utilization from the
``time/busy`` / ``time/idle`` cumulative counters — the windowed form of
idle-rate that survives restarts).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

VERSION = 1


class TimelineWriter:
    """Append-only JSONL counter timeline with stride-doubling bound.

    ``append(sweep)`` takes the same shape ``FleetSampler.sample_once``
    works from: ``{locality: [(name, value), ...]}`` with dead peers as
    ``{"error": ...}`` markers (recorded in the ``errors`` list — an
    unreachable peer is part of the run's history too).
    """

    def __init__(self, path: str, pattern: str = "*",
                 interval: Optional[float] = None,
                 max_records: int = 4096,
                 meta: Optional[Dict[str, Any]] = None):
        if max_records < 2:
            raise ValueError("max_records must be >= 2")
        self.path = path
        self.max_records = max_records
        self.stride = 1
        self._seen = 0          # sweeps offered
        self.records_written = 0
        self.compactions = 0
        self._records: List[Dict[str, Any]] = []  # retained (== file body)
        self._header = {"kind": "header", "version": VERSION,
                        "pattern": pattern, "interval": interval,
                        "started_wall": time.time(),
                        "max_records": max_records}
        if meta:
            self._header["meta"] = dict(meta)
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "w", encoding="utf-8")
        self._fh.write(json.dumps(self._header) + "\n")
        self._fh.flush()

    def append(self, sweep: Dict[int, Any],
               now: Optional[float] = None) -> bool:
        """Offer one sweep; returns True if it was recorded (stride may
        skip it)."""
        if self._fh is None:
            raise ValueError("timeline writer is closed")
        self._seen += 1
        if (self._seen - 1) % self.stride != 0:
            return False
        values: Dict[str, Dict[str, float]] = {}
        errors: List[int] = []
        for loc, pairs in sweep.items():
            if isinstance(pairs, dict):      # {"error": ...} marker
                errors.append(int(loc))
                continue
            values[str(loc)] = {name: float(v) for name, v in pairs}
        rec = {"t": now if now is not None else time.perf_counter(),
               "wall": time.time(), "stride": self.stride,
               "sweep": values, "errors": sorted(errors)}
        self._records.append(rec)
        if len(self._records) > self.max_records:
            self._compact()
        else:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        self.records_written += 1
        return True

    def _compact(self) -> None:
        """Halve resolution: keep every 2nd retained record (newest
        kept), double the stride, rewrite the file atomically."""
        self._records = self._records[1::2]
        self.stride *= 2
        self.compactions += 1
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(self._header) + "\n")
            for rec in self._records:
                fh.write(json.dumps(rec) + "\n")
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()

    def __enter__(self) -> "TimelineWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ readers
def read_timeline(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Load ``(header, records)``; raises on a file that isn't a
    timeline (wrong header) so the analyzer fails loudly, not weirdly."""
    header: Optional[Dict[str, Any]] = None
    records: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if header is None:
                if obj.get("kind") != "header":
                    raise ValueError(f"{path}: not a timeline (no header)")
                if obj.get("version") != VERSION:
                    raise ValueError(f"{path}: timeline version "
                                     f"{obj.get('version')} != {VERSION}")
                header = obj
            else:
                records.append(obj)
    if header is None:
        raise ValueError(f"{path}: empty file")
    return header, records


def series(records: List[Dict[str, Any]], locality: int,
           name: str) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    key = str(locality)
    for rec in records:
        vals = rec.get("sweep", {}).get(key)
        if vals is not None and name in vals:
            out.append((rec["t"], vals[name]))
    return out


def _rate(points: List[Tuple[float, float]]) -> float:
    """Positive-delta rate over the whole series (reset-tolerant, same
    contract as ``FleetSampler.rate``)."""
    if len(points) < 2:
        return 0.0
    span = points[-1][0] - points[0][0]
    if span <= 0.0:
        return 0.0
    total = 0.0
    for (_, v0), (_, v1) in zip(points, points[1:]):
        d = v1 - v0
        total += d if d >= 0.0 else v1
    return total / span


_POOL_TIME_RE = re.compile(r"^/scheduler\{(?P<pool>[^}]*)\}/time/(busy|idle)$")


def summarize(path: str) -> Dict[str, Any]:
    """Digest a timeline: per-(locality, counter) stats plus derived
    per-pool utilization/idle-rate from the cumulative busy/idle clocks."""
    header, records = read_timeline(path)
    counters: Dict[Tuple[int, str], Dict[str, float]] = {}
    keys: set = set()
    error_sweeps = 0
    for rec in records:
        if rec.get("errors"):
            error_sweeps += 1
        for loc_s, vals in rec.get("sweep", {}).items():
            for name in vals:
                keys.add((int(loc_s), name))
    for loc, name in sorted(keys):
        pts = series(records, loc, name)
        vs = [v for _, v in pts]
        counters[(loc, name)] = {
            "n": len(pts), "first": vs[0], "last": vs[-1],
            "min": min(vs), "max": max(vs),
            "mean": sum(vs) / len(vs), "rate": _rate(pts),
        }
    # derived windowed utilization per (locality, pool): the ratio of the
    # busy-clock rate to total-clock rate over the recorded span
    derived: Dict[Tuple[int, str], Dict[str, float]] = {}
    for (loc, name), st in counters.items():
        m = _POOL_TIME_RE.match(name)
        if not m or not name.endswith("/busy"):
            continue
        pool = m.group("pool")
        idle = counters.get((loc, f"/scheduler{{{pool}}}/time/idle"))
        if idle is None:
            continue
        busy_d = st["last"] - st["first"]
        idle_d = idle["last"] - idle["first"]
        total = busy_d + idle_d
        if total <= 0.0:
            continue
        derived[(loc, pool)] = {"utilization": busy_d / total,
                                "idle_rate": idle_d / total,
                                "busy_s": busy_d, "idle_s": idle_d}
    span = (records[-1]["t"] - records[0]["t"]) if len(records) > 1 else 0.0
    return {"header": header, "records": len(records), "span_s": span,
            "final_stride": records[-1]["stride"] if records else 1,
            "error_sweeps": error_sweeps,
            "counters": counters, "utilization": derived}


def format_summary(summary: Dict[str, Any]) -> List[str]:
    """Human lines for ``repro_torch.obs.analyze --timeline``."""
    hdr = summary["header"]
    lines = [f"timeline: pattern={hdr.get('pattern')!r} "
             f"records={summary['records']} span={summary['span_s']:.1f}s "
             f"stride={summary['final_stride']} "
             f"error_sweeps={summary['error_sweeps']}"]
    if summary["utilization"]:
        lines.append(f"{'pool utilization':<34} {'util':>8} {'idle':>8} "
                     f"{'busy_s':>10} {'idle_s':>10}")
        for (loc, pool), d in sorted(summary["utilization"].items()):
            lines.append(f"L{loc} scheduler{{{pool}}}"[:34].ljust(34) + " "
                         f"{d['utilization']:>8.1%} {d['idle_rate']:>8.1%} "
                         f"{d['busy_s']:>10.2f} {d['idle_s']:>10.2f}")
    lines.append(f"{'counter':<58} {'n':>5} {'last':>12} {'mean':>12} "
                 f"{'rate/s':>10}")
    for (loc, name), st in sorted(summary["counters"].items()):
        lines.append(f"L{loc} {name:<55.55}"[:58].ljust(58) + " "
                     f"{st['n']:>5d} {st['last']:>12.4g} "
                     f"{st['mean']:>12.4g} {st['rate']:>10.4g}")
    return lines
