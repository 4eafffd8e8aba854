"""Aggregate SLOW-blame reporting over merged traces, ported from the
reference's ``obs/attribution.py``.

:mod:`repro_torch.obs.critical_path` answers "why was *this* request slow";
this module folds every request's tiled timeline into the fleet view:

- :func:`analyze_requests` — critical paths for every complete request
  in a trace;
- :func:`slow_report` — per-SLO-tier totals, per-class shares and
  latency percentiles, with attribution coverage (min/mean fraction) and
  the trace's lossy flag surfaced — the ``--slow-report`` CLI payload;
- :func:`fold_into_counters` — feed per-request per-class seconds into
  the log-bucketed histogram counters (``/obs{blame/<tier>}/<class>``), so
  p50/p95/p99 *blame* is queryable live through ``query_counters`` /
  the fleet sampler exactly like any other counter — no trace file in
  hand required once the fold has run;
- :func:`diff_reports` — A/B two reports (the ``--diff`` CLI): per-tier
  per-class deltas for "did the optimization move waiting into work?".
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.critical_path import (CLASS_NAMES, SLOW_CLASSES, CriticalPath,
                                     TraceIndex, critical_path, request_ids)

__all__ = ["analyze_requests", "slow_report", "fold_into_counters",
           "diff_reports", "format_report", "format_critical_path",
           "UNTIERED"]

UNTIERED = "untiered"


def analyze_requests(tr: Dict[str, Any],
                     reqs: Optional[List[str]] = None
                     ) -> Dict[str, CriticalPath]:
    """Critical paths for every (or the given) complete request tags."""
    idx = tr if isinstance(tr, TraceIndex) else TraceIndex(tr)
    out: Dict[str, CriticalPath] = {}
    for tag in (reqs if reqs is not None else request_ids(idx)):
        cp = critical_path(idx, tag)
        if cp is not None:
            out[tag] = cp
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


def slow_report(tr: Dict[str, Any],
                cps: Optional[Dict[str, CriticalPath]] = None
                ) -> Dict[str, Any]:
    """Fleet blame report: per SLO tier, where did the wall time go."""
    idx = tr if isinstance(tr, TraceIndex) else TraceIndex(tr)
    cps = analyze_requests(idx) if cps is None else cps
    tiers: Dict[str, List[CriticalPath]] = {}
    for cp in cps.values():
        tiers.setdefault(cp.slo or UNTIERED, []).append(cp)

    # per-locality drop totals ("{pid}/{thread}" keys folded by pid) so a
    # lossy trace's header says *how much* each locality's rings lost
    drops_by_loc: Dict[str, int] = {}
    for key, n in getattr(idx, "ring_drops", {}).items():
        loc = str(key).split("/", 1)[0]
        drops_by_loc[loc] = drops_by_loc.get(loc, 0) + int(n)
    report: Dict[str, Any] = {"requests": len(cps), "lossy": idx.lossy,
                              "ring_drops": drops_by_loc, "tiers": {}}
    for tier, group in sorted(tiers.items()):
        totals = sorted(cp.total_us for cp in group)
        by_class = {CLASS_NAMES[c]: sum(cp.by_class[c] for cp in group)
                    for c in SLOW_CLASSES}
        grand = sum(by_class.values()) or 1.0
        report["tiers"][tier] = {
            "count": len(group),
            "total_us": sum(totals),
            "by_class_us": by_class,
            "shares": {k: v / grand for k, v in by_class.items()},
            "latency_us": {"p50": _percentile(totals, 0.50),
                           "p95": _percentile(totals, 0.95),
                           "p99": _percentile(totals, 0.99)},
            "attributed_fraction": {
                "min": min(cp.fraction for cp in group),
                "mean": sum(cp.fraction for cp in group) / len(group),
            },
            "residual_us": sum(cp.residual_us for cp in group),
            "clamped_count": sum(cp.clamped_count for cp in group),
        }
    return report


def fold_into_counters(cps: Dict[str, CriticalPath], registry=None) -> int:
    """Feed per-request blame into live histogram counters.

    One histogram per (tier, class): ``/obs{blame/<tier>}/<class>`` in
    *seconds*, plus ``.../total`` for end-to-end latency — the same
    log-bucketed histograms the serve timers use, so the fleet sampler
    and ``print_counter_report`` pick up p50/p95/p99 blame with zero new
    plumbing.  Returns how many requests were folded."""
    from repro_torch.core import counters as _counters

    reg = registry if registry is not None else _counters.default()
    for cp in cps.values():
        tier = cp.slo or UNTIERED
        for c in SLOW_CLASSES:
            reg.histogram(f"/obs{{blame/{tier}}}/{CLASS_NAMES[c]}").add(
                cp.by_class[c] * 1e-6)
        reg.histogram(f"/obs{{blame/{tier}}}/total").add(cp.total_us * 1e-6)
    return len(cps)


def diff_reports(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """B minus A, per tier per class (µs and share deltas)."""
    out: Dict[str, Any] = {"tiers": {}}
    for tier in sorted(set(a.get("tiers", {})) | set(b.get("tiers", {}))):
        ta = a.get("tiers", {}).get(tier, {})
        tb = b.get("tiers", {}).get(tier, {})
        classes = sorted(set(ta.get("by_class_us", {}))
                         | set(tb.get("by_class_us", {})))
        out["tiers"][tier] = {
            "count": (tb.get("count", 0) - ta.get("count", 0)),
            "delta_us": {c: (tb.get("by_class_us", {}).get(c, 0.0)
                             - ta.get("by_class_us", {}).get(c, 0.0))
                         for c in classes},
            "delta_share": {c: (tb.get("shares", {}).get(c, 0.0)
                                - ta.get("shares", {}).get(c, 0.0))
                            for c in classes},
            "delta_p99_us": (tb.get("latency_us", {}).get("p99", 0.0)
                             - ta.get("latency_us", {}).get("p99", 0.0)),
        }
    return out


def format_report(report: Dict[str, Any]) -> str:
    """Terminal rendering of :func:`slow_report` output."""
    drops = report.get("ring_drops") or {}
    drop_note = ""
    if report.get("lossy"):
        per_loc = ", ".join(f"L{loc}={n}" for loc, n in sorted(drops.items()))
        drop_note = (f"   [LOSSY TRACE — rings wrapped: dropped {per_loc}]"
                     if per_loc else "   [LOSSY TRACE — rings wrapped]")
    lines = [f"requests analyzed: {report.get('requests', 0)}" + drop_note]
    order = [CLASS_NAMES[c] for c in SLOW_CLASSES]
    for tier, t in sorted(report.get("tiers", {}).items()):
        lat = t.get("latency_us", {})
        frac = t.get("attributed_fraction", {})
        lines.append(
            f"\n[{tier}]  n={t['count']}  "
            f"p50={lat.get('p50', 0.0) / 1e3:.1f}ms  "
            f"p95={lat.get('p95', 0.0) / 1e3:.1f}ms  "
            f"p99={lat.get('p99', 0.0) / 1e3:.1f}ms  "
            f"attributed≥{frac.get('min', 0.0) * 100:.1f}%")
        for cname in order:
            us = t["by_class_us"].get(cname, 0.0)
            share = t["shares"].get(cname, 0.0)
            bar = "#" * int(share * 40)
            lines.append(f"  {cname:<10} {us / 1e3:>10.2f}ms "
                         f"{share * 100:>5.1f}%  {bar}")
        if t.get("clamped_count"):
            lines.append(f"  (clock clamps: {t['clamped_count']}, "
                         f"residual {t['residual_us'] / 1e3:.2f}ms)")
    return "\n".join(lines)


def format_critical_path(cp) -> str:
    """Terminal rendering of one request's tiled timeline."""
    s = cp.summary()
    lines = [f"request {cp.req}  (tier: {cp.slo or UNTIERED})  "
             f"total {cp.total_us / 1e3:.2f}ms  "
             f"attributed {cp.fraction * 100:.1f}%  "
             f"localities {s['localities']}"]
    for iv in cp.intervals:
        dur = iv.t1 - iv.t0
        lines.append(f"  {iv.t0 - cp.t0:>10.0f}us  "
                     f"{CLASS_NAMES[iv.cls]:<10} {dur:>10.0f}us  "
                     f"L{iv.pid}  {iv.what}")
    if cp.clamped_count:
        lines.append(f"  clock clamps: {cp.clamped_count} "
                     f"({cp.clamped_us:.0f}us)")
    by = s["by_class_us"]
    lines.append("  -- " + "  ".join(
        f"{k}={v / 1e3:.2f}ms" for k, v in by.items() if v > 0))
    return "\n".join(lines)
