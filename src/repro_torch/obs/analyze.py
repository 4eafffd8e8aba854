"""Trace analysis CLI — ``python -m repro_torch.obs.analyze``, ported from
the reference's ``obs/analyze.py`` with the same flags and exit codes.

Makes merged Chrome traces consumable without a browser:

    # where did the fleet's time go, per SLO tier
    python -m repro_torch.obs.analyze trace.json --slow-report

    # one request's tiled admission->finish timeline
    python -m repro_torch.obs.analyze trace.json --critical-path r0:3

    # list analyzable request tags
    python -m repro_torch.obs.analyze trace.json --requests

    # A/B two traces (did the fix move waiting into work?)
    python -m repro_torch.obs.analyze --diff before.json after.json

    # digest a persisted counter timeline (--timeline from a launcher)
    python -m repro_torch.obs.analyze --timeline serve_timeline.jsonl

``--json`` emits machine-readable output for CI diffing.  Exit status is
non-zero when the requested analysis has nothing to chew on (unknown
request tag, no complete requests) so scripts fail loudly.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

from repro_torch.obs import attribution as _attribution
from repro_torch.obs import critical_path as _cp

__all__ = ["main"]


def _load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.analyze",
        description="Critical-path / SLOW-blame analysis of merged traces")
    ap.add_argument("trace", nargs="?", help="merged Chrome trace JSON")
    ap.add_argument("--critical-path", metavar="REQ",
                    help="print REQ's tiled SLOW timeline")
    ap.add_argument("--slow-report", action="store_true",
                    help="aggregate per-tier blame report")
    ap.add_argument("--requests", action="store_true",
                    help="list analyzable request tags")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="diff two traces' slow reports (B minus A)")
    ap.add_argument("--timeline", metavar="JSONL",
                    help="summarize a persisted counter timeline")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    if args.timeline:
        from repro_torch.obs import timeseries as _ts

        try:
            summary = _ts.summarize(args.timeline)
        except (OSError, ValueError) as e:
            print(f"cannot read timeline {args.timeline!r}: {e}",
                  file=sys.stderr)
            return 1
        if args.as_json:
            # tuple keys aren't JSON — flatten to "L{loc} {name}" strings
            out = dict(summary)
            out["counters"] = {f"L{loc} {name}": st for (loc, name), st
                               in summary["counters"].items()}
            out["utilization"] = {f"L{loc} {pool}": d for (loc, pool), d
                                  in summary["utilization"].items()}
            print(json.dumps(out, indent=2))
        else:
            print("\n".join(_ts.format_summary(summary)))
        return 0 if summary["records"] else 1

    if args.diff:
        ra = _attribution.slow_report(_load(args.diff[0]))
        rb = _attribution.slow_report(_load(args.diff[1]))
        d = _attribution.diff_reports(ra, rb)
        if args.as_json:
            print(json.dumps(d, indent=2))
        else:
            for tier, t in sorted(d["tiers"].items()):
                print(f"[{tier}]  Δcount={t['count']:+d}  "
                      f"Δp99={t['delta_p99_us'] / 1e3:+.2f}ms")
                for c, us in sorted(t["delta_us"].items()):
                    share = t["delta_share"].get(c, 0.0)
                    print(f"  {c:<10} {us / 1e3:>+10.2f}ms "
                          f"{share * 100:>+6.1f}%")
        return 0

    if not args.trace:
        ap.error("a trace file is required (or use --diff A B)")
    tr = _load(args.trace)
    idx = _cp.TraceIndex(tr)

    if args.requests:
        tags = _cp.request_ids(idx)
        print(json.dumps(tags) if args.as_json else "\n".join(tags))
        return 0 if tags else 1

    if args.critical_path:
        cp = _cp.critical_path(idx, args.critical_path)
        if cp is None:
            known = _cp.request_ids(idx)
            print(f"request {args.critical_path!r} not found in trace "
                  f"({len(known)} analyzable: {known[:8]}...)",
                  file=sys.stderr)
            return 1
        if args.as_json:
            print(json.dumps(cp.summary(), indent=2))
        else:
            print(_attribution.format_critical_path(cp))
        return 0

    # default (and --slow-report): the aggregate blame report
    report = _attribution.slow_report(idx)
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(_attribution.format_report(report))
    return 0 if report["requests"] else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `... | head` closed stdout — not an error
        import os

        # point stdout at devnull so the interpreter's exit-time flush
        # doesn't raise the same error again as "Exception ignored"
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
