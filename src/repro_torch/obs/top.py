"""``python -m repro_torch.obs.top`` — live fleet dashboard ("hpx-top"),
ported from the reference's ``obs/top.py``.

The terminal answer to "is the fleet healthy *right now*": per-locality
pool utilization bars, queue depths, serve engine p99s, parcelport
credit/inflight, and the admission gate — refreshed off one sampler, no
browser, no Grafana.

Two data paths, one frame renderer:

- **in-process** — a :class:`repro_torch.obs.sampler.FleetSampler` sweeping the
  fleet over the parcelport (the launcher's ``--metrics-port`` sibling);
- **remote scrape** — ``--metrics http://host:port/metrics`` re-parses
  the OpenMetrics exposition (via the strict parser), so an operator can
  point ``obs.top`` at any running fleet from *outside* the process tree.

``--once`` renders a single frame and exits (what CI smoke-tests); the
default loop redraws every ``--interval`` seconds until interrupted.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from typing import Any, Dict, Optional, Tuple

_POOL_RE = re.compile(r"^/scheduler\{(?P<pool>[^}]*)\}/(?P<rest>.+)$")
_SERVE_P99_RE = re.compile(
    r"^/serve\{engine#(?P<engine>\d+)\}/request/"
    r"(?P<which>latency|first_token)/p99$")
_NET_RE = re.compile(
    r"^/net\{locality#(?P<loc>\d+)/peer#(?P<peer>\d+)\}/credit/"
    r"(?P<which>inflight_bytes|blocked|deferred)$")
_QUEUE_RE = re.compile(r"^queue/worker#(?P<w>\d+)/depth$")


# ------------------------------------------------------------- snapshots
def snapshot_from_flat(flat: Dict[Tuple[int, str], float]) -> Dict[str, Any]:
    """Build one dashboard snapshot from ``{(locality, counter): value}``
    — the common denominator of both data paths."""
    pools: Dict[Tuple[int, str], Dict[str, Any]] = {}
    serve: Dict[Tuple[int, int], Dict[str, float]] = {}
    net: Dict[Tuple[int, int], Dict[str, float]] = {}
    admission: Dict[int, Dict[str, float]] = {}
    for (loc, name), value in flat.items():
        pm = _POOL_RE.match(name)
        if pm:
            pool = pools.setdefault((loc, pm.group("pool")),
                                    {"queue": 0.0, "workers": 0})
            rest = pm.group("rest")
            if rest == "utilization":
                pool["util"] = value
            elif rest == "idle-rate":
                pool["idle"] = value
            elif rest == "queue/high/depth":
                pool["high"] = value
            else:
                qm = _QUEUE_RE.match(rest)
                if qm:
                    pool["queue"] += value
                    pool["workers"] += 1
            continue
        sm = _SERVE_P99_RE.match(name)
        if sm:
            s = serve.setdefault((loc, int(sm.group("engine"))), {})
            s[sm.group("which")] = value
            continue
        nm = _NET_RE.match(name)
        if nm:
            n = net.setdefault((int(nm.group("loc")), int(nm.group("peer"))),
                               {})
            n[nm.group("which")] = value
            continue
        if name == "/serve{router}/admission/depth":
            admission.setdefault(loc, {})["depth"] = value
        elif name == "/serve{router}/admission/gated":
            admission.setdefault(loc, {})["gated"] = value
        elif name == "/fleet{admission}/open":
            admission.setdefault(loc, {})["open"] = value
    localities = sorted({loc for loc, _ in flat})
    return {"localities": localities, "pools": pools, "serve": serve,
            "net": net, "admission": admission}


def snapshot_from_sampler(sampler) -> Dict[str, Any]:
    """Latest sampled value of every retained counter → one snapshot."""
    flat: Dict[Tuple[int, str], float] = {}
    for loc, name in sampler.keys():
        v = sampler.latest(loc, name)
        if v is not None:
            flat[(loc, name)] = v
    return snapshot_from_flat(flat)


# families of interest ← how the exposition spells each dashboard input;
# the inverse of obs.metrics.counter_to_metric for exactly these names
def _flat_from_families(families: Dict[str, Dict[str, Any]]
                        ) -> Dict[Tuple[int, str], float]:
    flat: Dict[Tuple[int, str], float] = {}
    ups: Dict[int, float] = {}
    for fam, info in families.items():
        for name, labels, value in info["samples"]:
            loc = int(labels.get("locality", 0))
            if fam == "repro_up":
                ups[loc] = value
            elif fam in ("repro_scheduler_utilization",
                         "repro_scheduler_idle_rate"):
                leaf = ("utilization" if fam.endswith("utilization")
                        else "idle-rate")
                flat[(loc, f"/scheduler{{{labels.get('pool', '')}}}/"
                           f"{leaf}")] = value
            elif fam == "repro_scheduler_queue_depth" and "worker" in labels:
                flat[(loc, f"/scheduler{{{labels.get('pool', '')}}}/queue/"
                           f"worker#{labels['worker']}/depth")] = value
            elif fam == "repro_scheduler_queue_high_depth":
                flat[(loc, f"/scheduler{{{labels.get('pool', '')}}}/queue/"
                           "high/depth")] = value
            elif (fam in ("repro_serve_request_latency_p99",
                          "repro_serve_request_first_token_p99")
                  and "engine" in labels):
                which = ("latency" if "latency" in fam else "first_token")
                flat[(loc, f"/serve{{engine#{labels['engine']}}}/request/"
                           f"{which}/p99")] = value
            elif fam == "repro_net_credit_inflight_bytes" and "peer" in labels:
                flat[(loc, f"/net{{locality#{loc}/peer#{labels['peer']}}}/"
                           "credit/inflight_bytes")] = value
            elif fam == "repro_net_credit_blocked_total" and "peer" in labels:
                flat[(loc, f"/net{{locality#{loc}/peer#{labels['peer']}}}/"
                           "credit/blocked")] = value
            elif fam == "repro_serve_admission_depth":
                flat[(loc, "/serve{router}/admission/depth")] = value
            elif fam == "repro_serve_admission_gated_total":
                flat[(loc, "/serve{router}/admission/gated")] = value
            elif fam == "repro_fleet_open":
                flat[(loc, "/fleet{admission}/open")] = value
    snap_extra = {loc for loc, up in ups.items() if up}
    for loc in snap_extra:  # a reachable-but-quiet locality still shows up
        flat.setdefault((loc, "/fleet{_up}/marker"), 1.0)
    return flat


def snapshot_from_metrics(text: str) -> Dict[str, Any]:
    from repro_torch.obs import metrics as _metrics

    return snapshot_from_flat(
        _flat_from_families(_metrics.parse_prometheus_text(text)))


# -------------------------------------------------------------- rendering
def _bar(frac: Optional[float], width: int = 20) -> str:
    if frac is None:
        return "-" * width
    frac = min(1.0, max(0.0, frac))
    full = int(round(frac * width))
    return "#" * full + "." * (width - full)


def render_frame(snapshot: Dict[str, Any],
                 now: Optional[float] = None) -> str:
    lines = []
    locs = snapshot["localities"]
    stamp = time.strftime("%H:%M:%S") if now is None else f"t={now:.1f}s"
    lines.append(f"repro fleet-top — {len(locs)} localit"
                 f"{'y' if len(locs) == 1 else 'ies'} — {stamp}")
    if snapshot["pools"]:
        lines.append("")
        lines.append(f"{'POOL':<26} {'utilization':<27} {'idle':>6} "
                     f"{'queued':>7} {'hi-q':>5}")
        for (loc, pool), st in sorted(snapshot["pools"].items()):
            util = st.get("util")
            lines.append(
                f"L{loc} scheduler{{{pool}}}"[:26].ljust(26) + " "
                f"[{_bar(util)}] "
                + (f"{util:>4.0%}" if util is not None else "   -") + " "
                + (f"{st['idle']:>6.0%}" if "idle" in st else f"{'-':>6}")
                + f" {st.get('queue', 0):>7.0f}"
                + (f" {st['high']:>5.0f}" if "high" in st else f" {'-':>5}"))
    if snapshot["serve"]:
        lines.append("")
        lines.append(f"{'SERVE ENGINE':<26} {'p99 latency':>12} "
                     f"{'p99 first-token':>16}")
        for (loc, eng), st in sorted(snapshot["serve"].items()):
            lat = st.get("latency")
            ftk = st.get("first_token")
            lines.append(
                f"L{loc} engine#{eng}"[:26].ljust(26)
                + (f" {lat * 1e3:>10.1f}ms" if lat is not None
                   else f" {'-':>12}")
                + (f" {ftk * 1e3:>14.1f}ms" if ftk is not None
                   else f" {'-':>16}"))
    if snapshot["net"]:
        lines.append("")
        lines.append(f"{'NET loc→peer':<26} {'inflight':>10} {'blocked':>9}")
        for (loc, peer), st in sorted(snapshot["net"].items()):
            lines.append(
                f"L{loc} → L{peer}"[:26].ljust(26)
                + f" {st.get('inflight_bytes', 0):>10.0f}"
                + f" {st.get('blocked', 0):>9.0f}")
    if snapshot["admission"]:
        lines.append("")
        for loc, st in sorted(snapshot["admission"].items()):
            gate = st.get("open")
            state = ("open" if gate else "CLOSED") if gate is not None else "?"
            lines.append(f"L{loc} admission: {state}  "
                         f"depth={st.get('depth', 0):.0f}  "
                         f"gated={st.get('gated', 0):.0f}")
    return "\n".join(lines)


# -------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.top",
        description="live fleet dashboard off the counter tree")
    ap.add_argument("--metrics", metavar="URL",
                    help="scrape an OpenMetrics endpoint instead of "
                         "sampling in-process")
    ap.add_argument("--pattern", default="*",
                    help="counter pattern for in-process sampling")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until interrupted)")
    ap.add_argument("--once", action="store_true",
                    help="render a single frame and exit (no clearing)")
    args = ap.parse_args(argv)

    frames = 1 if args.once else args.frames
    sampler = None
    if args.metrics is None:
        from repro_torch import net as rnet
        from repro_torch.obs.sampler import FleetSampler

        sampler = FleetSampler(pattern=args.pattern,
                               interval=args.interval, net=rnet.current())

    n = 0
    try:
        while True:
            if args.metrics is not None:
                from repro_torch.net.httpd import http_get

                status, body = http_get(args.metrics)
                if status != 200:
                    print(f"scrape failed: HTTP {status}", file=sys.stderr)
                    return 1
                snap = snapshot_from_metrics(body)
            else:
                sampler.sample_once()
                snap = snapshot_from_sampler(sampler)
            frame = render_frame(snap)
            if not args.once and n > 0:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(frame, flush=True)
            n += 1
            if frames and n >= frames:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
