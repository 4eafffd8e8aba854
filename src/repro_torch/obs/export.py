"""Fleet-wide trace collection + Chrome trace-event export, ported from the
reference's ``obs/export.py``.

The flight-recorder read-out: locality 0 pulls every locality's per-thread
ring buffers over the parcelport (plain actions — the trace rides the same
wire it instruments), corrects worker clocks onto the root's
``time.perf_counter`` domain via a min-RTT handshake, and merges everything
into one Chrome trace-event JSON that loads directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

- localities render as *processes* (``pid`` = locality id, named via
  ``process_name`` metadata), threads as *tracks*;
- cross-locality parcels render as *flow arrows*: the send span carries a
  flow-start (``ph:"s"``), the remote execute span the matching
  flow-finish (``ph:"f"``, ``bp:"e"``) with the same id — Perfetto draws
  the arrow from sender to receiver;
- serve requests render as *async spans* (``b``/``n``/``e``) spanning
  admission → prefill → decode steps → finish.

Clock correction: ``time.perf_counter`` has a per-process arbitrary epoch,
so worker timestamps are meaningless next to the root's.  For each worker
we run a few RTT probes (read the worker's clock, bracket it with local
reads) and keep the probe with the smallest RTT:
``offset = w - (t0 + t1) / 2`` — the classic Cristian handshake.  Worker
events are shifted by ``-offset`` into the root's domain; the residual
error is bounded by half the best RTT (tens of µs on loopback).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from repro_torch.core import parcel as _parcel
from repro_torch.obs import trace as _trace


# ---------------------------------------------------------- fleet actions
@_parcel.action
def _obs_enable(rt, capacity: int) -> bool:
    _trace.enable(capacity=capacity)
    return True


@_parcel.action
def _obs_disable(rt) -> bool:
    _trace.disable()
    return True


@_parcel.action
def _obs_clear(rt) -> bool:
    _trace.clear()
    return True


@_parcel.action
def _obs_collect(rt) -> List[Dict[str, Any]]:
    """Snapshot this locality's ring buffers (raw event tuples)."""
    return _trace.export_buffers()


# Fault-injection hook for clock-correction tests: a skew added to the
# clock *as reported to probes* emulates the correction error left by
# asymmetric link latency (the Cristian midpoint assumes symmetry).
_probe_skew = 0.0


def set_probe_skew(delta: float) -> None:
    global _probe_skew
    _probe_skew = float(delta)


@_parcel.action
def _obs_set_probe_skew(rt, delta: float) -> bool:
    set_probe_skew(delta)
    return True


@_parcel.action
def _obs_clock(rt) -> float:
    """Read this locality's monotonic clock (the handshake probe)."""
    return time.perf_counter() + _probe_skew


def clock_offset(net, locality: int, probes: int = 5) -> float:
    """``remote_perf_counter - local_perf_counter`` for ``locality``,
    estimated from the minimum-RTT probe of ``probes`` round trips."""
    from repro_torch.net import remote as _remote

    if locality == net.locality:
        return 0.0
    best_rtt, best_off = float("inf"), 0.0
    for _ in range(probes):
        t0 = time.perf_counter()
        w = _remote.run_on(locality, _obs_clock).get(timeout=30)
        t1 = time.perf_counter()
        rtt = t1 - t0
        if rtt < best_rtt:
            best_rtt, best_off = rtt, w - (t0 + t1) / 2.0
    return best_off


def enable_fleet(net=None, capacity: int = _trace.DEFAULT_CAPACITY) -> None:
    """Turn tracing on at every locality (local-only when ``net`` is None)."""
    _trace.enable(capacity=capacity)
    if net is not None:
        from repro_torch.net import remote as _remote

        for loc in range(net.n_localities):
            if loc != net.locality:
                _remote.run_on(loc, _obs_enable, capacity).get(timeout=30)


def disable_fleet(net=None) -> None:
    _trace.disable()
    if net is not None:
        from repro_torch.net import remote as _remote

        for loc in range(net.n_localities):
            if loc != net.locality:
                _remote.run_on(loc, _obs_disable).get(timeout=30)


def clear_fleet(net=None) -> None:
    """Drop every locality's ring buffers — the flight recorder arms from
    an empty window so a dump's evidence has a well-defined start."""
    _trace.clear()
    if net is not None:
        from repro_torch.net import remote as _remote

        for loc in range(net.n_localities):
            if loc != net.locality:
                _remote.run_on(loc, _obs_clear).get(timeout=30)


# ------------------------------------------------------------- conversion
def _chrome_events(buffers: List[Dict[str, Any]], pid: int,
                   offset: float) -> List[Dict[str, Any]]:
    """Raw per-thread event tuples → Chrome trace-event dicts.

    ``offset`` maps this locality's clock into the root's domain
    (subtracted); timestamps convert to microseconds, the Chrome unit.
    """
    out: List[Dict[str, Any]] = []
    for buf in buffers:
        tid = int(buf["tid"]) & 0x7FFFFFFF  # Chrome wants smallish ints
        for ph, name, cat, ts, dur, eid, args in buf["events"]:
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "ph": ph, "pid": pid, "tid": tid,
                "ts": (ts - offset) * 1e6,
            }
            if ph == "X":
                ev["dur"] = dur * 1e6
                if eid is not None:
                    # the span's own id, in the same "loc:seq" form that
                    # child spans reference via args["parent"] — the
                    # analyzer's parent->child link
                    sid = f"{eid[0]}:{eid[1]}"
                    if args:
                        ev["args"] = dict(args)
                        ev["args"]["sid"] = sid
                    else:
                        ev["args"] = {"sid": sid}
                    out.append(ev)
                    continue
            elif ph == "i":
                ev["s"] = "t"  # instant scoped to its thread
            elif ph in ("s", "f"):
                # flow id: globally unique as "origin_locality:seq"
                ev["id"] = f"{eid[0]}:{eid[1]}"
                if ph == "f":
                    ev["bp"] = "e"  # bind to the enclosing slice
            elif ph in ("b", "n", "e"):
                # async events match on (cat, id); scope ids per locality
                ev["id"] = f"{pid}:{eid}"
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        if buf.get("dropped"):
            out.append({"name": "trace/dropped", "cat": "obs", "ph": "i",
                        "pid": pid, "tid": tid, "ts": 0.0, "s": "t",
                        "args": {"count": buf["dropped"]}})
    return out


def _metadata(buffers: List[Dict[str, Any]], pid: int) -> List[Dict[str, Any]]:
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": f"locality#{pid}"}}]
    for buf in buffers:
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": int(buf["tid"]) & 0x7FFFFFFF,
                     "args": {"name": buf["thread_name"]}})
    return meta


# --------------------------------------------------------------- assembly
def merged_trace(net=None, probes: int = 5) -> Dict[str, Any]:
    """One merged Chrome trace across the fleet (or just this process).

    With ``net`` (a bootstrapped :class:`repro_torch.net.NetRuntime`, normally
    the root), every other locality's buffers are pulled over the
    parcelport and clock-corrected; flow events recorded on both ends of
    each parcel stitch the localities together.
    """
    events: List[Dict[str, Any]] = []
    ring_drops: Dict[str, int] = {}
    local_pid = 0
    if net is not None:
        local_pid = net.locality
    else:
        try:
            from repro_torch.core import agas as _agas

            a = _agas.peek()
            local_pid = a.locality if a is not None else _agas._default_locality
        except Exception:
            local_pid = 0

    def _account_drops(bufs: List[Dict[str, Any]], pid: int) -> None:
        for buf in bufs:
            if buf.get("dropped"):
                key = f"{pid}/{buf.get('thread_name', buf.get('tid'))}"
                ring_drops[key] = ring_drops.get(key, 0) + int(buf["dropped"])

    if net is not None:
        from repro_torch.net import remote as _remote

        for loc in range(net.n_localities):
            if loc == net.locality:
                continue
            off = clock_offset(net, loc, probes=probes)
            bufs = _remote.run_on(loc, _obs_collect).get(timeout=60)
            _account_drops(bufs, loc)
            events.extend(_metadata(bufs, loc))
            events.extend(_chrome_events(bufs, loc, offset=off))

    # snapshot the collector's own buffers LAST: the collection round
    # trips above record send spans here whose execute spans are already
    # in the remote snapshots — collecting locally first would orphan them
    local = _trace.export_buffers()
    _account_drops(local, local_pid)
    events.extend(_metadata(local, local_pid))
    events.extend(_chrome_events(local, local_pid, offset=0.0))

    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    tr: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if ring_drops:
        # any wrapped ring means the trace is a *suffix* of reality —
        # analyses must not claim completeness, so say so in the header
        tr["lossy"] = True
        tr["ring_drops"] = ring_drops
    return tr


def export_chrome_trace(path: str, net=None, probes: int = 5) -> Dict[str, Any]:
    """Write the merged fleet trace to ``path`` (Perfetto-loadable JSON);
    returns the trace dict for immediate inspection."""
    tr = merged_trace(net=net, probes=probes)
    with open(path, "w") as f:
        json.dump(tr, f)
    return tr


def flow_links(tr: Dict[str, Any]) -> Dict[str, Dict[str, Optional[int]]]:
    """Flow id → ``{"src": sender pid, "dst": receiver pid}`` (None when
    one side is missing) — the causal-link audit used by tests and the
    bench harness to prove cross-locality stitching actually happened."""
    links: Dict[str, Dict[str, Optional[int]]] = {}
    for ev in tr["traceEvents"]:
        if ev["ph"] in ("s", "f"):
            slot = links.setdefault(ev["id"], {"src": None, "dst": None})
            slot["src" if ev["ph"] == "s" else "dst"] = ev["pid"]
    return links
