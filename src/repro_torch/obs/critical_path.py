"""Per-request critical-path reconstruction + SLOW-taxonomy blame, ported
from the reference's ``obs/critical_path.py`` (standard library only).

The analysis half of the observability tier: :mod:`repro_torch.obs.trace`
records spans/flows/async events, :mod:`repro_torch.obs.export` merges them
fleet-wide onto one clock — this module answers *"why was this request
slow?"* with the SLOW vocabulary of the ParalleX performance model
(Anderson et al., arXiv:1109.5201):

- **S**tarvation — the request had nothing running on its behalf because
  no execution resource picked it up yet (prefill-pool queue wait,
  ready-queue wait for slot integration);
- **L**atency — clock-corrected parcel transit: the gap between a send
  span ending on one locality and the matching execute span starting on
  another (submit leg, completion leg);
- **O**verhead — machinery that is neither user work nor waiting on a
  resource: router dispatch, serialization/send, engine-loop bookkeeping
  between decode steps, completion plumbing;
- **W**aiting — contention on a held resource: the admission gate
  (``router/gated``), KV page-pool exhaustion (``admit_stall``), credit
  blocks / rendezvous CTS waits on the wire.

Everything else on the path — prefill and decode-step spans — is
**work**.  The request's admission→finish wall time is *tiled*: every
microsecond lands in exactly one classified interval, so attribution
sums to the total by construction and any residual (end-clamps from
clock-correction error) is reported explicitly, never silently dropped.

The join key is the fleet-global request tag (``args["req"]``) the
router stamps into every span the request touches, on every locality
(DESIGN.md §10.4).  Parent→child links ride ``args["parent"]`` (span
sids) and flow ids; both come from the same ``(locality, seq)``
allocator, so an id names exactly one edge.

Cross-locality edges use *clock-corrected* timestamps (export's min-RTT
Cristian handshake).  The residual correction error is bounded by half
the best probe RTT but can still run an edge backwards — such negative
intervals are clamped to zero and **counted** (``clamped_count`` /
``clamped_us``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Set, Tuple

__all__ = ["SLOW_CLASSES", "CLASS_NAMES", "Interval", "CriticalPath",
           "TraceIndex", "request_ids", "critical_path", "flow_edges",
           "mark_critical_path", "CP_TID"]

# classification keys: work + the four SLOW categories
SLOW_CLASSES = ("work", "S", "L", "O", "W")
CLASS_NAMES = {"work": "work", "S": "starvation", "L": "latency",
               "O": "overhead", "W": "waiting"}

# synthetic track the marked critical path renders on (one per locality)
CP_TID = 0x7FFFFFFE


class Interval(NamedTuple):
    t0: float        # µs, merged-clock domain
    t1: float
    cls: str         # one of SLOW_CLASSES
    what: str        # human label ("prefill", "wire", "admission gate", …)
    pid: int         # locality the interval is charged to


class CriticalPath:
    """One request's tiled admission→finish timeline."""

    def __init__(self, req: str, slo: Optional[str], t0: float, t1: float,
                 intervals: List[Interval], clamped_count: int,
                 clamped_us: float):
        self.req = req
        self.slo = slo
        self.t0 = t0
        self.t1 = t1
        self.intervals = intervals
        self.clamped_count = clamped_count
        self.clamped_us = clamped_us
        self.total_us = max(0.0, t1 - t0)
        self.by_class: Dict[str, float] = {c: 0.0 for c in SLOW_CLASSES}
        for iv in intervals:
            self.by_class[iv.cls] += iv.t1 - iv.t0
        self.attributed_us = sum(self.by_class.values())
        self.residual_us = max(0.0, self.total_us - self.attributed_us)
        self.fraction = (self.attributed_us / self.total_us
                         if self.total_us > 0 else 1.0)

    def localities(self) -> Set[int]:
        return {iv.pid for iv in self.intervals}

    def summary(self) -> Dict[str, Any]:
        return {
            "req": self.req, "slo": self.slo,
            "total_us": self.total_us,
            "attributed_us": self.attributed_us,
            "residual_us": self.residual_us,
            "fraction": self.fraction,
            "clamped_count": self.clamped_count,
            "clamped_us": self.clamped_us,
            "localities": sorted(self.localities()),
            "by_class_us": {CLASS_NAMES[c]: v
                            for c, v in self.by_class.items()},
        }


# ------------------------------------------------------------------ indexing
class TraceIndex:
    """One-pass index over a merged Chrome trace (timestamps in µs)."""

    def __init__(self, tr: Dict[str, Any]):
        self.events: List[Dict[str, Any]] = tr.get("traceEvents", [])
        self.lossy = bool(tr.get("lossy"))
        # "{pid}/{thread}" → events the ring overwrote (export header);
        # kept so reports can *quantify* the loss, not just flag it
        self.ring_drops: Dict[str, int] = dict(tr.get("ring_drops") or {})
        self.spans_by_name: Dict[str, List[dict]] = defaultdict(list)
        self.span_by_sid: Dict[str, dict] = {}
        self.children: Dict[str, List[dict]] = defaultdict(list)
        self.instants_by_name: Dict[str, List[dict]] = defaultdict(list)
        # flow "s" events keyed by (pid, tid, ts): a span records its
        # flow-start at its own start timestamp on its own thread, so this
        # triple joins an X span to the flow id it emitted
        self.flow_start_at: Dict[Tuple[int, int, float], str] = {}
        self.flow_events: Dict[str, Dict[str, dict]] = defaultdict(dict)
        # request async lifetimes: tag -> {"b": ev, "e": ev}
        self.requests: Dict[str, Dict[str, dict]] = defaultdict(dict)

        for ev in self.events:
            ph = ev.get("ph")
            args = ev.get("args") or {}
            if ph == "X":
                self.spans_by_name[ev["name"]].append(ev)
                sid = args.get("sid")
                if sid:
                    self.span_by_sid[sid] = ev
                parent = args.get("parent")
                if parent:
                    self.children[parent].append(ev)
            elif ph == "i":
                self.instants_by_name[ev["name"]].append(ev)
            elif ph in ("s", "f"):
                self.flow_events[ev["id"]][ph] = ev
                if ph == "s":
                    self.flow_start_at[(ev["pid"], ev["tid"],
                                        ev["ts"])] = ev["id"]
            elif ph in ("b", "e") and ev.get("name") == "request":
                tag = args.get("req")
                if tag:
                    self.requests[tag][ph] = ev

    # -------------------------------------------------------- link walking
    def spans_for_req(self, name: str, req: str) -> List[dict]:
        return sorted((s for s in self.spans_by_name.get(name, [])
                       if (s.get("args") or {}).get("req") == req),
                      key=lambda s: s["ts"])

    def instants_for_req(self, name: str, req: str) -> List[dict]:
        return sorted((i for i in self.instants_by_name.get(name, [])
                       if (i.get("args") or {}).get("req") == req),
                      key=lambda i: i["ts"])

    def child_send(self, span: dict, prefix: str = "send:") -> Optional[dict]:
        """The send:* span recorded inside ``span`` (parent = its sid)."""
        sid = (span.get("args") or {}).get("sid")
        if not sid:
            return None
        for c in self.children.get(sid, []):
            if c["name"].startswith(prefix):
                return c
        return None

    def remote_execute(self, send_span: dict) -> Optional[dict]:
        """Follow a send span's flow arrow to the remote execute span."""
        fid = self.flow_start_at.get((send_span["pid"], send_span["tid"],
                                      send_span["ts"]))
        if fid is None:
            return None
        for c in self.children.get(fid, []):
            if c["name"].startswith("execute:"):
                return c
        return None


def request_ids(tr: Dict[str, Any]) -> List[str]:
    """Every request tag with a complete (begin AND end) lifetime in the
    trace — the population :func:`critical_path` can analyze."""
    idx = tr if isinstance(tr, TraceIndex) else TraceIndex(tr)
    return sorted(tag for tag, be in idx.requests.items()
                  if "b" in be and "e" in be)


# --------------------------------------------------------------- flow edges
def flow_edges(tr: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every cross-locality flow arrow with its clock-corrected transit.

    Negative transits (clock-correction residual ran the edge backwards)
    are clamped to zero and flagged ``clamped`` — the audit the 3-locality
    skew test asserts on: edges never go backwards, and clamping is
    counted, not silent."""
    idx = tr if isinstance(tr, TraceIndex) else TraceIndex(tr)
    edges: List[Dict[str, Any]] = []
    for fid, sides in sorted(idx.flow_events.items()):
        s, f = sides.get("s"), sides.get("f")
        if s is None or f is None:
            continue
        raw = f["ts"] - s["ts"]
        edges.append({
            "id": fid, "src": s["pid"], "dst": f["pid"],
            "transit_us": max(0.0, raw), "raw_us": raw,
            "clamped": raw < 0.0,
        })
    return edges


# ------------------------------------------------------------ path building
def _seg(span: dict, cls: str, what: Optional[str] = None) -> Interval:
    return Interval(span["ts"], span["ts"] + span.get("dur", 0.0), cls,
                    what or span["name"], span["pid"])


def critical_path(tr: Dict[str, Any], req: str) -> Optional[CriticalPath]:
    """Reconstruct ``req``'s admission→finish path and tile it into
    classified intervals.  Returns None when the trace lacks the
    request's begin/end anchors (ring wrapped, or tag unknown)."""
    idx = tr if isinstance(tr, TraceIndex) else TraceIndex(tr)
    be = idx.requests.get(req) or {}
    begin, end = be.get("b"), be.get("e")
    if begin is None or end is None:
        return None

    router_spans = idx.spans_for_req("router/submit", req)
    gated = idx.instants_for_req("router/gated", req)
    stalls = idx.instants_for_req("admit_stall", req)
    prefills = idx.spans_for_req("prefill", req)
    relay_dones = idx.spans_for_req("relay/done", req)
    steps = sorted((s for s in idx.spans_by_name.get("decode_step", [])
                    if req in ((s.get("args") or {}).get("reqs") or [])),
                   key=lambda s: s["ts"])
    slo = ((begin.get("args") or {}).get("slo")
           or next(((r.get("args") or {}).get("slo")
                    for r in router_spans), None))

    segments: List[Interval] = []
    for rs in router_spans:
        segments.append(_seg(rs, "O", "router dispatch"))
        send = idx.child_send(rs)
        if send is not None:
            ex = idx.remote_execute(send)
            if ex is not None:
                segments.append(_seg(ex, "O", "submit execute"))
    for p in prefills:
        segments.append(_seg(p, "work", "prefill"))
    for s in steps:
        segments.append(_seg(s, "work", "decode_step"))

    t_end = end["ts"]
    for rd in relay_dones:
        segments.append(_seg(rd, "O", "completion send"))
        send = idx.child_send(rd)
        if send is not None:
            ex = idx.remote_execute(send)
            if ex is not None:
                segments.append(_seg(ex, "O", "completion execute"))
                t_end = max(t_end, ex["ts"] + ex.get("dur", 0.0))

    t_start = min([begin["ts"]]
                  + [r["ts"] for r in router_spans]
                  + [g["ts"] for g in gated])
    segments.sort(key=lambda iv: (iv.t0, iv.t1))

    gate_ts = [g["ts"] for g in gated]
    stall_ts = [s["ts"] for s in stalls]

    def gap_cls(prev: Optional[Interval], nxt: Optional[Interval],
                g0: float, g1: float) -> Tuple[str, str]:
        if any(g0 <= t <= g1 for t in gate_ts):
            return "W", "admission gate"
        if any(g0 <= t <= g1 for t in stall_ts):
            return "W", "kv-pool stall"
        if prev is not None and nxt is not None and prev.pid != nxt.pid:
            return "L", "wire"
        if nxt is not None and nxt.what == "prefill":
            return "S", "prefill queue"
        if (nxt is not None and nxt.what == "decode_step"
                and (prev is None or prev.what == "prefill")):
            return "S", "ready queue"
        return "O", "engine loop"

    intervals: List[Interval] = []
    clamped_count, clamped_us = 0, 0.0
    cursor = t_start
    prev: Optional[Interval] = None
    for seg in segments:
        if seg.t1 <= cursor:  # fully inside something already tiled
            continue
        raw_gap = seg.t0 - cursor
        if raw_gap < 0.0:
            # overlap (nested span / clock residual): clip, count the loss
            clamped_count += 1
            clamped_us += -raw_gap
        elif raw_gap > 0.0:
            cls, what = gap_cls(prev, seg, cursor, seg.t0)
            pid = seg.pid if cls in ("S", "O", "W") else \
                (prev.pid if prev is not None else seg.pid)
            intervals.append(Interval(cursor, seg.t0, cls, what, pid))
        s0 = max(cursor, seg.t0)
        intervals.append(Interval(s0, seg.t1, seg.cls, seg.what, seg.pid))
        cursor = seg.t1
        prev = seg
    if t_end > cursor:
        pid = prev.pid if prev is not None else begin["pid"]
        intervals.append(Interval(cursor, t_end, "O", "finish", pid))
    elif t_end < cursor:
        clamped_count += 1
        clamped_us += cursor - t_end
    t_end = max(t_end, cursor)

    return CriticalPath(req, slo, t_start, t_end, intervals,
                        clamped_count, clamped_us)


# ----------------------------------------------------------------- marking
def mark_critical_path(tr: Dict[str, Any], cp: CriticalPath) -> Dict[str, Any]:
    """Inject the critical path into the trace as ``cat:"anomaly"`` spans
    on a dedicated per-locality track, so Perfetto shows the blame
    timeline right under the real slices.  Mutates and returns ``tr``."""
    events = tr.setdefault("traceEvents", [])
    for pid in sorted(cp.localities()):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": CP_TID,
                       "args": {"name": f"critical path [{cp.req}]"}})
    for iv in cp.intervals:
        events.append({
            "name": f"{CLASS_NAMES[iv.cls]}:{iv.what}", "cat": "anomaly",
            "ph": "X", "pid": iv.pid, "tid": CP_TID,
            "ts": iv.t0, "dur": max(iv.t1 - iv.t0, 0.0),
            "args": {"req": cp.req, "class": CLASS_NAMES[iv.cls]},
        })
    tr["critical_path"] = cp.summary()
    return tr
