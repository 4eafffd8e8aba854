"""The port's observability analysis tier against the reference's:
``critical_path``, ``attribution``, ``timeseries``, the ``analyze`` CLI,
``export`` (Chrome conversion, the merged local trace, flow links) and the
flight recorder.

Every case gives the same inputs to both packages and compares the
outputs exactly (tolerance 0): the modules compute dicts and strings from
Chrome traces and counter sweeps, with no tensor math.  The inputs are the
hand-built merged traces of ``tests/test_obs_analyzer.py`` (known gaps,
known classes, an injected negative edge) and a trace drawn from a seeded
numpy generator (many requests sharing decode steps, gate parks, pool
stalls).  A branch the reference takes only with a multi-locality runtime
(``net`` given) goes over that runtime in the port too
(``tests/test_torch_obs_net.py`` drives it across real localities)."""
import copy
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from repro.core import counters as rcounters
from repro.obs import analyze as r_analyze
from repro.obs import attribution as r_attr
from repro.obs import critical_path as r_cp
from repro.obs import export as r_export
from repro.obs import recorder as r_recorder
from repro.obs import timeseries as r_ts
from repro.obs import trace as r_trace
from repro_torch.core import counters as tcounters
from repro_torch.obs import analyze as t_analyze
from repro_torch.obs import attribution as t_attr
from repro_torch.obs import critical_path as t_cp
from repro_torch.obs import export as t_export
from repro_torch.obs import recorder as t_recorder
from repro_torch.obs import timeseries as t_ts
from repro_torch.obs import trace as t_trace


@pytest.fixture(autouse=True)
def _clean_tracers():
    for tr in (r_trace, t_trace):
        tr.disable()
        tr.clear()
    yield
    for tr in (r_trace, t_trace):
        tr.disable()
        tr.clear()


# ------------------------------------------------------- synthetic traces
def _ev(events, **kw):
    events.append(kw)
    return kw


def _span(events, name, pid, tid, ts, dur, **args):
    return _ev(events, name=name, cat="t", ph="X", pid=pid, tid=tid,
               ts=float(ts), dur=float(dur), args=args)


def _remote_trace(engine_shift=0.0, decode_dur=400.0, tag="r0:1"):
    """One interactive request dispatched from locality 0 to an engine on
    locality 1, its completion delivered back (``test_obs_analyzer.py``)."""
    ev = []
    sh = float(engine_shift)
    _span(ev, "router/submit", 0, 1, 0, 300, sid="0:1", req=tag,
          slo="interactive")
    _span(ev, "send:_fleet_submit", 0, 1, 50, 200, sid="0:2", parent="0:1")
    _ev(ev, name="send:_fleet_submit", cat="t", ph="s", pid=0, tid=1,
        ts=50.0, id="0:3")
    _span(ev, "execute:_fleet_submit", 1, 9, 800 + sh, 100, sid="1:1",
          parent="0:3")
    _ev(ev, name="execute:_fleet_submit", cat="t", ph="f", pid=1, tid=9,
        ts=800.0 + sh, id="0:3", bp="e")
    _ev(ev, name="request", cat="serve", ph="b", pid=1, tid=9,
        ts=850.0 + sh, id="1:1", args={"req": tag, "slo": "interactive"})
    _span(ev, "prefill", 1, 10, 1200 + sh, 1000, sid="1:2", req=tag)
    _span(ev, "decode_step", 1, 11, 2500 + sh, decode_dur, sid="1:3",
          reqs=[tag])
    _ev(ev, name="request", cat="serve", ph="e", pid=1, tid=11,
        ts=3000.0 + sh, id="1:1", args={"req": tag})
    _span(ev, "relay/done", 1, 11, 3050 + sh, 100, sid="1:4", req=tag)
    _span(ev, "send:_deliver_done", 1, 11, 3060 + sh, 80, sid="1:6",
          parent="1:4")
    _ev(ev, name="send:_deliver_done", cat="t", ph="s", pid=1, tid=11,
        ts=3060.0 + sh, id="1:5")
    _span(ev, "execute:_deliver_done", 0, 2, 3900, 150, sid="0:4",
          parent="1:5")
    _ev(ev, name="execute:_deliver_done", cat="t", ph="f", pid=0, tid=2,
        ts=3900.0, id="1:5", bp="e")
    return {"traceEvents": ev}


def _gated_local_trace(tag="r0:7"):
    """A batch request parked at the gate, then KV-pool stalled."""
    ev = []
    _ev(ev, name="router/gated", cat="serve", ph="i", pid=0, tid=1,
        ts=100.0, s="t", args={"req": tag, "slo": "batch"})
    _span(ev, "router/submit", 0, 1, 5000, 200, sid="0:9", req=tag,
          slo="batch")
    _ev(ev, name="request", cat="serve", ph="b", pid=0, tid=3, ts=5300.0,
        id="0:10", args={"req": tag, "slo": "batch"})
    _span(ev, "prefill", 0, 4, 6000, 800, sid="0:11", req=tag)
    _ev(ev, name="admit_stall", cat="serve", ph="i", pid=0, tid=3,
        ts=7000.0, args={"req": tag})
    _span(ev, "decode_step", 0, 3, 8000, 300, sid="0:12", reqs=[tag])
    _ev(ev, name="request", cat="serve", ph="e", pid=0, tid=3, ts=8400.0,
        id="0:10", args={"req": tag})
    return {"traceEvents": ev}


def _seeded_trace(seed=0, n_req=12, batch=4):
    """A one-locality serving run drawn from a seeded generator: requests
    arrive through ``router/submit`` (some parked at the gate first),
    prefill in turn, and share decode steps ``batch`` at a time; some hit
    a KV-pool stall; one request never ends (no path), and one step
    overlaps the next (a clamp)."""
    rng = np.random.default_rng(seed)
    ev, sid = [], iter(range(1, 10 ** 6))
    t = 0.0
    reqs = []
    for i in range(n_req):
        tag = f"r0:{i + 1}"
        slo = ["interactive", "batch", None][i % 3]
        t += float(rng.uniform(10, 200))
        if slo == "batch" and rng.random() < 0.5:
            _ev(ev, name="router/gated", cat="serve", ph="i", pid=0, tid=1,
                ts=t, s="t", args={"req": tag, "slo": slo})
            t += float(rng.uniform(100, 900))
        _span(ev, "router/submit", 0, 1, t, float(rng.uniform(5, 40)),
              sid=f"0:{next(sid)}", req=tag, slo=slo)
        _ev(ev, name="request", cat="serve", ph="b", pid=0, tid=1,
            ts=t + 2.0, id=f"0:{i + 1}", args={"req": tag, "slo": slo})
        reqs.append(tag)
    t_pre = t + 50.0
    for tag in reqs:
        t_pre += float(rng.uniform(20, 300))
        dur = float(rng.uniform(200, 2000))
        _span(ev, "prefill", 0, 4, t_pre, dur, sid=f"0:{next(sid)}", req=tag)
        if rng.random() < 0.3:
            _ev(ev, name="admit_stall", cat="serve", ph="i", pid=0, tid=3,
                ts=t_pre + dur + 5.0, args={"req": tag})
        t_pre += dur
    t_step = t_pre + 100.0
    for lo in range(0, n_req, batch):
        group = reqs[lo:lo + batch]
        for k in range(int(rng.integers(3, 8))):
            dur = float(rng.uniform(300, 700))
            _span(ev, "decode_step", 0, 3, t_step, dur,
                  sid=f"0:{next(sid)}", reqs=group)
            # the second step of each group starts before the first ends
            t_step += dur - (50.0 if k == 0 else -float(rng.uniform(5, 80)))
        for tag in group:
            if tag != reqs[-1]:
                _ev(ev, name="request", cat="serve", ph="e", pid=0, tid=3,
                    ts=t_step + float(rng.uniform(1, 30)),
                    id=f"0:{reqs.index(tag) + 1}", args={"req": tag})
    return {"traceEvents": ev}


TRACES = {
    "remote": _remote_trace,
    "remote_skewed": lambda: _remote_trace(engine_shift=-800.0),
    "remote_slow_decode": lambda: _remote_trace(decode_dur=600.0),
    "gated_local": _gated_local_trace,
    "both": lambda: {"traceEvents": (_remote_trace()["traceEvents"]
                                     + _gated_local_trace()["traceEvents"])},
    "seeded": _seeded_trace,
    "lossy": lambda: {**_seeded_trace(seed=3), "lossy": True,
                      "ring_drops": {"0/worker-0": 100, "0/worker-1": 36,
                                     "2/pump": 7}},
}


def _path_tuple(cp):
    return None if cp is None else (cp.summary(), [tuple(iv) for iv in cp.intervals],
                                    cp.t0, cp.t1, dict(cp.by_class))


# ---------------------------------------------------------- critical paths
@pytest.mark.parametrize("name", list(TRACES))
def test_critical_path_matches_reference(name):
    tr = TRACES[name]()
    tags = r_cp.request_ids(tr)
    assert tags and t_cp.request_ids(tr) == tags
    ridx, tidx = r_cp.TraceIndex(tr), t_cp.TraceIndex(tr)
    for tag in tags + ["nope"]:
        want = _path_tuple(r_cp.critical_path(ridx, tag))
        assert _path_tuple(t_cp.critical_path(tidx, tag)) == want, tag
        assert _path_tuple(t_cp.critical_path(tr, tag)) == want, tag
    assert t_cp.flow_edges(tr) == r_cp.flow_edges(tr)
    assert t_cp.SLOW_CLASSES == r_cp.SLOW_CLASSES
    assert t_cp.CLASS_NAMES == r_cp.CLASS_NAMES and t_cp.CP_TID == r_cp.CP_TID


def test_critical_path_tiles_and_counts_clamps():
    """The port's own reading of the contract: every path tiles its
    request with no gap, and a backwards edge is clamped and counted."""
    for name in ("remote", "seeded"):
        tr = TRACES[name]()
        for tag in t_cp.request_ids(tr):
            cp = t_cp.critical_path(tr, tag)
            assert cp.intervals[0].t0 == cp.t0 and cp.intervals[-1].t1 == cp.t1
            for a, b in zip(cp.intervals, cp.intervals[1:]):
                assert b.t0 == a.t1
            assert sum(cp.by_class.values()) == pytest.approx(cp.total_us)
    cp = t_cp.critical_path(TRACES["remote_skewed"](), "r0:1")
    assert cp.clamped_count >= 1 and cp.clamped_us > 0.0
    seeded = TRACES["seeded"]()
    assert any(t_cp.critical_path(seeded, tag).clamped_count
               for tag in t_cp.request_ids(seeded))


@pytest.mark.parametrize("name", ["remote", "both", "seeded"])
def test_mark_critical_path_matches_reference(name):
    tr = TRACES[name]()
    for tag in r_cp.request_ids(tr):
        a, b = copy.deepcopy(tr), copy.deepcopy(tr)
        r_cp.mark_critical_path(a, r_cp.critical_path(a, tag))
        t_cp.mark_critical_path(b, t_cp.critical_path(b, tag))
        assert b == a


# ------------------------------------------------------------ attribution
@pytest.mark.parametrize("name", list(TRACES))
def test_slow_report_matches_reference(name):
    tr = TRACES[name]()
    want = r_attr.slow_report(tr)
    got = t_attr.slow_report(tr)
    assert got == want
    assert t_attr.slow_report(t_cp.TraceIndex(tr)) == want
    assert t_attr.format_report(got) == r_attr.format_report(want)
    for tag in r_cp.request_ids(tr):
        assert (t_attr.format_critical_path(t_cp.critical_path(tr, tag))
                == r_attr.format_critical_path(r_cp.critical_path(tr, tag)))
    assert sorted(t_attr.analyze_requests(tr)) == sorted(r_attr.analyze_requests(tr))
    assert t_attr.UNTIERED == r_attr.UNTIERED


def test_diff_reports_matches_reference():
    pairs = [("remote", "remote_slow_decode"), ("both", "seeded"),
             ("seeded", "gated_local")]
    for a, b in pairs:
        ra, rb = (r_attr.slow_report(TRACES[k]()) for k in (a, b))
        ta, tb = (t_attr.slow_report(TRACES[k]()) for k in (a, b))
        assert t_attr.diff_reports(ta, tb) == r_attr.diff_reports(ra, rb)


@pytest.mark.parametrize("name", ["remote", "both", "seeded"])
def test_fold_into_counters_matches_reference(name):
    tr = TRACES[name]()
    rreg, treg = rcounters.CounterRegistry(), tcounters.CounterRegistry()
    n = r_attr.fold_into_counters(r_attr.analyze_requests(tr), registry=rreg)
    assert t_attr.fold_into_counters(t_attr.analyze_requests(tr), registry=treg) == n
    assert treg.snapshot_stats("/obs{blame/*") == rreg.snapshot_stats("/obs{blame/*")
    assert treg.snapshot_export("*") == rreg.snapshot_export("*")


def test_fold_into_counters_default_registry():
    """Without a registry the fold lands in the port's default one."""
    cps = t_attr.analyze_requests(_remote_trace(tag="r0:4242"))
    before = tcounters.default().histogram("/obs{blame/interactive}/total").stats()["count"]
    assert t_attr.fold_into_counters(cps) == 1
    stats = tcounters.default().snapshot_stats("/obs{blame/interactive}*")
    assert stats["/obs{blame/interactive}/total"]["count"] == before + 1


# -------------------------------------------------------------- timelines
def _sweep(busy, idle, extra=None):
    pairs = [("/scheduler{default}/time/busy", busy),
             ("/scheduler{default}/time/idle", idle),
             ("/scheduler{default}/idle-rate", idle / (busy + idle)),
             ("/scheduler{default}/utilization", busy / (busy + idle))]
    return {0: pairs + (extra or [])}


def _sweeps(seed=0, n=40):
    rng = np.random.default_rng(seed)
    busy = idle = 0.0
    tok = 0.0
    out = []
    for i in range(n):
        busy += float(rng.uniform(0.1, 0.9))
        idle += float(rng.uniform(0.1, 0.9))
        tok = 0.0 if i == n // 2 else tok + float(rng.integers(1, 50))  # a reset
        s = _sweep(busy, idle, [("/serve{engine#0}/tokens/generated", tok)])
        if i % 7 == 3:
            s[2] = {"error": "ConnectionError('gone')"}
        out.append((float(i) * 0.25, s))
    return out


def _strip_wall(obj):
    if isinstance(obj, dict):
        return {k: _strip_wall(v) for k, v in obj.items()
                if k not in ("wall", "started_wall")}
    if isinstance(obj, list):
        return [_strip_wall(v) for v in obj]
    return obj


@pytest.mark.parametrize("max_records", [4096, 8])
def test_timeline_writer_matches_reference(tmp_path, max_records):
    paths = {}
    for pkg, ts in (("ref", r_ts), ("port", t_ts)):
        paths[pkg] = str(tmp_path / f"{pkg}.jsonl")
        with ts.TimelineWriter(paths[pkg], pattern="*", interval=0.25,
                               max_records=max_records,
                               meta={"launcher": "serve"}) as w:
            kept = [w.append(s, now=t) for t, s in _sweeps()]
        paths[pkg + "_state"] = (kept, w.stride, w.compactions, w.records_written)
    assert paths["port_state"] == paths["ref_state"]
    rh, rr = r_ts.read_timeline(paths["ref"])
    th, trr = t_ts.read_timeline(paths["port"])
    assert _strip_wall(th) == _strip_wall(rh) and _strip_wall(trr) == _strip_wall(rr)
    # the same file read by both: every digest equal
    for name in ("/scheduler{default}/time/busy", "/serve{engine#0}/tokens/generated"):
        assert t_ts.series(rr, 0, name) == r_ts.series(rr, 0, name)
    s_ref, s_port = r_ts.summarize(paths["ref"]), t_ts.summarize(paths["ref"])
    assert s_port == s_ref
    assert t_ts.format_summary(s_port) == r_ts.format_summary(s_ref)
    assert t_ts.VERSION == r_ts.VERSION


def test_timeline_rejects_what_the_reference_rejects(tmp_path):
    bad = tmp_path / "not_tl.jsonl"
    bad.write_text('{"foo": 1}\n')
    old = tmp_path / "old.jsonl"
    old.write_text('{"kind": "header", "version": 0}\n')
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for p in (bad, old, empty):
        with pytest.raises(ValueError) as r:
            r_ts.read_timeline(str(p))
        with pytest.raises(ValueError) as t:
            t_ts.read_timeline(str(p))
        assert str(t.value) == str(r.value)
    w = t_ts.TimelineWriter(str(tmp_path / "c.jsonl"))
    w.close()
    with pytest.raises(ValueError):
        w.append(_sweep(1.0, 1.0))
    with pytest.raises(ValueError):
        t_ts.TimelineWriter(str(tmp_path / "d.jsonl"), max_records=1)


# ------------------------------------------------------------ analyze CLI
def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_analyze_cli_trace_matches_reference(tmp_path):
    a, b, empty = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "e.json"
    a.write_text(json.dumps(TRACES["both"]()))
    b.write_text(json.dumps(TRACES["seeded"]()))
    empty.write_text(json.dumps({"traceEvents": []}))
    argvs = [
        [str(a)], [str(a), "--slow-report"], [str(a), "--slow-report", "--json"],
        [str(a), "--requests"], [str(a), "--requests", "--json"],
        [str(a), "--critical-path", "r0:1"], [str(a), "--critical-path", "r0:7", "--json"],
        [str(b), "--slow-report"], [str(b), "--critical-path", "r0:5"],
        ["--diff", str(a), str(b)], ["--diff", str(a), str(b), "--json"],
        [str(empty)], [str(empty), "--requests"],
    ]
    for argv in argvs:
        want = _run(r_analyze.main, argv)
        got = _run(t_analyze.main, argv)
        assert got == want, argv
    assert _run(t_analyze.main, [str(a), "--slow-report"])[0] == 0
    assert _run(t_analyze.main, [str(empty)])[0] == 1  # nothing to chew on


def test_analyze_cli_unknown_request_fails_like_reference(tmp_path, capsys):
    a = tmp_path / "a.json"
    a.write_text(json.dumps(_remote_trace()))
    assert r_analyze.main([str(a), "--critical-path", "nope"]) == 1
    want = capsys.readouterr()
    assert t_analyze.main([str(a), "--critical-path", "nope"]) == 1
    got = capsys.readouterr()
    assert got.err == want.err and "not found" in got.err


def test_analyze_cli_timeline_matches_reference(tmp_path):
    path = str(tmp_path / "tl.jsonl")
    with t_ts.TimelineWriter(path) as w:
        for t, s in _sweeps(seed=1, n=12):
            w.append(s, now=t)
    for argv in (["--timeline", path], ["--timeline", path, "--json"],
                 ["--timeline", str(tmp_path / "missing.jsonl")]):
        assert _run(t_analyze.main, argv) == _run(r_analyze.main, argv), argv
    rc, out = _run(t_analyze.main, ["--timeline", path, "--json"])
    assert rc == 0 and "L0 default" in json.loads(out)["utilization"]


# ----------------------------------------------------------------- export
def _buffers():
    """Raw per-thread rings as ``trace.export_buffers`` returns them: a
    span with args and flow ids, a bare span, an instant, a flow pair, a
    request's async begin / end, and a ring that dropped events."""
    return [
        {"tid": 140000000001, "thread_name": "worker-0", "dropped": 0,
         "events": [
             ("X", "router/submit", "serve", 1.0, 0.25, (0, 7), {"req": "r0:1", "slo": "batch"}),
             ("X", "decode_step", "serve", 2.0, 0.5, (0, 8), None),
             ("X", "bare", "t", 2.5, 0.125, None, {"k": 1}),
             ("i", "admit_stall", "serve", 3.0, 0.0, None, {"req": "r0:1"}),
             ("s", "send", "net", 3.5, 0.0, (0, 9), None),
             ("f", "recv", "net", 3.75, 0.0, (0, 9), None),
             ("b", "request", "serve", 1.0, 0.0, 4, {"req": "r0:1"}),
             ("e", "request", "serve", 4.0, 0.0, 4, None)]},
        {"tid": 7, "thread_name": "prefill-1", "dropped": 12,
         "events": [("X", "prefill", "serve", 1.5, 0.25, (0, 10), {"req": "r0:1"})]},
    ]


def test_chrome_conversion_matches_reference():
    bufs = _buffers()
    for pid, off in ((0, 0.0), (2, 0.5)):
        assert t_export._chrome_events(copy.deepcopy(bufs), pid, off) == \
            r_export._chrome_events(copy.deepcopy(bufs), pid, off)
        assert t_export._metadata(bufs, pid) == r_export._metadata(bufs, pid)


def _record(tracer):
    """The same activity on either package's recorder."""
    tracer.enable()
    fid = tracer.new_id()
    with tracer.span("router/submit", "serve", req="r0:1", slo="batch"):
        with tracer.span("send", "net", flow_out=fid, dst=1):
            pass
    with tracer.span("recv", "net", flow_in=fid):
        pass
    tracer.instant("mark", "t")
    tracer.async_begin("request", 5, "serve", req="r0:1")
    tracer.async_end("request", 5, "serve", req="r0:1")


def _shape(tr):
    """A merged trace minus what differs run to run: timestamps, thread
    and span ids (kept as the links they make)."""
    ids = {}

    def norm(v):
        return ids.setdefault(v, f"#{len(ids)}")

    out = []
    for e in tr["traceEvents"]:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
        if "id" in e:
            e["id"] = norm(e["id"])
        args = dict(e.get("args") or {})
        for k in ("sid", "parent"):
            if k in args:
                args[k] = norm(args[k])
        if args or "args" in e:
            e["args"] = args
        if e.get("name") == "thread_name":
            e["args"] = {}
        out.append(e)
    return out, {k: v for k, v in tr.items() if k != "traceEvents"}


def test_merged_trace_and_flow_links_match_reference():
    _record(r_trace)
    _record(t_trace)
    rtr, ttr = r_export.merged_trace(None), t_export.merged_trace(None)
    assert _shape(ttr) == _shape(rtr)
    by_ph = {}
    for e in ttr["traceEvents"]:
        by_ph.setdefault(e["ph"], []).append(e)
    assert {"M", "X", "s", "f", "i", "b", "e"} <= set(by_ph)
    assert all(x["ts"] >= 0 and x["dur"] >= 0 for x in by_ph["X"])
    assert by_ph["b"][0]["id"] == by_ph["e"][0]["id"]
    rl, tl = r_export.flow_links(rtr), t_export.flow_links(ttr)
    assert list(tl.values()) == list(rl.values()) == [{"src": 0, "dst": 0}]


def test_export_chrome_trace_writes_the_merged_trace(tmp_path):
    _record(t_trace)
    path = tmp_path / "t.json"
    tr = t_export.export_chrome_trace(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(tr))
    assert not tr.get("lossy")


def test_lossy_ring_marks_the_merged_trace():
    for tracer, exp in ((r_trace, r_export), (t_trace, t_export)):
        tracer.enable(capacity=64)
        for i in range(200):
            tracer.instant("spam", "t", i=i)
    rtr, ttr = r_export.merged_trace(None), t_export.merged_trace(None)
    assert ttr["lossy"] is True and rtr["lossy"] is True
    assert list(ttr["ring_drops"].values()) == list(rtr["ring_drops"].values()) == [136]
    assert t_attr.slow_report(ttr)["lossy"] is True


def test_fleet_controls_run_locally():
    t_export.enable_fleet(None, capacity=128)
    assert t_trace.enabled()
    t_trace.instant("x", "t")
    t_export.disable_fleet(None)
    assert not t_trace.enabled() and t_trace.recorded_events() == 1
    t_export.clear_fleet(None)
    assert t_trace.recorded_events() == 0


def test_remote_branches_raise():
    """Each branch the reference takes with a ``net`` goes over that net,
    never quietly over this process alone: handed an object that is not a
    runtime, each raises; over a runtime (here a single locality, no peers)
    each runs, and the merged trace holds that locality alone."""
    import repro_torch.core as tcore
    from repro_torch import net as tnet

    def calls(net):
        return [lambda: t_export.merged_trace(net=net),
                lambda: t_export.export_chrome_trace(os.devnull, net=net),
                lambda: t_export.enable_fleet(net),
                lambda: t_export.disable_fleet(net),
                lambda: t_export.clear_fleet(net),
                lambda: t_export.clock_offset(net, 1),
                lambda: t_recorder.FlightRecorder(net=net).start()]

    for call in calls(object()):
        with pytest.raises(AttributeError):
            call()
    tcore.init(num_workers=2)
    try:
        with tnet.running(1) as one:
            t_export.enable_fleet(one, capacity=128)
            t_trace.instant("x", "t")
            tr = t_export.merged_trace(net=one)
            assert {e["pid"] for e in tr["traceEvents"]} == {0}
            assert [e["name"] for e in tr["traceEvents"] if e["ph"] != "M"] == ["x"]
            assert t_export.clock_offset(one, 0) == 0.0
            for call in calls(one)[:5]:
                call()
            t_recorder.FlightRecorder(net=one).start().stop()
            assert not t_trace.enabled()
    finally:
        tcore.finalize()


# --------------------------------------------------------- flight recorder
class _StubController:
    """What ``FlightRecorder.install`` needs of a fleet controller."""

    def __init__(self):
        self.actuators, self.policies = {}, []

    def register(self, name, fn):
        self.actuators[name] = fn

    def add_policy(self, policy):
        self.policies.append(policy)


class _View:
    def __init__(self, p99, gated):
        self.latest = {(0, "/serve{engine#0}/request/latency/p99"): p99,
                       (0, "/serve{engine#0}/step/duration"): 9.0}
        self.gated_depth = gated
        self.occupancy = 0.5


def test_flight_recorder_dump_matches_reference(tmp_path, monkeypatch):
    """``dump`` on the same merged trace writes the same anomaly file:
    the worst request's path marked, the blame folded, the re-arm window
    suppressing a second dump."""
    tr = TRACES["both"]()
    out = {}
    for pkg, rec_mod, exp in (("ref", r_recorder, r_export),
                              ("port", t_recorder, t_export)):
        monkeypatch.setattr(exp, "merged_trace",
                            lambda net=None, probes=5: copy.deepcopy(tr))
        rec = rec_mod.FlightRecorder(out_dir=str(tmp_path / pkg),
                                     prefix="anomaly", rearm_s=3600.0).start()
        path = rec.dump(reason="manual", detail={"k": 1})
        assert path is not None and rec.dump() is None  # re-arm window
        assert rec.c_suppressed.get_value() >= 1
        out[pkg] = (json.loads(open(path).read()), rec.last_offender,
                    path.rsplit("/", 1)[-1])
        rec.stop()
    assert out["port"] == out["ref"]
    assert out["port"][0]["anomaly"]["offender"]["req"] == out["port"][1]


def test_flight_recorder_install_matches_reference(tmp_path, monkeypatch):
    tr = TRACES["seeded"]()
    fired = {}
    for pkg, rec_mod, exp in (("ref", r_recorder, r_export),
                              ("port", t_recorder, t_export)):
        monkeypatch.setattr(exp, "merged_trace",
                            lambda net=None, probes=5: copy.deepcopy(tr))
        rec = rec_mod.FlightRecorder(out_dir=str(tmp_path / pkg), rearm_s=0.0)
        ctl = _StubController()
        assert rec.install(ctl, p99_high=1.0, sustain=2) is rec
        assert sorted(ctl.actuators) == ["dump_trace"]
        rules = [(p.name, p.high, p.low, p.up, p.down, p.sustain, p.cooldown)
                 for p in ctl.policies]
        views = [_View(0.5, 0), _View(2.0, 0), _View(2.0, 1), _View(3.0, 2),
                 _View(0.1, 0), _View(0.1, 1), _View(0.1, 1)]
        fires = [[p.evaluate(v, now=float(i)) for p in ctl.policies]
                 for i, v in enumerate(views)]
        ctl.actuators["dump_trace"](views[3])
        with open(rec.last_path) as f:
            fired[pkg] = (rules, fires, json.load(f)["anomaly"])
    assert fired["port"] == fired["ref"]
    assert any(a == "dump_trace" for row in fired["port"][1] for a in row)


# ---------------------------------------------------------------- launcher
def test_serve_launcher_writes_what_the_analyzer_reads(tmp_path):
    """``launch.serve`` on the CPU with the reference's one-locality
    observability flags: the merged trace, its SLOW report, a ``/metrics``
    endpoint and a timeline, each read back by ``obs.analyze``; the fleet
    flags are refused with the reference's messages."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    tr, tl = tmp_path / "t.json", tmp_path / "tl.jsonl"
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "starcoder2_3b",
            "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "4"]
    r = subprocess.run(base + ["--trace", str(tr), "--slow-report", "--metrics-port", "0",
                               "--timeline", str(tl), "--print-counters", "/serve{router}*"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    report = json.loads(out[out.rindex("\n{") + 1:])
    assert report["slow_report"] == {"requests": 3, "tiers": ["untiered"]}
    assert report["timeline"]["records"] >= 2 and report["metrics_url"].endswith("/metrics")
    assert "requests analyzed: 3" in out and "/serve{router}/requests/dispatched" in out
    assert report["counters"]["/serve{engine#0}/request/first_token/p99"] > 0
    rc, text = _run(t_analyze.main, [str(tr)])
    assert rc == 0 and text == _run(r_analyze.main, [str(tr)])[1]
    rc, text = _run(t_analyze.main, ["--timeline", str(tl)])
    assert rc == 0 and text.startswith("timeline:")
    for flags, msg in ((["--slo"], "--fleet/--slo need --localities > 1"),
                       (["--fleet"], "--fleet/--slo need --localities > 1"),
                       (["--flight-recorder", "x"], "--flight-recorder needs --fleet"),
                       (["--slow-report"], "--slow-report needs --trace PATH")):
        r = subprocess.run(base + flags, capture_output=True, text=True, env=env, timeout=120)
        assert r.returncode == 2 and msg in r.stderr, (flags, r.stderr)
