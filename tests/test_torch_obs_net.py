"""The port's observability tier over real localities: the remote branches
of ``obs.export`` / ``sampler`` / ``metrics`` / ``recorder``.

- ``tests/test_obs_distributed.py``'s cases: a 3-locality merged trace
  whose parcel flows link sender and receiver spans, the clock-offset
  handshake, remote counter stats with percentiles, the fleet sampler;
- the 3-locality fleet cases of ``tests/test_obs_analyzer.py``: >= 95 %
  attribution of every traced request (remote ones crossing the wire with
  a latency segment), a batch flood tripping the controller's
  ``dump_trace`` into a cross-locality anomaly trace, and a skewed worker
  clock whose edges clamp instead of running backwards;
- ``tests/test_obs_metrics.py::test_fleet_scrape_two_localities``.

Smoke starcoder2_3b in fp32 on the CPU; every ``get`` carries a timeout.
Helper actions are module-level: workers resolve them by dotted name."""

import contextlib
import json
import os

import numpy as np
import pytest

import repro_torch.core as tcore
from repro_torch import net as tnet
from repro_torch.core import counters
from repro_torch.net import remote
from repro_torch.obs import attribution, export, trace
from repro_torch.obs import critical_path as cpm
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.router import TIER_BATCH, TIER_INTERACTIVE, Router

POOLS = {"default": 4, "prefill": 2, "io": 1}


def touch_percentile_timer(rt):
    counters.default().timer("/obs/remote/lat", percentiles=True).add(0.01)
    return True


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture()
def port_fleet():
    tcore.init(num_workers=4)
    try:
        with contextlib.ExitStack() as stack:
            yield lambda n, **kw: stack.enter_context(tnet.running(n, **kw))
    finally:
        tcore.finalize()


# ------------------------------------------------- test_obs_distributed.py
def test_three_locality_merged_trace_causal_links(port_fleet, tmp_path):
    net = port_fleet(3)
    export.enable_fleet(net)
    try:
        remote.run_on(1, remote._install_state, "/obs/t/a", {"v": 1}).get(timeout=60)
        remote.run_on(2, remote._install_state, "/obs/t/b", {"v": 2}).get(timeout=60)
        assert tnet.fetch("/obs/t/a") == {"v": 1}
        assert tnet.fetch("/obs/t/b") == {"v": 2}
        path = tmp_path / "merged.json"
        tr = export.export_chrome_trace(str(path), net=net)
    finally:
        export.disable_fleet(net)
    assert path.exists() and path.stat().st_size > 0
    assert {e["pid"] for e in tr["traceEvents"]} == {0, 1, 2}
    starts = {e["id"]: e["pid"] for e in tr["traceEvents"] if e["ph"] == "s"}
    execs = [e for e in tr["traceEvents"] if e["ph"] == "X"
             and e["name"].startswith("execute:") and "parent" in e.get("args", {})]
    assert execs
    cross = 0
    for e in execs:
        assert e["args"]["parent"] in starts, f"orphan execute span: {e}"
        cross += starts[e["args"]["parent"]] != e["pid"]
    assert cross > 0
    links = export.flow_links(tr)
    complete = {k: v for k, v in links.items()
                if v["src"] is not None and v["dst"] is not None and v["src"] != v["dst"]}
    assert {(v["src"], v["dst"]) for v in complete.values()} >= {(0, 1), (0, 2)}


def test_clock_offset_roundtrip(port_fleet):
    net = port_fleet(2)
    off = export.clock_offset(net, 1)
    assert off != 0.0  # distinct perf_counter epochs
    assert export.clock_offset(net, net.locality) == 0.0
    assert abs(off - export.clock_offset(net, 1)) < 0.5


def test_remote_counter_stats_have_percentiles(port_fleet):
    port_fleet(2)
    remote.run_on(1, touch_percentile_timer).get(timeout=60)
    stats = tnet.query_counter_stats(1, "/obs/remote/*")
    assert stats["/obs/remote/lat"]["count"] == 1.0 and "p99" in stats["/obs/remote/lat"]


def test_fleet_sampler_over_localities(port_fleet):
    from repro_torch.obs.sampler import FleetSampler

    net = port_fleet(2)
    s = FleetSampler(pattern="/net{locality*", net=net)
    assert s._localities() == [0, 1]
    s.sample_once()
    s.sample_once()
    assert {loc for loc, _name in s.keys()} == {0, 1}


def test_fleet_scrape_two_localities(port_fleet):
    from repro_torch.net.httpd import http_get
    from repro_torch.obs import metrics as M

    net = port_fleet(2)
    h = counters.default().histogram("/serve{engine#0}/request/latency")
    for v in (0.01, 0.02, 0.04):
        h.add(v)
    with M.MetricsExporter(net=net) as ex:
        status, body = http_get(ex.url, timeout=120.0)
    assert status == 200
    fams = M.parse_prometheus_text(body, strict=True)
    assert "repro_serve_request_latency" in [f for f, i in fams.items()
                                             if i["type"] == "histogram"]
    locs = {labels.get("locality") for info in fams.values() if info["type"] == "counter"
            for _n, labels, _v in info["samples"]}
    assert {"0", "1"} <= locs
    ups = {labels["locality"]: v for _n, labels, v in fams["repro_up"]["samples"]}
    assert ups.get("0") == 1.0 and ups.get("1") == 1.0
    for _n, labels, v in fams["repro_scheduler_idle_rate"]["samples"]:
        assert 0.0 <= v <= 1.0 and "pool" in labels


# ---------------------------------------------- test_obs_analyzer.py fleet
@pytest.fixture(scope="module")
def fleet():
    tcore.init(pools=POOLS)
    try:
        with tnet.running(3, pools=POOLS, worker_pools=POOLS) as net:
            scfg = ServeConfig(max_batch=2, cache_len=96, max_new_tokens=24)
            router = Router.over_localities(
                net, "starcoder2_3b", scfg, smoke=True, device="cpu", dtype="float32",
                tiers={"engine#1": TIER_INTERACTIVE, "engine#2": TIER_BATCH})
            try:
                yield net, router
            finally:
                router.engines[0].close()
    finally:
        tcore.finalize()


def _prompts(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=rng.integers(4, 16)).tolist() for _ in range(n)]


def test_traced_fleet_attribution_covers_95_percent(fleet):
    net, router = fleet
    export.enable_fleet(net)
    try:
        futs = [router.submit(p, slo=TIER_INTERACTIVE) for p in _prompts(2, seed=3)]
        futs += [router.submit(p, slo=TIER_BATCH) for p in _prompts(2)]
        futs += [router.submit(p) for p in _prompts(1, seed=5)]
        for f in futs:
            assert len(f.get(timeout=120)) == 25
        tr = export.merged_trace(net)
    finally:
        export.disable_fleet(net)
    idx = cpm.TraceIndex(tr)
    tags = cpm.request_ids(idx)
    assert len(tags) >= 5
    cps = attribution.analyze_requests(idx)
    assert set(cps) == set(tags)
    for tag, cp in cps.items():
        assert cp.fraction >= 0.95, (tag, cp.summary())
        s = cp.summary()
        assert s["attributed_us"] + s["residual_us"] >= 0.95 * s["total_us"]
    remote_cps = [cp for cp in cps.values() if cp.slo == TIER_INTERACTIVE]
    assert remote_cps
    assert all(len(cp.localities()) >= 2 for cp in remote_cps)
    assert all(cp.by_class["L"] > 0.0 for cp in remote_cps)
    assert all(e["transit_us"] >= 0.0 for e in cpm.flow_edges(idx))
    rep = attribution.slow_report(idx, cps)
    assert {TIER_INTERACTIVE, TIER_BATCH} <= set(rep["tiers"])
    p99s = dict(counters.query("/serve{*}/request/latency/p99"))
    assert p99s and max(p99s.values()) > 0.0


def test_batch_flood_trips_flight_recorder_cross_locality(fleet, tmp_path):
    from repro_torch.fleet import AdmissionController, FleetController
    from repro_torch.obs.recorder import FlightRecorder

    net, router = fleet
    rec = FlightRecorder(net, out_dir=str(tmp_path), capacity=16384, rearm_s=120.0, probes=2)
    rec.start()
    sig = {"occ": 0.95}
    flood = []
    try:
        for f in [router.submit(p, slo=TIER_INTERACTIVE) for p in _prompts(3, seed=11)]:
            assert len(f.get(timeout=120)) == 25
        router.admission = AdmissionController(lambda: sig["occ"], high=0.85, low=0.60)
        flood = [router.submit(p, slo=TIER_BATCH) for p in _prompts(4, seed=13)]
        assert router.gated_depth() == 4
        controller = FleetController(net, router, interval=60.0)
        rec.install(controller, gate_trigger=True, error_trigger=False, sustain=1)
        controller.tick()
        path = rec.last_path
        assert path is not None and os.path.exists(path)
        assert rec.c_dumps.get_value() == 1.0
        with open(path) as f:
            tr = json.load(f)
        assert tr["anomaly"]["reason"] == "controller"
        assert tr["anomaly"]["detail"]["gated_depth"] >= 1
        assert tr["anomaly"]["requests_analyzed"] >= 3
        off = tr["critical_path"]
        assert off["req"] == rec.last_offender
        assert len(off["localities"]) >= 2 and off["fraction"] >= 0.95
        marked = [e for e in tr["traceEvents"] if e.get("cat") == "anomaly"]
        assert marked and {e["tid"] for e in marked} == {cpm.CP_TID}
        assert {e["pid"] for e in marked} >= set(off["localities"])
        controller.tick()
        assert rec.c_dumps.get_value() == 1.0
        blame = counters.default().snapshot_stats("/obs{blame/*")
        assert any("/total" in k for k in blame)
    finally:
        sig["occ"] = 0.10
        router.release_gated()
        for f in flood:
            assert len(f.get(timeout=120)) == 25
        router.admission = None
        rec.stop()


def test_skewed_worker_clock_edges_clamp_not_reverse(fleet):
    net, router = fleet
    remote.run_on(1, export._obs_set_probe_skew, 0.05).get(timeout=60)
    export.enable_fleet(net)
    try:
        for f in [router.submit(p, slo=TIER_INTERACTIVE) for p in _prompts(2, seed=17)]:
            assert len(f.get(timeout=120)) == 25
        tr = export.merged_trace(net)
    finally:
        export.disable_fleet(net)
        remote.run_on(1, export._obs_set_probe_skew, 0.0).get(timeout=60)
    edges = cpm.flow_edges(tr)
    into_skewed = [e for e in edges if e["dst"] == 1 and e["src"] != 1]
    assert into_skewed
    assert any(e["clamped"] and e["raw_us"] < 0.0 for e in into_skewed)
    assert all(e["transit_us"] >= 0.0 for e in edges)
    cps = attribution.analyze_requests(tr)
    assert cps
    for cp in cps.values():
        assert all(iv.t1 >= iv.t0 for iv in cp.intervals)
        assert cp.fraction >= 0.95
    assert sum(cp.clamped_count for cp in cps.values()) >= 1


def test_print_counter_report_over_the_fleet(fleet):
    """The ``--print-counters`` report sweeps every locality."""
    import io

    from repro_torch.obs.sampler import print_counter_report

    net, router = fleet
    buf = io.StringIO()
    lines = print_counter_report("/serve{engine*}/tokens/generated", net=net, file=buf)
    text = buf.getvalue()
    for lid in net.live_ids():
        assert f"L{lid} /serve{{engine#{lid}}}/tokens/generated" in text
    assert len(lines) == text.count("\n") and "UNREACHABLE" not in text
