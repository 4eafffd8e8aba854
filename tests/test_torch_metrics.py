"""The port's export tier against the reference's: the OpenMetrics
renderer and its strict parser (``obs.metrics``), the HTTP listener
(``net.httpd``), the counter sampler and the ``--print-counters`` report
(``obs.sampler``).

Each case gives both packages the same counters (made the same way in a
registry of each) or the same sweep, and compares the rendered text, the
parsed families, the series and the rates exactly (tolerance 0, except
where ``tests/test_obs_counters.py`` states one).  A scrape of the
exporter goes over real HTTP on ``127.0.0.1:0``.  A fleet-wide sweep goes
over the port's multi-locality runtime (``tests/test_torch_obs_net.py``
scrapes two real localities)."""
import io
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import counters as RC
from repro.net import httpd as r_httpd
from repro.obs import metrics as RM
from repro.obs import sampler as r_sampler
from repro_torch.core import counters as TC
from repro_torch.net import httpd as t_httpd
from repro_torch.obs import metrics as TM
from repro_torch.obs import sampler as t_sampler

ROOT = Path(__file__).resolve().parents[1]


def _fill(C, seed=0):
    """The same counters of every kind in a fresh registry of package
    ``C``: values drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    reg = C.CounterRegistry()
    reg.counter("/scheduler{default}/tasks/cumulative").increment(42)
    reg.counter("/serve{engine#0}/requests/completed").increment(19)
    reg.gauge("/fleet{controller}/occupancy").set(0.75)
    reg.gauge("/fleet{admission}/open").set(1.0)
    reg.register_callable("/scheduler{default}/idle-rate", lambda: 0.125)
    reg.register_callable("/scheduler{default}/time/busy", lambda: 9.5, kind="counter")
    reg.register_callable("/serve{engine#0}/request/latency/p99", lambda: 0.25)
    reg.counter("/net{locality#0/peer#1}/parcels/sent").increment(3)
    reg.counter("/scheduler{default}/steals/victim#0/thief#1").increment(2)
    h = reg.histogram("/serve{engine#0}/request/latency")
    for v in [0.001, 0.002, 0.5, 1.0, -1.0, 0.004] * 3:
        h.add(v)
    t = reg.timer("/serve{engine#0}/step/duration", percentiles=True)
    for v in rng.lognormal(-4.0, 1.0, size=300):
        t.add(float(v))
    b = reg.histogram("/obs{blame/interactive}/waiting")
    for v in rng.exponential(0.01, size=50):
        b.add(float(v))
    return reg


# ------------------------------------------------------------ name mapping
@pytest.mark.parametrize("path", [
    "/scheduler{default}/idle-rate",
    "/scheduler{default}/steals/victim#0/thief#1",
    "/serve{engine#2}/request/latency",
    "/serve{engine#0}/request/first_token/p99",
    "/obs{blame/compute}/total",
    "/net{locality#0/peer#1}/credit/inflight_bytes",
    "/fleet{admission}/open",
    "/serve{router}/dispatch/engine#1",
    "/migration/trees/cumulative",
    "plain-name",
])
def test_counter_to_metric_matches_reference(path):
    got = TM.counter_to_metric(path)
    assert got == RM.counter_to_metric(path)
    assert TM._NAME_OK_RE.match(got[0])


# ------------------------------------------------------------- round trip
def test_render_parse_round_trip_matches_reference():
    rreg, treg = _fill(RC), _fill(TC)
    rsweep = {0: rreg.snapshot_export("*"), 1: {"error": "ConnectionError('peer gone')"}}
    tsweep = {0: treg.snapshot_export("*"), 1: {"error": "ConnectionError('peer gone')"}}
    assert tsweep == rsweep
    text = TM.render_openmetrics(tsweep)
    assert text == RM.render_openmetrics(rsweep)
    fams = TM.parse_prometheus_text(text, strict=True)
    assert fams == RM.parse_prometheus_text(text, strict=True)
    assert fams["repro_scheduler_tasks_cumulative_total"]["type"] == "counter"
    assert fams["repro_scheduler_idle_rate"]["type"] == "gauge"
    hist = fams["repro_serve_request_latency"]
    buckets = [(labels["le"], v) for name, labels, v in hist["samples"]
               if name.endswith("_bucket")]
    assert buckets[-1] == ("+Inf", 18)
    assert [v for _, v in buckets] == sorted(v for _, v in buckets)
    ups = {labels["locality"]: v for _n, labels, v in fams["repro_up"]["samples"]}
    assert ups == {"0": 1.0, "1": 0.0}


@pytest.mark.parametrize("raw", ['weird\\value"with\nnewline', "plain",
                                 'a\\nb', '"', "\\"])
def test_label_escaping_matches_reference(raw):
    assert TM._escape_label(raw) == RM._escape_label(raw)
    assert TM._escape_help(raw) == RM._escape_help(raw)
    line = f'm_x{{a="{TM._escape_label(raw)}",b="x"}} 1\n'
    fams = TM.parse_prometheus_text("# TYPE m_x gauge\n" + line, strict=True)
    assert fams == RM.parse_prometheus_text("# TYPE m_x gauge\n" + line, strict=True)
    (_n, labels, v) = fams["m_x"]["samples"][0]
    assert labels == {"a": raw, "b": "x"} and v == 1.0


def test_bucket_cap_matches_reference():
    regs = []
    for C in (RC, TC):
        reg = C.CounterRegistry()
        h = reg.histogram("/serve{engine#0}/step/duration")
        for i in range(200):  # hundreds of distinct log buckets
            h.add(1.0001 * (1.2 ** (i % 90)))
        regs.append(reg)
    text = TM.render_openmetrics({0: regs[1].snapshot_export("*")})
    assert text == RM.render_openmetrics({0: regs[0].snapshot_export("*")})
    fams = TM.parse_prometheus_text(text, strict=True)
    buckets = [s for s in fams["repro_serve_step_duration"]["samples"]
               if s[0].endswith("_bucket")]
    assert len(buckets) <= TM.BUCKET_CAP + 1 and buckets[-1][2] == 200
    raw = [(float(2 ** i), i + 1) for i in range(100)]
    for cap in (1, 2, 5, 32):
        merged = TM._merge_buckets(raw, cap)
        assert merged == RM._merge_buckets(raw, cap)
        assert len(merged) <= cap and sum(c for _, c in merged) == sum(c for _, c in raw)


@pytest.mark.parametrize("v", [0.0, 1.0, -3.0, 0.1, 1e15, 1e16, 2.5e-7,
                               math.inf, -math.inf, math.nan])
def test_value_format_matches_reference(v):
    assert TM._fmt(v) == RM._fmt(v)


@pytest.mark.parametrize("bad", [
    "no_type_declared 1\n",                                   # undeclared
    "# TYPE m counter\nm 1\n",                                # no _total
    "# TYPE m counter\nm_total -5\n",                         # negative
    "# TYPE m histogram\nm_bucket{le=\"1\"} 2\nm_count 2\n",  # no +Inf
    ("# TYPE m histogram\nm_bucket{le=\"1\"} 5\n"
     "m_bucket{le=\"+Inf\"} 2\nm_count 2\n"),                 # non-monotone
    ("# TYPE m histogram\nm_bucket{le=\"+Inf\"} 3\n"
     "m_count 7\n"),                                          # +Inf != count
    "# TYPE m wobbly\nm 1\n",                                 # unknown type
    "# TYPE m gauge\n# TYPE m counter\nm_total 1\n",          # redeclared
    "# TYPE m gauge\nm{a=1} 1\n",                             # bad labels
    "# TYPE m gauge\nm 1 2 3\n",                              # bad sample
    "# TYPE m histogram\nm_bucket 1\nm_count 1\n",            # no le
])
def test_strict_parser_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as r:
        RM.parse_prometheus_text(bad, strict=True)
    with pytest.raises(ValueError) as t:
        TM.parse_prometheus_text(bad, strict=True)
    assert str(t.value) == str(r.value)


def test_lenient_parse_matches_reference():
    text = "no_type_declared 1\n# plain comment\n# TYPE m counter\nm 2\n"
    assert TM.parse_prometheus_text(text, strict=False) == \
        RM.parse_prometheus_text(text, strict=False)


def test_error_kind_records_become_scrape_error_gauge():
    sweep = {0: {"/fleet{x}/boom": {"kind": "error", "error": "ZeroDiv"},
                 "/fleet{x}/ok": {"kind": "gauge", "value": 1.0}},
             2: {"error": "PortClosed('peer 2 gone')"}}
    text = TM.render_openmetrics(sweep)
    assert text == RM.render_openmetrics(sweep)
    fams = TM.parse_prometheus_text(text, strict=True)
    (_n, labels, v) = fams["repro_scrape_counter_errors"]["samples"][0]
    assert labels["locality"] == "0" and v == 1.0
    assert "repro_fleet_ok" in fams
    for marker in ({"error": "x"}, {"error": "x", "/a": 1}, {"/a": 1}, [1]):
        assert TM._is_error_marker(marker) == RM._is_error_marker(marker)


# ------------------------------------------------- live endpoint, 1 locality
def test_http_endpoint_scrape_local(port_rt):
    """The exporter serves ``/metrics`` through ``net.httpd``; one scrape
    reads back, strictly parsed, what the reference renders from the same
    counters."""
    treg, rreg = _fill(TC), _fill(RC)
    want = RM.render_openmetrics({0: rreg.snapshot_export("*")})
    with TM.MetricsExporter(registry=treg, port=0) as ex:
        assert ex.url == f"http://127.0.0.1:{ex.port}/metrics"
        status, body = t_httpd.http_get(ex.url)
        assert status == 200 and body == want
        fams = TM.parse_prometheus_text(body, strict=True)
        assert "repro_serve_request_latency" in fams
        assert t_httpd.http_get(f"http://127.0.0.1:{ex.port}/")[1] == want
        status, _ = r_httpd.http_get(f"http://127.0.0.1:{ex.port}/nope")
        assert status == 404
        assert ex.scrapes == 2
    with pytest.raises(RuntimeError, match="not started"):
        ex.port


def test_http_endpoint_answers_like_reference():
    """The listener alone: the same handler behind each package's
    endpoint gives the same status, type and body."""
    def handler(path):
        if path == "/boom":
            raise RuntimeError("handler failed")
        return 200, "text/plain; charset=utf-8", f"path={path}\n".encode()

    got = {}
    for pkg, H in (("ref", r_httpd), ("port", t_httpd)):
        with H.HttpEndpoint(handler, port=0) as ep:
            assert ep.host == "127.0.0.1" and ep.port > 0
            base = f"http://127.0.0.1:{ep.port}"
            got[pkg] = [H.http_get(base + p) for p in ("/a", "/b?q=1", "/boom")]
    assert got["port"] == got["ref"]
    assert got["port"][0] == (200, "path=/a\n") and got["port"][2][0] == 500


# ------------------------------------------------------------ fleet sampler
def _sample(S, C, steps, depth=240):
    """Drive a sampler of package ``S`` over a registry of package ``C``
    through ``steps`` = [(increment, reset_before)], with the sampler's
    clock pinned so that both packages see the same timestamps."""
    reg = C.CounterRegistry()
    c = reg.counter("/work/done")
    g = reg.gauge("/work/depth")
    s = S.FleetSampler(pattern="/work/*", depth=depth, registry=reg)
    clock = iter(np.arange(len(steps)) * 0.5 + 100.0)
    orig = S.time.perf_counter
    S.time.perf_counter = lambda: float(next(clock))
    try:
        for inc, reset in steps:
            if reset:
                c.reset()
            c.increment(inc)
            g.set(inc * 0.5)
            s.sample_once()
    finally:
        S.time.perf_counter = orig
    return s


@pytest.mark.parametrize("depth", [240, 5])
def test_sampler_series_and_rates_match_reference(depth):
    rng = np.random.default_rng(4)
    steps = [(int(rng.integers(1, 50)), i == 7) for i in range(12)]
    rs, ts = _sample(r_sampler, RC, steps, depth), _sample(t_sampler, TC, steps, depth)
    assert ts.keys() == rs.keys() == [(0, "/work/depth"), (0, "/work/done")]
    for key in ts.keys():
        assert ts.series(*key) == rs.series(*key)
        assert ts.rate(*key) == rs.rate(*key)
        assert ts.latest(*key) == rs.latest(*key)
    assert len(ts.series(0, "/work/done")) == min(depth, 12)
    assert ts.rates("/work/d*") == rs.rates("/work/d*")
    assert ts.latest(0, "/nothing") is None and ts.rate(0, "/nothing") == 0.0
    assert ts.samples_taken == rs.samples_taken == 12


def test_sampler_rate_across_counter_reset():
    """A reset contributes the post-reset value, as in the reference."""
    ts = _sample(t_sampler, TC, [(100, False), (50, False), (20, True)])
    assert ts.rate(0, "/work/done") == pytest.approx((50 + 20) / 1.0)


def test_sampler_feeds_a_timeline(tmp_path):
    from repro_torch.obs.timeseries import TimelineWriter, read_timeline

    reg = TC.CounterRegistry()
    reg.counter("/w").increment()
    with TimelineWriter(str(tmp_path / "tl.jsonl")) as tl:
        s = t_sampler.FleetSampler(pattern="/w", registry=reg, timeline=tl)
        s.sample_once()
        reg.counter("/w").increment()
        s.sample_once()
    _, recs = read_timeline(str(tmp_path / "tl.jsonl"))
    assert [r["sweep"]["0"]["/w"] for r in recs] == [1.0, 2.0]
    s.sample_once()  # the closed writer is dropped, not raised
    assert s.timeline is None


def test_sampler_thread_start_stop():
    reg = TC.CounterRegistry()
    reg.counter("/w").increment()
    s = t_sampler.FleetSampler(pattern="/w", interval=0.01, registry=reg).start()
    try:
        deadline = time.time() + 5.0
        while s.samples_taken < 3 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        s.stop()
    assert s.samples_taken >= 3


def test_print_counter_report_matches_reference():
    """The same counters in each package's default registry, one report
    each: the same lines (the blame histograms ride along)."""
    out = {}
    for pkg, C, S in (("ref", RC, r_sampler), ("port", TC, t_sampler)):
        reg = C.default()
        reg.counter("/obsreport{demo}/count").increment(7)
        t = reg.timer("/obsreport{demo}/lat", percentiles=True)
        for v in (0.002, 0.004, 0.001):
            t.add(v)
        reg.histogram("/obs{blame/obsreport}/waiting").add(0.003)
        buf = io.StringIO()
        lines = S.print_counter_report("/obsreport*", file=buf)
        assert buf.getvalue().count("\n") == len(lines)
        out[pkg] = [ln for ln in lines
                    if "obsreport" in ln or ln.startswith("counter")]
    assert out["port"] == out["ref"] and len(out["port"]) == 4


def test_fleet_sweeps_raise():
    """A fleet sweep goes over the multi-locality runtime, never quietly
    over this process alone: given a ``net`` but no runtime up, each
    raises; over a runtime (here a single locality) each sweeps it."""
    import repro_torch.core as tcore
    from repro_torch import net as tnet

    net = object()
    for call in (lambda: TM.MetricsExporter(net=net).sweep(),
                 lambda: TM.MetricsExporter(net=net).scrape(),
                 lambda: t_sampler.FleetSampler(net=net).sample_once(),
                 lambda: t_sampler.print_counter_report("*", net=net, file=io.StringIO())):
        with pytest.raises(RuntimeError, match="no multi-locality runtime"):
            call()
    with pytest.raises(AttributeError):
        t_sampler.FleetSampler(net=net)._localities()
    tcore.init(num_workers=2)
    try:
        with tnet.running(1) as one:
            TC.default().counter("/obsnet{one}/count").increment(3)
            assert TM.MetricsExporter(net=one).sweep()[0]["/obsnet{one}/count"]["value"] == 3.0
            fams = TM.parse_prometheus_text(TM.MetricsExporter(net=one).scrape(), strict=True)
            assert fams["repro_up"]["samples"][0][2] == 1.0
            s = t_sampler.FleetSampler(pattern="/obsnet*", net=one)
            assert s._localities() == [0]
            s.sample_once()
            assert s.keys() == [(0, "/obsnet{one}/count")]
            lines = t_sampler.print_counter_report("/obsnet*", net=one, file=io.StringIO())
            assert any("/obsnet{one}/count" in ln for ln in lines)
    finally:
        tcore.finalize()


def test_export_tier_imports_without_jax_or_reference():
    """``repro_torch.net`` (the listener and the multi-locality runtime), the
    relay, the fleet and the ``obs`` modules import in a process where
    neither ``jax`` nor ``repro`` can be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.net, repro_torch.obs.metrics\n"
        "import repro_torch.obs.critical_path, repro_torch.obs.attribution\n"
        "import repro_torch.obs.timeseries, repro_torch.obs.analyze\n"
        "import repro_torch.obs.sampler, repro_torch.obs.export\n"
        "import repro_torch.obs.recorder, repro_torch.fleet\n"
        "import repro_torch.serve.relay, repro_torch.fleet.migrate\n"
        "assert {'httpd', 'bootstrap', 'running', 'run_on'} <= set(repro_torch.net.__all__)\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro') for m in sys.modules)\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime."""
    import repro_torch.core as core

    runtime = core.init(num_workers=2, policy="local")
    yield runtime
    core.finalize()
