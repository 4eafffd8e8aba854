"""The port's live fleet dashboard (``repro_torch.obs.top``) against the
reference's (``tests/test_obs_timeline.py``'s fleet-top cases): the same
flat snapshot renders the same frame text in both, the same OpenMetrics
exposition parses to the same snapshot, a sampler-fed frame, and
``top --once`` (in process and as ``python -m repro_torch.obs.top --once
--metrics URL``) against a port exporter."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import counters as RC
from repro.obs import metrics as RM
from repro.obs import top as RT
from repro_torch.core import counters as TC
from repro_torch.obs import metrics as TM
from repro_torch.obs import top as TT

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def port_rt():
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


FLATS = {
    "empty": {},
    "pools": {(0, "/scheduler{default}/utilization"): 0.8,
              (0, "/scheduler{default}/idle-rate"): 0.2,
              (0, "/scheduler{default}/queue/worker#0/depth"): 3.0,
              (0, "/scheduler{default}/queue/worker#1/depth"): 1.0,
              (0, "/scheduler{default}/queue/high/depth"): 2.0,
              (1, "/scheduler{io}/utilization"): 1.7,
              (1, "/scheduler{io}/queue/worker#0/depth"): 0.0},
    "fleet": {(0, "/scheduler{default}/utilization"): 0.25,
              (0, "/serve{engine#0}/request/latency/p99"): 0.125,
              (0, "/serve{engine#0}/request/first_token/p99"): 0.0031,
              (2, "/serve{engine#2}/request/latency/p99"): 1.5,
              (0, "/net{locality#0/peer#1}/credit/inflight_bytes"): 4096.0,
              (0, "/net{locality#0/peer#1}/credit/blocked"): 2.0,
              (1, "/net{locality#1/peer#0}/credit/deferred"): 1.0,
              (0, "/serve{router}/admission/depth"): 7.0,
              (0, "/serve{router}/admission/gated"): 3.0,
              (0, "/fleet{admission}/open"): 0.0,
              (2, "/fleet{admission}/open"): 1.0,
              (1, "/serve{router}/admission/depth"): 1.0},
}


@pytest.mark.parametrize("which", sorted(FLATS))
def test_render_frame_matches_reference(which):
    flat = FLATS[which]
    t, r = TT.snapshot_from_flat(flat), RT.snapshot_from_flat(flat)
    assert t == r
    for now in (0.0, 12.34):
        assert TT.render_frame(t, now=now) == RT.render_frame(r, now=now)


def _registry(mod):
    reg = mod.CounterRegistry()
    reg.register_callable("/scheduler{default}/utilization", lambda: 0.8)
    reg.register_callable("/scheduler{default}/idle-rate", lambda: 0.2)
    reg.register_callable("/scheduler{default}/queue/worker#0/depth", lambda: 3.0)
    reg.register_callable("/scheduler{default}/queue/high/depth", lambda: 1.0)
    reg.gauge("/serve{engine#1}/request/latency/p99").set(0.125)
    reg.gauge("/serve{engine#1}/request/first_token/p99").set(0.02)
    reg.gauge("/net{locality#0/peer#1}/credit/inflight_bytes").set(4096)
    reg.counter("/net{locality#0/peer#1}/credit/blocked").increment(3)
    reg.gauge("/serve{router}/admission/depth").set(5)
    reg.counter("/serve{router}/admission/gated").increment(2)
    reg.gauge("/fleet{admission}/open").set(1.0)
    return reg


def test_snapshot_from_metrics_matches_reference():
    """Each package's exposition of the same counters parses, in each
    package, to the same snapshot and frame."""
    t_text = TM.render_openmetrics({0: _registry(TC).snapshot_export("*"),
                                    1: {"error": "down"}})
    r_text = RM.render_openmetrics({0: _registry(RC).snapshot_export("*"),
                                    1: {"error": "down"}})
    snaps = [mod.snapshot_from_metrics(text) for mod in (TT, RT) for text in (t_text, r_text)]
    assert all(s == snaps[0] for s in snaps)
    pool = snaps[0]["pools"][(0, "default")]
    assert pool["util"] == 0.8 and pool["idle"] == 0.2 and pool["queue"] == 3.0
    assert snaps[0]["serve"][(0, 1)] == {"latency": 0.125, "first_token": 0.02}
    assert snaps[0]["admission"][0] == {"depth": 5.0, "gated": 2.0, "open": 1.0}
    assert TT.render_frame(snaps[0], now=1.0) == RT.render_frame(snaps[0], now=1.0)


def test_top_snapshot_and_frame_from_sampler(port_rt):
    import repro_torch.core as core
    from repro_torch.obs.sampler import FleetSampler

    ex = port_rt.get_executor("default")
    for f in [ex.async_execute(lambda: sum(range(5000))) for _ in range(30)]:
        f.get()
    sampler = FleetSampler(pattern="*", net=None)
    sampler.sample_once()
    snap = TT.snapshot_from_sampler(sampler)
    assert any(pool == "default" for (_loc, pool) in snap["pools"])
    frame = TT.render_frame(snap)
    assert "fleet-top" in frame and "scheduler{default}" in frame
    assert core.counters.get_value("/scheduler{default}/time/busy") > 0


def test_top_cli_once(port_rt, capsys):
    assert TT.main(["--once"]) == 0
    assert "fleet-top" in capsys.readouterr().out


def test_top_once_against_a_port_exporter(port_rt, capsys):
    """``--once --metrics URL`` scrapes a live port exporter, in process
    and as ``python -m repro_torch.obs.top``; a failed scrape returns 1."""
    TC.gauge("/serve{engine#3}/request/latency/p99").set(0.25)
    exporter = TM.MetricsExporter(net=None, port=0).start()
    try:
        assert TT.main(["--once", "--metrics", exporter.url]) == 0
        out = capsys.readouterr().out
        assert "fleet-top — 1 locality" in out and "L0 engine#3" in out
        assert "250.0ms" in out and "scheduler{default}" in out
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        r = subprocess.run([sys.executable, "-m", "repro_torch.obs.top", "--once",
                            "--metrics", exporter.url], capture_output=True, text=True,
                           env=env, timeout=120)
        assert r.returncode == 0, r.stderr
        assert "L0 engine#3" in r.stdout
        assert TT.main(["--once", "--metrics", exporter.url.replace("/metrics", "/x")]) == 1
        assert "scrape failed: HTTP 404" in capsys.readouterr().err
    finally:
        exporter.close()
