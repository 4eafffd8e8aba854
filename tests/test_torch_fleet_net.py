"""The port's fleet control plane over real localities
(``tests/test_fleet_net.py``'s cases, in its order): elastic growth, SLO
routing, the admission gate, zero-drop live engine migration, drain-first
retirement, and router failover plus the fault-tolerant counter sweep
when a locality crashes; with the controller's measure → decide → act
tick between them.

The migrated greedy requests must give exactly the tokens of the same
requests run without migration (the fleet runs smoke starcoder2_3b in
fp32 on the CPU); a sampled request crossing the cutover is held by its
properties.  The cases share one fleet and are order-dependent (grow →
route → gate → control → migrate → retire → crash); every ``get`` carries
a timeout."""

import time

import numpy as np
import pytest

import repro_torch.core as tcore
from repro_torch import net as tnet
from repro_torch.core import counters
from repro_torch.core.future import Channel
from repro_torch.fleet import (AdmissionController, FleetController, Policy, grow_engine,
                               migrate_engine, retire_engine)
from repro_torch.serve.engine import SamplingParams, ServeConfig
from repro_torch.serve.router import TIER_BATCH, TIER_INTERACTIVE, RemoteEngine, Router

POOLS = {"default": 4, "prefill": 2, "io": 1}
MAX_NEW = 24


def _relay_total(name):
    return sum(v for _, v in counters.query(f"/serve{{relay}}/tokens/{name}"))


@pytest.fixture(scope="module")
def fleet():
    tcore.init(pools=POOLS)
    try:
        with tnet.running(2, pools=POOLS, worker_pools=POOLS) as net:
            scfg = ServeConfig(max_batch=2, cache_len=96, max_new_tokens=MAX_NEW)
            router = Router.over_localities(net, "starcoder2_3b", scfg, smoke=True,
                                            device="cpu", dtype="float32")
            try:
                yield net, router
            finally:
                router.engines[0].close()
    finally:
        tcore.finalize()


def _prompts(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, size=rng.integers(4, 16)).tolist() for _ in range(n)]


def test_grow_engine_joins_running_fleet(fleet):
    net, router = fleet
    before = set(net.live_ids())
    e = grow_engine(net, router, tier=TIER_BATCH)
    assert e.locality not in before and net.is_live(e.locality)
    assert router.engine(e.name) is e and router.tier_of(e.name) == TIER_BATCH
    out = e.submit(list(range(1, 9))).get(timeout=120)
    assert len(out) == MAX_NEW + 1
    assert out == router.engines[0].submit(list(range(1, 9))).get(timeout=120)
    assert counters.get_value("/fleet{elastic}/grown") >= 1


def test_slo_routing_prefers_tier(fleet):
    net, router = fleet
    interactive = router.engines[1]
    router.set_tier(interactive.name, TIER_INTERACTIVE)
    name = f"/serve{{router}}/dispatch/{interactive.name}"
    before = counters.get_value(name)
    futs = [router.submit(p, slo=TIER_INTERACTIVE) for p in _prompts(4)]
    for f in futs:
        assert len(f.get(timeout=120)) == MAX_NEW + 1
    assert counters.get_value(name) - before == 4
    assert router.pick(local_only=True) == 0  # the only in-process engine


def test_admission_gate_parks_then_releases_batch(fleet):
    net, router = fleet
    sig = {"occ": 0.95}
    router.admission = AdmissionController(lambda: sig["occ"], high=0.85, low=0.60)
    try:
        assert not router.admission.allow()
        futs = [router.submit(p, slo=TIER_BATCH) for p in _prompts(3)]
        assert router.gated_depth() == 3 and not any(f.is_ready() for f in futs)
        sig["occ"] = 0.10
        assert router.release_gated() == 3 and router.gated_depth() == 0
        for f in futs:
            assert len(f.get(timeout=120)) == MAX_NEW + 1
    finally:
        router.admission = None


def test_controller_tick_measures_every_locality_and_acts(fleet):
    """One tick: a counter sweep over every live locality (the sampler's
    histories), the router's gossip folded into a view, a policy firing
    its actuator, the gate's parked requests released."""
    net, router = fleet
    fired = []
    controller = FleetController(net, router, interval=60.0)
    controller.add_policy(Policy("any-engines", lambda v: float(len(v.engines)),
                                 high=0.5, up="noted", sustain=1, cooldown=0.0))
    controller.register("noted", lambda view: fired.append(len(view.engines)))
    view = controller.tick()
    assert fired == [len(router.engines)] == [3]
    assert {e.name for e in view.engines} == {"engine#0", "engine#1", "engine#2"}
    assert {loc for loc, _name in controller.sampler.keys()} == set(net.live_ids())
    assert counters.get_value("/fleet{controller}/ticks") >= 1
    assert counters.get_value("/fleet{controller}/actions") >= 1


def test_live_migration_zero_dropped_zero_duplicated(fleet):
    """Move engine#1 (locality 1) to locality 2 while it streams: every
    stream delivers exactly its future's tokens, the relay's duplicate
    counter does not move, the greedy tokens equal an unmigrated run's,
    and the engine keeps serving from its new home."""
    net, router = fleet
    e1 = router.engine("engine#1")
    assert isinstance(e1, RemoteEngine) and e1.locality == 1
    dest = next(e.locality for e in router.engines
                if isinstance(e, RemoteEngine) and e.locality != 1)
    prompts = _prompts(8)
    hot = SamplingParams(temperature=0.8, top_k=20)
    unmigrated = [e1.submit(p).get(timeout=120) for p in prompts]
    dups_before = _relay_total("duplicates")
    kv = counters.counter("/fleet{migrate}/kv_bytes")
    kv0 = kv.get_value()

    pairs = []
    for p in prompts:
        ch = Channel()
        pairs.append((ch, e1.submit(p, stream=ch)))
    sampled_ch = Channel()
    sampled = e1.submit(prompts[0], sampling=hot, stream=sampled_ch)
    moved = migrate_engine(net, router, "engine#1", dest)

    outs = []
    for ch, fut in pairs:
        out = fut.get(timeout=120)
        assert list(ch) == out and len(out) == MAX_NEW + 1
        outs.append(out)
    assert outs == unmigrated
    s = sampled.get(timeout=120)
    assert list(sampled_ch) == s and len(s) == MAX_NEW + 1 and all(0 <= t < 49152 for t in s)
    assert e1.locality == dest
    assert _relay_total("duplicates") == dups_before
    mig = dict(tnet.query_counters(dest, "/serve{engine#1}/requests/migrated_in"))
    assert sum(mig.values()) == moved > 0
    assert counters.get_value("/fleet{migrate}/engines_moved") >= 1
    assert kv.get_value() >= kv0  # the active slots' pages, when any were active
    assert router.engine("engine#1").submit(list(range(1, 9))).get(timeout=120) == \
        router.engines[0].submit(list(range(1, 9))).get(timeout=120)


def test_migration_refuses_a_local_engine_or_a_dead_destination(fleet):
    net, router = fleet
    with pytest.raises(ValueError, match="not a remote engine"):
        migrate_engine(net, router, "engine#0", 1)
    with pytest.raises(ValueError, match="not live"):
        migrate_engine(net, router, "engine#1", 99)
    assert migrate_engine(net, router, "engine#1", router.engine("engine#1").locality) == 0


def test_retire_engine_drains_then_removes_locality(fleet):
    net, router = fleet
    e = grow_engine(net, router)
    lid = e.locality
    futs = [e.submit(p) for p in _prompts(3)]
    for f in futs:
        f.get(timeout=120)
    assert retire_engine(net, router, e.name) == lid
    assert not net.is_live(lid)
    assert all(getattr(en, "name", None) != e.name for en in router.engines)
    assert len(router.submit(list(range(1, 9))).get(timeout=120)) == MAX_NEW + 1
    assert counters.get_value("/fleet{elastic}/retired") >= 1


def test_failover_and_sweep_survive_locality_crash(fleet):
    """Kill a worker outright: the router evicts its engines and lands
    retried submits on a healthy replica; the sweep reports the corpse as
    an error marker, not an exception."""
    net, router = fleet
    victim = max(e.locality for e in router.engines if isinstance(e, RemoteEngine))
    doomed = [e.name for e in router.engines
              if isinstance(e, RemoteEngine) and e.locality == victim]
    router.max_failover = 4
    net._procs[victim].kill()
    deadline = time.monotonic() + 30
    while victim in net.live_ids() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert victim not in net.live_ids()
    sweep = tnet.query_counters([0, victim], "/serve*")
    assert isinstance(sweep[victim], dict) and "error" in sweep[victim]
    assert isinstance(sweep[0], list)
    futs = [router.submit(p) for p in _prompts(6)]
    for f in futs:
        assert len(f.get(timeout=120)) == MAX_NEW + 1
    for name in doomed:
        assert name in router._dead
    assert counters.get_value("/serve{router}/failover/evicted") >= len(doomed)


def test_serve_launcher_over_localities(tmp_path):
    """``launch/serve.py --localities 3 --fleet --slo`` on the CPU: the
    control plane over three localities, the streams through the relay,
    the fleet-merged trace and its SLOW report, ``/metrics`` and the
    timeline over the fleet; and the reference's refusals."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "starcoder2_3b",
            "--smoke", "--device", "cpu", "--max-new", "4"]
    tr, tl = tmp_path / "t.json", tmp_path / "tl.jsonl"
    r = subprocess.run(base + ["--requests", "8", "--localities", "3", "--fleet", "--slo",
                               "--stream", "--trace", str(tr), "--slow-report",
                               "--metrics-port", "0", "--timeline", str(tl),
                               "--flight-recorder", "fr", "--print-counters",
                               "/serve{engine*}/tokens/generated"],
                       capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    report = json.loads(out[out.rindex("\n{") + 1:])
    assert report["localities"] == 3 and report["engines"] == 3 and report["requests"] == 8
    assert report["generated_tokens"] == 8 * 5
    tokens = report["per_locality_tokens"]
    assert tokens["locality#1"]["/serve{engine#1}/tokens/generated"] > 0  # interactive
    assert tokens["locality#2"]["/serve{engine#2}/tokens/generated"] > 0  # batch
    assert report["slow_report"]["tiers"] == ["batch", "interactive"]
    assert report["flight_recorder"]["dumps"] == 0
    assert report["timeline"]["records"] >= 1 and report["metrics_url"].endswith("/metrics")
    assert "L2 /serve{engine#2}/tokens/generated" in out
    pids = {e["pid"] for e in json.loads(tr.read_text())["traceEvents"]}
    assert pids == {0, 1, 2}
    r = subprocess.run(base + ["--localities", "2", "--engines", "2"], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 2 and "--engines is single-locality replication" in r.stderr
