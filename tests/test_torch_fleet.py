"""The port's fleet policy and SLO logic and its tiered router against the
reference's.

- ``fleet.policy``: ``Policy`` sustain, streak reset, cooldown, two-sided
  and one-sided rules, and ``FleetView``'s pool utilisation
  (``tests/test_fleet.py``'s cases, minus the controller, which needs a
  multi-locality runtime): the same view sequences into both packages,
  the same actuator names out.
- ``fleet.slo``: ``AdmissionController`` hysteresis, its edge counters and
  fail-open.
- ``serve.router``: ``pick(slo=)`` over every tier / suspension / eviction
  / load combination of stub engines, then two smoke starcoder2_3b
  engines on the CPU beside the reference's ``Router.replicate`` over the
  same params (fp32): where each ``slo=`` submit lands after
  ``set_tier``, a batch request parked by a closed gate and released,
  failover off a suspended or failing engine, and the greedy tokens, which
  must equal the reference's.
- ``serve.engine``: the ``slo`` tag on the ``request`` span, the two p99
  gauges and ``occupancy()``, against the reference engine's."""
import itertools
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.core import counters as rcounters
from repro.dist.plan import get_plan
from repro.fleet import policy as r_policy
from repro.fleet import slo as r_slo
from repro.models.model import build_model as ref_build
from repro.net.parcelport import PortClosed
from repro.obs import export as r_export
from repro.obs import trace as r_trace
from repro.serve import router as r_router
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs import get_config
from repro_torch.core import counters as tcounters
from repro_torch.core.future import Promise
from repro_torch.fleet import policy as t_policy
from repro_torch.fleet import slo as t_slo
from repro_torch.models.model import Model
from repro_torch.models.params import from_reference
from repro_torch.obs import export as t_export
from repro_torch.obs import trace as t_trace
from repro_torch.serve import router as t_router
from repro_torch.serve.engine import ServeConfig


# ------------------------------------------------------------------ Policy
def _views(P, occs=(), loads=(), now0=0.0):
    return [P.FleetView(now=now0 + i, occupancy=o,
                        engines=[P.EngineView("e", 1, None, ld, o)])
            for i, (o, ld) in enumerate(itertools.zip_longest(occs, loads, fillvalue=0.0))]


OCC, LOAD = "occupancy", "load"
# (rule, metric read from the view, metric values tick by tick, tick times)
POLICIES = {
    "sustain": (dict(high=0.8, up="grow", sustain=3, cooldown=0.0),
                OCC, [0.9, 0.9, 0.9, 0.9, 0.2, 0.9], [1, 2, 3, 4, 5, 6]),
    "streak_reset": (dict(high=0.8, up="grow", sustain=2, cooldown=0.0),
                     OCC, [0.9, 0.5, 0.9, 0.9, 0.9, 0.9], [1, 2, 3, 4, 5, 6]),
    "cooldown": (dict(high=0.8, up="grow", sustain=1, cooldown=10.0),
                 OCC, [0.9, 0.9, 0.9, 0.9], [0.0, 5.0, 9.9, 11.0]),
    "two_sided": (dict(high=8.0, up="grow", low=1.0, down="shrink", sustain=1, cooldown=0.0),
                  LOAD, [9.0, 0.0, 4.0, 0.5, 0.5, 8.0], [0, 1, 2, 3, 4, 5]),
    "two_sided_sustain": (dict(high=8.0, up="grow", low=1.0, down="shrink", sustain=2,
                               cooldown=1.5),
                          LOAD, [9.0, 9.0, 9.0, 0.0, 0.0, 0.0, 9.0, 0.0, 9.0, 9.0],
                          list(range(10))),
    "one_sided_low": (dict(low=0.2, down="shrink", sustain=2, cooldown=0.0),
                      OCC, [0.1, 0.9, 0.1, 0.1, 0.1], [0, 1, 2, 3, 4]),
}


@pytest.mark.parametrize("case", list(POLICIES))
def test_policy_matches_reference(case):
    kw, kind, values, times = POLICIES[case]
    out = {}
    for pkg, P in (("ref", r_policy), ("port", t_policy)):
        if kind == LOAD:
            p = P.Policy(case, lambda v: v.total_load(), **kw)
            views = _views(P, loads=values)
        else:
            p = P.Policy(case, lambda v: v.occupancy, **kw)
            views = _views(P, occs=values)
        out[pkg] = [(p.evaluate(v, now=float(t)), p.last_value)
                    for v, t in zip(views, times)]
    assert out["port"] == out["ref"]
    assert any(a is not None for a, _ in out["port"])


def test_policy_defaults_to_the_monotonic_clock():
    p = t_policy.Policy("p", lambda v: 1.0, high=0.5, up="grow", sustain=1, cooldown=3600)
    assert p.evaluate(t_policy.FleetView(now=0.0)) == "grow"
    assert p.evaluate(t_policy.FleetView(now=0.0)) is None  # cooldown


@pytest.mark.parametrize("kw", [dict(high=1.0), dict(up="grow"), dict(low=1.0),
                                dict(down="shrink")])
def test_policy_one_sided_requires_pairing(kw):
    for P in (r_policy, t_policy):
        with pytest.raises(AssertionError):
            P.Policy("bad", metric=lambda v: 0.0, **kw)


def test_view_pool_utilization_matches_reference():
    rates = {
        (0, "/scheduler{default}/time/busy"): 0.9,
        (0, "/scheduler{default}/time/idle"): 0.1,
        (1, "/scheduler{default}/time/busy"): 0.7,
        (1, "/scheduler{default}/time/idle"): 0.3,
        (2, "/scheduler{prefill}/time/busy"): 0.2,
        (2, "/scheduler{prefill}/time/idle"): 0.6,
    }
    out = {}
    for pkg, P in (("ref", r_policy), ("port", t_policy)):
        view = P.FleetView(now=0.0, rates=rates, engines=[
            P.EngineView("a", 0, "interactive", 2.0, 0.5),
            P.EngineView("b", 1, None, 3.0, 0.25)])
        pol = P.utilization_policy(high=0.75, low=0.1, sustain=2, cooldown=0.0)
        out[pkg] = ([view.pool_utilization(loc, pool) for loc in (0, 1, 2, 7)
                     for pool in ("default", "prefill")],
                    [view.pool_idle_rate(loc, pool) for loc in (0, 1, 2, 7)
                     for pool in ("default", "prefill")],
                    view.mean_utilization(), view.mean_utilization("prefill"),
                    view.mean_utilization("io"), view.total_load(),
                    view.tier_load("interactive"), view.tier_load(None),
                    view.rate(0, "/scheduler{default}/time/busy"), view.rate(5, "x"),
                    pol.name, [pol.evaluate(view, now=float(i)) for i in range(3)])
    assert out["port"] == out["ref"]
    assert out["port"][0][0] == pytest.approx(0.9)
    assert out["port"][-1] == [None, "grow", None]


# --------------------------------------------------------------- Admission
@pytest.mark.parametrize("high,low", [(0.85, 0.60), (0.5, 0.5), (0.9, 0.1)])
def test_admission_hysteresis_matches_reference(high, low):
    rng = np.random.default_rng(2)
    signal = [0.0, 0.86, 0.70, 0.59, 0.84, 0.85, 0.6, 0.61] + \
        rng.uniform(0, 1, 40).round(2).tolist()
    out = {}
    for pkg, S, C in (("ref", r_slo, rcounters), ("port", t_slo, tcounters)):
        sig = {"occ": 0.0}
        edges = [C.default().counter(f"/fleet{{admission}}/{k}_edges").get_value()
                 for k in ("closed", "opened")]
        gate = S.AdmissionController(lambda: sig["occ"], high=high, low=low)
        seq = []
        for occ in signal:
            sig["occ"] = occ
            seq.append((gate.allow(), gate.is_open(), gate.last_signal,
                        gate.g_open.get_value()))
        out[pkg] = (seq, [C.default().counter(f"/fleet{{admission}}/{k}_edges").get_value()
                          - e for k, e in zip(("closed", "opened"), edges)])
    assert out["port"] == out["ref"]
    assert out["port"][1][0] >= 1  # the gate did close


def test_admission_fails_open_without_signal():
    def broken():
        raise RuntimeError("no signal yet")

    for S in (r_slo, t_slo):
        gate = S.AdmissionController(broken, high=0.85, low=0.60)
        assert gate.allow() and gate.last_signal is None
    assert t_slo.INTERACTIVE == r_slo.INTERACTIVE == "interactive"
    assert t_slo.BATCH == r_slo.BATCH == "batch"
    with pytest.raises(AssertionError):
        t_slo.AdmissionController(lambda: 0.0, high=0.5, low=0.6)


# --------------------------------------------------- pick() over stub engines
class _Stub:
    def __init__(self, name, load, occ=0.0):
        self.name, self._load, self._occ = name, load, occ

    def load(self):
        return self._load

    def occupancy(self):
        if self._occ is None:
            raise RuntimeError("mid-teardown")
        return self._occ


TIERS = [None, "interactive", "batch"]


def test_pick_matches_reference_over_every_tier_combination(rt, port_rt):
    """Three engines, every tier labelling, suspension, eviction and load
    order: the same engine picked (or the same error) for every ``slo``."""
    loads = [(1.0, 0.0, 2.0), (0.0, 0.0, 0.0), (3.0, 2.0, 1.0)]
    cases = 0
    for tiers in itertools.product(TIERS, repeat=3):
        for load in loads:
            for off in range(8):  # bit i: engine i out (suspended or evicted)
                picks = []
                for R in (r_router, t_router):
                    es = [_Stub(f"e{i}", load[i], occ=[0.25, None, 0.5][i]) for i in range(3)]
                    router = R.Router(es, tiers={f"e{i}": t for i, t in enumerate(tiers)})
                    for i in range(3):
                        if off >> i & 1:
                            (router.suspend if i % 2 else router._evict)(f"e{i}")
                    row = []
                    for slo in TIERS:
                        try:
                            row.append(router.pick(slo=slo))
                        except ValueError as e:
                            row.append(str(e))
                    row.append(router.occupancy())
                    row.append(router.loads())
                    picks.append(row)
                    cases += 1
                assert picks[1] == picks[0], (tiers, load, off)
    assert cases == 2 * 27 * 3 * 8


def test_membership_matches_reference(rt, port_rt):
    out = {}
    for pkg, R in (("ref", r_router), ("port", t_router)):
        router = R.Router([_Stub("a", 1.0), _Stub("b", 0.0)], tiers={"a": "batch"})
        steps = [router.tier_of("a"), router.tier_of("b"), router.pick()]
        router.add_engine(_Stub("c", 0.0, 0.75), tier="interactive")
        steps += [[R.engine_name(e) for e in router.engines], router.pick(slo="interactive"),
                  router.occupancy()]
        router.suspend("c")
        steps.append(router.pick(slo="interactive"))
        router.resume("c")
        router._evict("c")
        router._evict("c")  # counted once
        steps += [router.pick(slo="interactive"), router.occupancy()]
        router.revive("c")
        router.set_tier("b", "interactive")
        steps += [router.pick(slo="interactive"), router.tier_of("b")]
        steps.append(R.engine_name(router.remove_engine("b")))
        steps += [router.remove_engine("zz"), [R.engine_name(e) for e in router.engines]]
        steps.append(R.engine_name(router.engine("c")))
        with pytest.raises(KeyError):
            router.engine("b")
        out[pkg] = steps
    assert out["port"] == out["ref"]
    assert t_router.TIER_INTERACTIVE == r_router.TIER_INTERACTIVE
    assert t_router.TIER_BATCH == r_router.TIER_BATCH
    with pytest.raises(ValueError):
        t_router.Router([])


# ------------------------------------------------- two real engines per side
@pytest.fixture(scope="module")
def port_rt():
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


SCFG = dict(max_batch=2, cache_len=64, max_new_tokens=3)


@pytest.fixture(scope="module")
def routers(rt, port_rt):
    """Two replicas per package over the same fp32 smoke params."""
    rcfg = replace(ref_config("starcoder2_3b", smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, get_plan("serve"))
    rparams = rmodel.init(jax.random.PRNGKey(3))
    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32")
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    rr = r_router.Router.replicate(rmodel, rparams, RServeConfig(**SCFG), 2)
    tr = t_router.Router.replicate(model, params, ServeConfig(**SCFG), 2, device="cpu")
    yield rr, tr
    for e in tr.engines:
        e.close()


def _raise(exc):
    raise exc


def _prompts(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, size=int(rng.integers(4, 12))).tolist() for _ in range(n)]


def _dispatches(C, names=("engine#0", "engine#1")):
    return [C.default().counter(f"/serve{{router}}/dispatch/{n}").get_value() for n in names]


def _side(router, C, fn):
    """Run ``fn(router)`` → futures; returns (tokens, dispatch deltas)."""
    before = _dispatches(C)
    futs = fn(router)
    toks = [f.get(timeout=300) for f in futs]
    return toks, [a - b for a, b in zip(_dispatches(C), before)]


def test_slo_submits_land_on_their_tier(routers):
    rr, tr = routers
    prompts = _prompts(6)
    out = []
    for router, C in ((rr, rcounters), (tr, tcounters)):
        router.set_tier("engine#0", "interactive")
        router.set_tier("engine#1", "batch")
        try:
            inter = _side(router, C, lambda r: [r.submit(p, slo="interactive") for p in prompts[:3]])
            batch = _side(router, C, lambda r: [r.submit(p, slo="batch") for p in prompts[3:]])
            router.set_tier("engine#1", None)
            neutral = _side(router, C, lambda r: [r.submit(prompts[0], slo="batch")])
        finally:
            router.set_tier("engine#0", None)
            router.set_tier("engine#1", None)
        out.append((inter, batch, neutral))
    assert out[1] == out[0]
    (inter, batch, neutral) = out[1]
    assert inter[1] == [3, 0] and batch[1] == [0, 3] and neutral[1] == [0, 1]


def test_closed_gate_parks_batch_then_releases(routers):
    rr, tr = routers
    prompts = _prompts(4, seed=9)
    out = []
    for router, S, C, tracer, exp in ((rr, r_slo, rcounters, r_trace, r_export),
                                      (tr, t_slo, tcounters, t_trace, t_export)):
        sig = {"occ": 0.95}
        gated0 = C.default().counter("/serve{router}/admission/gated").get_value()
        rel0 = C.default().counter("/serve{router}/admission/released").get_value()
        router.admission = S.AdmissionController(lambda: sig["occ"], high=0.85, low=0.60)
        tracer.clear()
        tracer.enable()
        try:
            parked = [router.submit(p, slo="batch") for p in prompts[:3]]
            depth = router.gated_depth()
            ready = [f.is_ready() for f in parked]
            inter = router.submit(prompts[3], slo="interactive").get(timeout=300)
            stuck = router.release_gated()  # still closed: nothing moves
            sig["occ"] = 0.10
            moved = router.release_gated(limit=2)
            moved += router.release_gated()
            toks = [f.get(timeout=300) for f in parked]
        finally:
            tracer.disable()
            router.admission = None
        gated = [e for e in exp.merged_trace()["traceEvents"] if e["name"] == "router/gated"]
        subs = [e for e in exp.merged_trace()["traceEvents"] if e["name"] == "router/submit"]
        out.append((depth, ready, inter, stuck, moved, toks, router.gated_depth(),
                    C.default().counter("/serve{router}/admission/gated").get_value() - gated0,
                    C.default().counter("/serve{router}/admission/released").get_value() - rel0,
                    C.default().gauge("/serve{router}/admission/depth").get_value(),
                    sorted((e["args"]["slo"], e["args"]["depth"]) for e in gated),
                    sorted((e["args"]["slo"], e["args"]["gated"]) for e in subs)))
    assert out[1] == out[0]
    assert out[1][:5] == (3, [False] * 3, out[1][2], 0, 3)


def test_failover_off_a_suspended_or_failing_engine(routers, monkeypatch):
    """A suspended engine gets no request; an engine that fails with a
    ConnectionError (the reference's ``PortClosed``) is evicted and its
    request completes on the other; when every engine fails the failure
    is delivered once ``max_failover`` retries are spent, and a request
    finding no engine left fails with ``ValueError``; any other error
    is the request's own and is not retried."""
    rr, tr = routers
    prompts = _prompts(4, seed=11)
    names = ["evicted", "retried", "exhausted"]
    out = []
    for router, C, gone in ((rr, rcounters, PortClosed), (tr, tcounters, ConnectionError)):
        def fo():
            return [C.default().counter(f"/serve{{router}}/failover/{n}").get_value()
                    for n in names]

        e0, e1 = router.engines
        rows = []
        router.suspend("engine#0")
        rows.append(_side(router, C, lambda r: [r.submit(p) for p in prompts[:2]]))
        router.resume("engine#0")

        f0 = fo()
        monkeypatch.setattr(e0, "submit", lambda *a, **k: _raise(gone("gone")))
        rows.append(_side(router, C, lambda r: [r.submit(prompts[2])]))
        rows.append([a - b for a, b in zip(fo(), f0)])
        rows.append(router.pick())  # engine#0 stays out
        router.revive("engine#0")

        # a future that fails later (the engine accepted, then died)
        def fails_later(*a, **k):
            p = Promise()
            p.set_exception(gone("died"))
            return p.future()

        f0 = fo()
        monkeypatch.setattr(e1, "submit", fails_later)
        monkeypatch.setattr(e0, "submit", fails_later)
        router.max_failover = 1
        with pytest.raises(gone):
            router.submit(prompts[3]).get(timeout=60)
        rows.append([a - b for a, b in zip(fo(), f0)])
        with pytest.raises(ValueError, match="no engine available"):
            router.submit(prompts[3]).get(timeout=60)
        router.revive("engine#0")
        router.revive("engine#1")
        router.max_failover = 2

        f0 = fo()
        monkeypatch.setattr(e0, "submit", lambda *a, **k: _raise(KeyError("own")))
        with pytest.raises(KeyError):
            router.submit(prompts[3]).get(timeout=60)
        rows.append([a - b for a, b in zip(fo(), f0)])
        monkeypatch.undo()
        out.append(rows)
    assert out[1] == out[0]
    rows = out[1]
    assert rows[0][1] == [0, 2] and rows[1][1] == [1, 1]  # dispatched to #0, then #1
    assert rows[2] == [1, 1, 0] and rows[3] == 1
    assert rows[4] == [2, 1, 1] and rows[5] == [0, 0, 0]


def test_greedy_tokens_and_streams_equal_reference(routers):
    rr, tr = routers
    prompts = _prompts(5, seed=13)
    want = [f.get(timeout=300) for f in [rr.submit(p) for p in prompts]]
    got = [f.get(timeout=300) for f in [tr.submit(p, slo=s) for p, s in
                                        zip(prompts, ["interactive", "batch", None] * 2)]]
    assert got == want
    ch, fut = tr.submit_stream(prompts[0], slo="interactive")
    assert list(ch) == fut.get(timeout=300) == want[0]


# --------------------------------------------- the engine's tags and gauges
def test_engine_slo_span_p99_gauges_and_occupancy_match_reference(routers):
    rr, tr = routers
    prompts = _prompts(3, seed=17)
    out = []
    for router, C, tracer, exp in ((rr, rcounters, r_trace, r_export),
                                   (tr, tcounters, t_trace, t_export)):
        tracer.clear()
        tracer.enable()
        try:
            futs = [router.submit(p, slo=s) for p, s in
                    zip(prompts, ["interactive", "batch", None])]
            toks = [f.get(timeout=300) for f in futs]
        finally:
            tracer.disable()
        begins = [e for e in exp.merged_trace()["traceEvents"]
                  if e["name"] == "request" and e["ph"] == "b"]
        e0 = router.engines[0]
        gauges = {}
        for q in ("latency", "first_token"):
            name = f"/serve{{engine#0}}/request/{q}/p99"
            val = dict(C.default().query(name))[name]
            timer = e0.t_latency if q == "latency" else e0.t_first
            assert val == timer.quantile(0.99) > 0.0
            gauges[q] = C.default().snapshot_export(name)[name]["kind"]
        kv = e0.backend.kv
        occ = [e0.occupancy()]
        taken = kv._take(3)
        occ.append(e0.occupancy())
        kv._free.extend(reversed(taken))
        occ.append(router.occupancy())
        # the tags' numbers depend on each router's history: keep the order
        tagged = sorted((int(e["args"]["req"].split(":")[1]), e["args"]["slo"])
                        for e in begins)
        out.append((toks, [slo for _, slo in tagged], gauges, occ))
    assert out[1] == out[0]
    assert out[1][1] == ["interactive", "batch", None] and out[1][3][1] == 3 / (2 * 4)


def test_dense_engine_occupancy_matches_reference(rt, port_rt):
    """Dense slots: the share of occupied slots, as in the reference."""
    from repro.serve.engine import Engine as REngine
    from repro_torch.serve.engine import Engine

    rcfg = ref_config("mamba2_780m", smoke=True)
    rmodel = ref_build(rcfg, get_plan("serve"))
    cfg = get_config("mamba2_780m", smoke=True)
    model = Model(cfg, device="cpu")
    kw = dict(max_batch=4, cache_len=32, name="occ#dense")
    re_ = REngine(rmodel, rmodel.init(jax.random.PRNGKey(0)), RServeConfig(**kw))
    te = Engine(model, model.init(0), ServeConfig(**kw), device="cpu")
    assert not re_.paged and not te.paged
    seq = []
    for eng in (re_, te):
        row = [eng.occupancy()]
        for i in (0, 2, 3):
            eng.slots[i] = object()
            row.append(eng.occupancy())
        eng.slots[:] = [None] * 4
        seq.append(row)
    assert seq[1] == seq[0] == [0.0, 0.25, 0.5, 0.75]
