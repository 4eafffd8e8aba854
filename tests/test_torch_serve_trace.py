"""The serving engine's spans on the CPU (the smoke starcoder2_3b, fp32):
each ``decode_step`` split into ``decode.inputs``, ``decode.launch`` and
``decode.wait`` with the decode thread's CPU time, each ``prefill`` into
``prefill.launch`` and ``prefill.wait`` with its queue wait; and, with
tracing off, no span entered on the serving path.  Also the recorder's
``cpu=True`` and ``set``."""
import time
from dataclasses import replace

import pytest

from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.obs import trace
from repro_torch.serve.engine import Engine, SamplingParams, ServeConfig

DECODE_PARTS = ("decode.inputs", "decode.launch", "decode.wait")
PREFILL_PARTS = ("prefill.launch", "prefill.wait")
MODES = {"paged": {}, "dense": {"paged": False},
         "inline": {"paged": False, "pipeline_admission": False}}
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 40)), [7] * 12, [11, 12, 13, 14]]


@pytest.fixture(scope="module")
def port_rt():
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


@pytest.fixture(scope="module")
def smoke():
    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32")
    model = Model(cfg, device="cpu")
    return model, model.init(3)


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _serve(model, params, name, **kw):
    """The five prompts through a two-slot engine (one sampled) → the
    token lists."""
    eng = Engine(model, params, ServeConfig(max_batch=2, cache_len=96, max_new_tokens=4,
                                            name=name, **kw), device="cpu")
    futs = [eng.submit(p, sampling=SamplingParams(temperature=0.7 * (i == 1), top_k=5))
            for i, p in enumerate(PROMPTS)]
    out = [f.get(timeout=300) for f in futs]
    eng.close()
    return out


def _events():
    """Every recorded event as (ph, name, ts, end, sid, args, thread)."""
    return [(e[0], e[1], e[3], e[3] + e[4], e[5], e[6] or {}, b["tid"])
            for b in trace.export_buffers() for e in b["events"]]


def _sid(e):
    return f"{e[4][0]}:{e[4][1]}"


@pytest.fixture(scope="module")
def traced(port_rt, smoke):
    """Each mode served once with tracing on → (events, tokens)."""
    model, params = smoke
    out = {}
    for mode, kw in MODES.items():
        trace.clear()
        trace.enable()
        try:
            toks = _serve(model, params, f"trace-{mode}#0", **kw)
        finally:
            trace.disable()
        out[mode] = (_events(), toks)
    trace.clear()
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_holds_its_three_parts_in_order(traced, mode):
    evs, _ = traced[mode]
    steps = [e for e in evs if e[0] == "X" and e[1] == "decode_step"]
    assert len(steps) >= 3
    for st in steps:
        kids = [e for e in evs if e[0] == "X" and e[5].get("parent") == _sid(st)]
        assert [k[1] for k in sorted(kids, key=lambda k: k[2])] == list(DECODE_PARTS)
        kids.sort(key=lambda k: k[2])
        assert st[2] <= kids[0][2] and kids[-1][3] <= st[3]
        assert all(a[3] <= b[2] for a, b in zip(kids, kids[1:]))
        assert {k[6] for k in kids} == {st[6]}
        assert not any("req" in k[5] or "cpu_s" in k[5] for k in kids)
        # the step carries its children's walls, as the children recorded them
        for part, key in zip(DECODE_PARTS, ("inputs_s", "launch_s", "wait_s")):
            kid = next(k for k in kids if k[1] == part)
            assert st[5][key] == pytest.approx(kid[3] - kid[2], abs=1e-9)
        assert sum(k[3] - k[2] for k in kids) <= st[3] - st[2]


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_cpu_time_lies_within_its_wall(traced, mode):
    evs, _ = traced[mode]
    steps = [e for e in evs if e[0] == "X" and e[1] == "decode_step"]
    for st in steps:
        assert 0.0 <= st[5]["cpu_s"] <= st[3] - st[2] + 1e-3
        assert st[5]["batch"] == len(st[5]["reqs"]) >= 1
    # the CPU backend computes on the decode thread: mostly on the CPU
    assert sum(st[5]["cpu_s"] for st in steps) > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_holds_launch_and_wait_and_its_queue_wait(traced, mode):
    evs, _ = traced[mode]
    begins = {e[5]["req"]: e[2] for e in evs if e[0] == "b" and e[1] == "request"}
    prefills = [e for e in evs if e[0] == "X" and e[1] == "prefill"]
    assert len(prefills) == len(PROMPTS) == len(begins)
    for pf in prefills:
        kids = sorted((e for e in evs if e[0] == "X" and e[5].get("parent") == _sid(pf)),
                      key=lambda k: k[2])
        assert [k[1] for k in kids] == list(PREFILL_PARTS)
        assert pf[2] <= kids[0][2] <= kids[0][3] <= kids[1][2] <= kids[1][3] <= pf[3]
        assert {k[6] for k in kids} == {pf[6]}
        assert all(k[5]["req"] == pf[5]["req"] and k[5]["rid"] == pf[5]["rid"] for k in kids)
        assert pf[5]["launch_s"] == pytest.approx(kids[0][3] - kids[0][2], abs=1e-9)
        assert pf[5]["wait_s"] == pytest.approx(kids[1][3] - kids[1][2], abs=1e-9)
        assert pf[5]["queue_s"] >= 0
        assert pf[5]["queue_s"] == pytest.approx(pf[2] - begins[pf[5]["req"]], abs=1e-3)
        assert "cpu_s" not in pf[5]


@pytest.mark.parametrize("mode", list(MODES))
def test_no_token_instants_and_tracing_leaves_tokens_alone(traced, port_rt, smoke, mode):
    evs, toks = traced[mode]
    assert not [e for e in evs if e[0] == "n"]
    assert len([e for e in evs if e[0] == "e" and e[1] == "request"]) == len(PROMPTS)
    model, params = smoke
    plain = _serve(model, params, f"plain-{mode}#0", **MODES[mode])
    # greedy requests match token for token; the sampled one keeps its length
    assert [t for i, t in enumerate(plain) if i != 1] == \
        [t for i, t in enumerate(toks) if i != 1]
    assert [len(t) for t in plain] == [len(t) for t in toks] == [5] * len(PROMPTS)


@pytest.mark.parametrize("mode", list(MODES))
def test_tracing_off_enters_no_span(port_rt, smoke, monkeypatch, mode):
    def refuse(*a, **k):
        raise AssertionError("trace.span called with tracing off")

    monkeypatch.setattr(trace, "span", refuse)
    model, params = smoke
    out = _serve(model, params, f"off-{mode}#0", **MODES[mode])
    assert [len(t) for t in out] == [5] * len(PROMPTS)
    assert trace.recorded_events() == 0


def test_span_records_thread_cpu_time_only_when_asked():
    trace.enable()
    with trace.span("busy", "t", cpu=True, k=1) as busy:
        c_end = time.thread_time() + 0.03  # spin for 30 ms of this thread's CPU
        while time.thread_time() < c_end:
            pass
    with trace.span("asleep", "t", cpu=True) as asleep:
        time.sleep(0.05)
    with trace.span("plain", "t"):
        pass
    trace.disable()
    got = {e[1]: (e[4], e[6]) for e in trace.events()}
    dur, args = got["busy"]
    assert args["k"] == 1 and 0.03 <= args["cpu_s"] <= dur
    dur, args = got["asleep"]
    assert dur >= 0.05 and 0.0 <= args["cpu_s"] < 0.5 * dur
    assert got["plain"][1] is None
    assert busy.t1 - busy.t0 == got["busy"][0] and asleep.t1 > asleep.t0


def test_set_adds_arguments_at_exit_and_the_disabled_span_drops_them():
    trace.enable()
    with trace.span("outer", "t", a=1) as outer:
        with trace.span("inner", "t") as inner:
            inner.set(b=2)
        outer.set(c=3)
    trace.disable()
    got = {e[1]: e[6] for e in trace.events()}
    assert got["outer"] == {"a": 1, "c": 3}
    assert got["inner"]["b"] == 2 and "parent" in got["inner"]
    null = trace.span("off", "t", cpu=True)
    assert null is trace._NULL
    with null as sp:
        sp.set(d=4)
    assert sp.t1 - sp.t0 == 0.0 and trace.recorded_events() == 2
