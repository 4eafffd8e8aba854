"""The readers of the engine's split spans (``decode_step``'s
``cpu_s``, ``launch_s``, ``wait_s``; ``prefill``'s ``queue_s`` and
``launch_s``) on hand-built records, every older reader unmoved by the
new spans and arguments, the breakdown's idle gaps named by the
innermost spans, and a traced tiny run of each serving cell on the CPU
reading every new metric."""

import json

import pytest

from perfbench import harness, profiling
from perfbench.tests.conftest import BENCH, REPO, run_cell

NEW = {"decode_launch_ms.longprompt", "decode_launch_ms.longprompt_moe",
       "decode_wait_ms.longprompt", "decode_wait_ms.longprompt_moe",
       "decode_offcpu.longprompt", "decode_offcpu.longprompt_moe",
       "prefill_queue_ms.longprompt", "prefill_launch_share.longprompt"}
NEW_ARGS = ("cpu_s", "inputs_s", "launch_s", "wait_s", "queue_s")
PARENTS = ("prefill", "decode_step")
S = 1_000_000_000  # ns a second; the profile's offset is 0, so to_ns(t) = t · S
OLDER = sorted(p.name[:-3] for p in (BENCH / "layer_metrics").glob("*.py")
               if p.name != "__init__.py" and p.name[:-3] not in NEW)


def reader(name):
    return harness.load_module(BENCH / "layer_metrics" / f"{name}.py", f"t_{name}").read


def _step(t, cpu, parts, reqs, thread=1):
    """A decode step at ``t`` whose children last ``parts`` (inputs,
    launch, wait) back to back → (its span, its children's spans)."""
    args = {"batch": len(reqs), "reqs": reqs, "thread": thread, "cpu_s": cpu,
            **dict(zip(("inputs_s", "launch_s", "wait_s"), parts))}
    kids, a = [], t
    for name, d in zip(("decode.inputs", "decode.launch", "decode.wait"), parts):
        kids.append((name, a, a + d, {"parent": "0:1", "thread": thread}))
        a += d
    return ("decode_step", t, a, args), kids


def _prefill(t, n, queue, launch, wait, thread):
    args = {"rid": n, "req": f"e/{n}", "prompt_len": n, "thread": thread, "queue_s": queue,
            "launch_s": launch, "wait_s": wait}
    kid = {"rid": n, "req": f"e/{n}", "parent": "0:2", "thread": thread}
    return (("prefill", t, t + launch + wait, args),
            [("prefill.launch", t, t + launch, kid),
             ("prefill.wait", t + launch, t + launch + wait, kid)])


def full_record():
    """A window of 0–10 s, quiet up to 8 s, profiled 8–10 s: decode steps
    of 100 ms every 150 ms on thread 1 (10 ms inputs, 60 launch, 30 wait,
    75 ms of CPU), prefills on workers 2 and 3, flash calls and decode
    kernels in the stretch, tokens, page gauges."""
    spans = []
    steps = []
    for k in range(66):
        t = 0.05 + 0.15 * k
        st, kids = _step(t, 0.075, (0.010, 0.060, 0.030), [f"e/{k % 5 + 1000}"])
        spans += [st] + kids
        steps.append((st[1], st[2], [1500 + k, 2100 + k]))
    for j, (t, n, q) in enumerate([(0.3, 1100, 0.020), (1.2, 3000, 0.050),
                                   (4.0, 2000, 0.010), (8.4, 1500, 0.200)]):
        pf, kids = _prefill(t, n, q, 0.080, 0.040, 2 + j % 2)
        spans += [pf] + kids
    prof = profiling.Profile(t0_ns=8 * S, t1_ns=10 * S, offset_ns=0)
    corr = 0
    for t in (8.41, 8.45, 8.49):  # the last prefill's flash calls, on profiler thread 9
        corr += 1
        prof.host.append(("repro_torch::flash_attention", int(t * S), int(t * S) + 1000, 9,
                          corr, [[1, 2048, 24, 128]]))
        prof.device.append(("flash_kernel", int(t * S) + 2000, int(t * S) + 2000 + 10 ** 6, corr))
    for a, b, _ in steps:
        if a >= 8:
            corr += 1
            prof.device.append(("void repro_torch::decode::split_kernel", int((b - 0.02) * S),
                                int((b - 0.01) * S), corr))
    shape = harness.load_config(BENCH, "starcoder2_3b")[1]
    rec = harness.Record(shape=shape, peaks={"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
                         window=(0.0, 10.0), quiet=(0.0, 8.0), spans=spans, profile=prof,
                         page_size=16, rows=64)
    rec.decode_lengths = steps
    rec.requests = [(0.1 * i, [0.1 * i + 0.3 + 0.15 * k for k in range(6)]) for i in range(60)]
    rec.gauges = {"/serve{engine#0}/pages/in_use": [(0.1 * i, 10.0 + i) for i in range(90)],
                  "/serve{engine#0}/pages/capacity": [(0.1 * i, 16384.0) for i in range(90)]}
    prof.names = [(n, int(a * S), int(b * S)) for n, a, b, _ in spans]
    return rec


def parents_record(rec):
    """What a program without the split records: the parents alone, with
    none of the new arguments."""
    spans = [(n, a, b, {k: v for k, v in args.items() if k not in NEW_ARGS})
             for n, a, b, args in rec.spans if n in PARENTS]
    out = harness.Record(**{**rec.__dict__, "spans": spans})
    return out


def test_decode_readers_by_hand():
    rec = full_record()
    quiet = [s for s in rec.spans if s[0] == "decode_step" and s[2] < 8.0]
    assert len(quiet) == 53
    assert reader("decode_launch_ms.longprompt")(rec) == pytest.approx(60.0)
    assert reader("decode_wait_ms.longprompt")(rec) == pytest.approx(30.0)
    assert reader("decode_offcpu.longprompt")(rec) == pytest.approx(25.0)
    for name in ("decode_launch_ms", "decode_wait_ms", "decode_offcpu"):
        assert reader(f"{name}.longprompt_moe")(rec) == reader(f"{name}.longprompt")(rec)


def test_prefill_readers_by_hand():
    rec = full_record()
    # the three prefills that start before 8 s: queues 20, 50 and 10 ms
    assert reader("prefill_queue_ms.longprompt")(rec) == pytest.approx(20.0)
    assert reader("prefill_launch_share.longprompt")(rec) == pytest.approx(100 * 0.08 / 0.12)


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_readers_find_nothing_without_the_split(name):
    rec = full_record()
    assert reader(name)(parents_record(rec)) is None
    assert reader(name)(harness.Record(shape=rec.shape, peaks=rec.peaks,
                                       window=(0.0, 10.0))) is None
    late = harness.Record(**{**rec.__dict__, "quiet": (9.5, 9.6)})
    assert reader(name)(late) is None


@pytest.mark.parametrize("name", OLDER)
def test_older_readers_read_the_same_with_the_split(name):
    rec = full_record()
    got, want = reader(name)(rec), reader(name)(parents_record(rec))
    assert got == want
    if not name.endswith("train16k"):
        assert got is not None


def test_breakdown_names_a_gap_by_the_spans_the_host_was_in():
    prof = profiling.Profile(t0_ns=0, t1_ns=3 * S, offset_ns=0)
    prof.device = [("k", 0, 2 * S, 1), ("k", int(2.1 * S), 3 * S, 2)]
    prof.names = [("decode_step", int(1.9 * S), int(2.2 * S)),
                  ("decode.launch", int(1.9 * S), int(2.0 * S)),
                  ("decode.wait", int(2.0 * S), int(2.2 * S))]
    gaps = harness.breakdown(prof)["idle_gaps"]
    assert gaps == [["host in decode.wait+decode_step", pytest.approx(0.1)]]
    prof.names.append(("prefill.launch", int(1.0 * S), int(2.5 * S)))
    assert harness.breakdown(prof)["idle_gaps"][0][0] == \
        "host in decode.wait+decode_step+prefill.launch"


def test_benchmark_json_only_gains_the_new_entries():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]]
    assert set(names[-len(NEW):]) == NEW
    for m in bench["per_layer"][-len(NEW):]:
        assert m["source"] == "program_span" and (BENCH / "layer_metrics"
                                                   / f"{m['name']}.py").is_file()
        moe = m["name"].endswith("_moe")
        for cell in m["workloads"]:
            assert cell.startswith("deepseek") == moe or "prefill" in m["name"]


@pytest.mark.parametrize("cell,own", [("sc.tiny", ".longprompt"), ("ds.tiny", ".longprompt_moe")])
def test_a_traced_tiny_run_reads_every_new_metric(checkout, cell, own):
    r = run_cell(checkout, cell, trace=True)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for q in ("decode_launch_ms", "decode_wait_ms"):
        assert m[q + own] > 0
    assert 0 <= m["decode_offcpu" + own] < 100
    assert m["prefill_queue_ms.longprompt"] >= 0
    assert 0 < m["prefill_launch_share.longprompt"] <= 100
    assert m["decode_launch_ms" + own] < m["decode_step_ms" + own]
