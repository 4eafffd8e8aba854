#!/usr/bin/env python3
"""Paired timing of two checkouts of the repo on one GPU, in turns.

    python3 chip_pair.py A B              # turns A, B, B, A
    python3 chip_pair.py A B --rounds 2   # A, B, B, A, A, B, B, A
    python3 chip_pair.py A B --serve      # ... each also serving (phases 5-6)
    python3 chip_pair.py A B --sweep      # ... B's turns also sweep split counts
    python3 chip_pair.py A B --modes      # ... and time flash's modes forced
    python3 chip_pair.py A B --scans      # ... and the SSD and RG-LRU scans

A and B are roots of two checkouts (for example a parent commit unpacked
with ``git archive`` beside this one).  Each turn runs in its own process
from that checkout's root and with that checkout's own ``chip_smoke.py``
helpers: it builds the checkout's kernels, then times the port's three
attention kernels at the serving path's shapes (bf16; ``_time_ms``: CUDA
events, L2 flushed, median of 25, device time only): flash at S=128, 512
and 1000 (B=1, H=24, KV=2, Dh=128, causal), paged
decode at B=8 with lengths 16-576 and pages of 16, dense decode at
starcoder2_3b's cache with ``STARCODER_LENS``; and each one's host time
per call (the median over 5 batches of 200 calls enqueued back to back).
With ``--serve`` it also runs phase 5 (the 18-request serving run:
tokens/s, TTFT, prefill and decode-step p50, and the SLOW shares where
the checkout's phase 5 computes them) and phase 6 (the decode-step
profile).  With ``--sweep``, each turn whose
checkout chooses its decode split count in
``decode_attention.split_plan`` also times the paged kernel with that
count forced to 1, 4, 8, 16, 32 and 64 (each made whole: no split left
empty by the extent) at the serving shape and at a 16,384-token context,
and with every length 0 (every block empty: the call's fixed cost).  With
``--scans``, each turn also times the SSD scan at mamba2_780m (B=1,
S=2048, H=48, P=64, G=1, N=128, chunk 256) and the RG-LRU scan at
recurrentgemma_2b (B=1, S=2048, W=2560), bf16, as phase 3 times them,
with their host time per call and each kernel's device time per call
(``torch.profiler``, in the turn's ``*_kernels``).  With ``--modes``,
each turn times flash with its plan's choice and forced to every mode its
checkout weighs (``flash_attention.flash_modes``; a checkout without it:
shared and split) at starcoder2_3b's heads (B=1, S=128-2048; B=4,
S=2048), whisper_small's (B=1, 12/12 heads, Dh 64, S=64, 1500 and 2048,
causal and not), granite_moe_3b_a800m's (S=2048) and granite_34b's
(S=1000), qwen25_3b's and starcoder2_15b's prefill (S=64-512) and
internvl2_2b's (S=256, 512), the shapes the plan's costs were fit to; and,
held out of that fit, starcoder2_3b's S=64 and B=2 S=256, granite_34b's
S=64-512, internvl2_2b's S=64 and 128, granite_moe_3b_a800m's S=256 and
512, whisper_small's encoder at 1000 frames and at B=2, and
deepseek_moe_16b's (16/16 heads) S=256; with each mode's max error against the fp32
plain version, the fastest mode, the choice's ratio to it and the host
time of one uncached plan (``plan_us``); the summary holds the plan's own
time at each shape, A against B, and the mean and most host time of an
uncached plan over S=16-512 at the four dense serving configs' heads
(``plan_serving_*_us``).  Two
versions are compared only within one such call, since cards differ in
power limit and neighbours.

Prints one JSON line per turn, then a JSON summary as the last line; the
summary is also written to ``chiprun_out/chip_pair.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, statistics, sys, time, torch, numpy as np
sys.path[:0] = [".", "src"]
import chip_smoke as c
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                  paged_decode_attention_fwd)
from repro_torch.kernels.flash_attention import flash_attention_fwd

card = c.phase_device(torch)
c.phase_build()
gen = torch.Generator(device="cuda").manual_seed(c.SEED)
rng = np.random.default_rng(c.SEED)
flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
bf16 = torch.bfloat16
out = {"card": card}


def enqueue_us(fn, n=200, batches=5):
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


for S in (128, 512, 1000):
    q, k, v = c._flash_inputs(torch, gen, 1, S, 24, 2, 128, bf16)
    out[f"flash_s{S}_ms"] = c._time_ms(torch, lambda: flash_attention_fwd(q, k, v), flush)
    out[f"flash_s{S}_enqueue_us"] = enqueue_us(lambda: flash_attention_fwd(q, k, v))
serving = rng.integers(16, 577, size=8).tolist()
args = c._paged_inputs(torch, gen, serving, 24, 2, 128, 16, 64, bf16)
out["paged_b8_ms"] = c._time_ms(torch, lambda: paged_decode_attention_fwd(*args), flush)
out["paged_enqueue_us"] = enqueue_us(lambda: paged_decode_attention_fwd(*args))
q, k, v = c._decode_inputs(torch, gen, 8, 1024, 24, 2, 128, bf16)
lens = torch.tensor(c.STARCODER_LENS, dtype=torch.int32, device="cuda")
out["dense_b8_t1024_ms"] = c._time_ms(torch, lambda: decode_attention_fwd(q, k, v, lens),
                                      flush)
out["dense_enqueue_us"] = enqueue_us(lambda: decode_attention_fwd(q, k, v, lens))
if SERVE:
    del q, k, v, args
    c.phase_serve(torch, np, card)
    serve, step = c.REPORT["serve"], c.REPORT["profile"]["decode_step_b8"]
    out.update(tokens_per_s=serve["tokens_per_s"],
               decode_step_p50_ms=serve["decode_step_p50_s"] * 1e3,
               ttft_p50_ms=serve["ttft_p50_s"] * 1e3,
               prefill_p50_ms=serve["prefill_p50_s"] * 1e3,
               step_wall_ms=step["wall_ms"], step_device_ms=step["device_ms"],
               step_kernels=step.get("kernels_per_call"))
    slow = c.REPORT.get("serve_slow")  # checkouts whose phase 5 reads SLOW
    if slow:
        out.update(slow_share_p50=slow["share_p50"],
                   slow_ttft_window_share_p50=slow["ttft_window_share_p50"],
                   slow_events=slow["events"], slow_wall_s=slow["wall_s"])
if SWEEP and hasattr(da, "split_plan"):
    plan = da.split_plan
    for name, lens, maxp in (("serving", serving, 64), ("long", [c.LONG_CONTEXT] * 8,
                                                         c.LONG_CONTEXT // 16),
                             ("lengths_0", [0] * 8, 64)):
        a = c._paged_inputs(torch, gen, lens, 24, 2, 128, 16, maxp, bf16)
        fn = lambda: paged_decode_attention_fwd(*a)  # noqa: E731
        row = {"chosen_splits": c._splits(torch, 8, 24, 2, maxp, 16),
               "ms": c._time_ms(torch, fn, flush)}
        if name != "lengths_0":
            for want in (1, 4, 8, 16, 32, 64):
                tps = da.tiles_per_split(maxp, want)
                n = -(-maxp // tps)
                da.split_plan = lambda *_, n=n, tps=tps: (n, tps)
                row[f"ms_at_{n}_splits"] = c._time_ms(torch, fn, flush)
            da.split_plan = plan
        out[f"sweep_paged_{name}"] = row
        del a
if MODES:
    from repro_torch.kernels import flash_attention as fa
    plan, dev = fa.flash_plan, torch.cuda.current_device()
    weighs = hasattr(fa, "flash_modes")  # checkouts whose plan weighs its modes' makespan

    def mode_name(p):  # FlashPlan.mode, or its form in a checkout without it
        return getattr(p, "mode", f"{p.consumers}{'split' if p.split else 'shared'}")

    def plan_us(B, S, H, KV, Dh, causal, n=5):  # host µs of one uncached plan
        args = (B, S, H, KV, Dh, causal, 0, dev) if weighs else (B, S, H, KV, Dh, dev)
        per = []
        for _ in range(n):
            t0 = time.perf_counter()
            plan.__wrapped__(*args)
            per.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(per)

    shapes = [(B, S, 24, 2, 128, True) for B, S in ((1, 128), (1, 256), (1, 512), (1, 1000),
                                                  (1, 2048), (4, 2048))]
    shapes += [(1, S, 12, 12, 64, causal) for S in (64, 1500, 2048)
               for causal in (False, True)]
    # granite_moe_3b_a800m's training microbatch and granite_34b's prefill
    shapes += [(1, 2048, 24, 8, 64, True), (1, 1000, 48, 1, 128, True)]
    # qwen25_3b's, starcoder2_15b's and internvl2_2b's prefill
    shapes += [(1, S, H, KV, 128, True) for H, KV in ((16, 2), (48, 4))
               for S in (64, 128, 256, 512)]
    shapes += [(1, S, 16, 8, 128, True) for S in (256, 512)]
    # held out of the fit of flash_attention.py's costs
    shapes += [(1, 64, 24, 2, 128, True), (2, 256, 24, 2, 128, True)]
    shapes += [(1, S, 48, 1, 128, True) for S in (64, 256, 512)]
    shapes += [(1, S, 16, 8, 128, True) for S in (64, 128)]
    shapes += [(1, S, 24, 8, 64, True) for S in (256, 512)]
    shapes += [(1, 1000, 12, 12, 64, False), (2, 1500, 12, 12, 64, False),
               (1, 256, 16, 16, 128, True)]
    for B, S, H, KV, Dh, causal in shapes:
        q, k, v = c._flash_inputs(torch, gen, B, S, H, KV, Dh, bf16)
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        fn = lambda: fa.flash_attention_fwd(q, k, v, causal=causal)  # noqa: E731
        if weighs:
            chosen = plan(B, S, H, KV, Dh, causal, 0, dev)
            modes = fa.flash_modes(B, S, H, KV, Dh)
        else:
            chosen = plan(B, S, H, KV, Dh, dev)
            modes = []
            for split in (False, True):
                pos = (64 if split else 64 * chosen.consumers) // chosen.group
                modes.append(chosen._replace(
                    split=split, positions=pos, ptiles=-(-S // pos),
                    blocks=-(-S // pos) * B * KV * (H // KV // chosen.group)))
        row = {"chosen": mode_name(chosen), "ms": c._time_ms(torch, fn, flush),
               "plan_us": plan_us(B, S, H, KV, Dh, causal)}
        for m in modes:
            fa.flash_plan = lambda *_, f=m: f
            name = mode_name(m)
            row[f"{name}_ms"] = c._time_ms(torch, fn, flush)
            row[f"{name}_blocks"] = m.blocks
            row[f"{name}_max_abs_err"] = (fn().float() - want).abs().max().item()
            fa.flash_plan = plan
        forced = {k[:-3]: t for k, t in row.items() if k.endswith("_ms") and k != "ms"}
        row["fastest"] = min(forced, key=forced.get)
        row["chosen_over_fastest"] = row["ms"] / forced[row["fastest"]]
        out[f"modes_flash_b{B}_s{S}_h{H}_kv{KV}_d{Dh}_{'causal' if causal else 'full'}"] = row
        del q, k, v, want
    serving = [plan_us(1, S, H, KV, 128, True, n=1) for H, KV in
               ((16, 2), (24, 2), (48, 4), (48, 1)) for S in range(16, 513)]
    out["plan_serving_mean_us"] = statistics.mean(serving)
    out["plan_serving_max_us"] = max(serving)
if SCANS:
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd

    def kernel_us(fn, n=10):
        # device µs per call of each kernel fn launches, L2 flushed before each
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        return {re.search(r"(\w+)(<|\()", e.key.split("::")[-1]).group(1):
                e.self_device_time_total / n for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and "repro_torch" in e.key}

    ssd = c._ssd_inputs(torch, gen, *c.MAMBA, bf16)
    lru = c._rglru_inputs(torch, gen, *c.GRIFFIN_LRU, bf16)
    for name, fn in (("ssd", lambda: ssd_scan_fwd(*ssd, chunk=c.MAMBA_CHUNK)),
                     ("rglru", lambda: rglru_scan_fwd(*lru))):
        out[f"{name}_ms"] = c._time_ms(torch, fn, flush)
        out[f"{name}_enqueue_us"] = enqueue_us(fn)
        out[f"{name}_kernels"] = kernel_us(fn)
print(json.dumps(out))
"""


def main() -> int:
    argv = sys.argv[1:]
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        del argv[i:i + 2]
    args = [a for a in argv if not a.startswith("--")]
    serve, sweep, modes = "--serve" in argv, "--sweep" in argv, "--modes" in argv
    scans = "--scans" in argv
    if len(args) != 2 or rounds < 1:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(args[0]).resolve(), "B": Path(args[1]).resolve()}
    turns = []
    for name in "ABBA" * rounds:
        root = roots[name]
        r = subprocess.run([sys.executable, "-c",
                            f"SERVE = {serve}\nSWEEP = {sweep}\nMODES = {modes}\n"
                            f"SCANS = {scans}\n" + TURN],
                           cwd=root, capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], sep="\n", file=sys.stderr)
            return 1
        turn = {"turn": name, "root": str(root), **json.loads(r.stdout.splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    summary = {"turns": turns}
    for key in turns[0]:
        if key.endswith(("_ms", "_us")) or key == "tokens_per_s":
            a = [t[key] for t in turns if t["turn"] == "A"]
            b = [t[key] for t in turns if t["turn"] == "B"]
            if None not in a + b:
                summary[key] = {"A": a, "B": b, "B_over_A": sum(b) / sum(a)}
        elif key.startswith("modes_"):  # the plan's own time at each --modes shape
            a = [t[key]["ms"] for t in turns if t["turn"] == "A"]
            b = [t[key]["ms"] for t in turns if t["turn"] == "B"]
            summary[key + "_ms"] = {"A": a, "B": b, "B_over_A": sum(b) / sum(a),
                                    "plan_us": [t[key]["plan_us"] for t in turns],
                                    "chosen": [t[key]["chosen"] for t in turns],
                                    "chosen_over_fastest": [t[key]["chosen_over_fastest"]
                                                            for t in turns]}
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_pair.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "turns"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
