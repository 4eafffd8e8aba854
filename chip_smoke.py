#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. Device — the card's name and power limit (``nvidia-smi``); no CUDA → exit 2.
2. Build — the CUDA kernels from ``src/repro_torch/kernels/csrc``, timed.
3. Kernels — each kernel against its plain PyTorch version on the card, at
   the serving path's shapes (H=24, KV=2, Dh=128; prefill S ∈ {128, 512,
   1000}, also with a window and with valid_len < S; decode B=8 with mixed
   lengths, pages of 16) and at the sweeps of ``tests/test_kernels.py``, in
   fp32 and bf16: absolute tolerance ``test_kernels.py::_tol`` × 4 and a
   tight limit on each output row's relative error (``ROW_TOL``), which
   an off-by-one mask bound is shown to break; then each kernel timed (CUDA events,
   L2 flushed, median of 25) beside its plain version, its bound and, for
   flash attention, ``F.scaled_dot_product_attention`` as a yardstick.
4. Path parity — starcoder2_3b at full width and 2 layers, the same params
   on the card and on the CPU: prefill + 4 paged decode steps; fp32 (TF32
   off) logits and greedy tokens, then bf16 logits.
5. Serve — the full 30-layer starcoder2_3b through ``Router.replicate``
   with one engine (random init from seed 0, max_batch 8, cache_len 1024,
   page 16): 16 greedy requests with prompts of 16–512 tokens and 2
   sampled ones (T=0.8, top-k 40), 64 new tokens each.  Checks lengths,
   token ids and that the kernels launched exactly 30 × prefills and
   30 × decode steps; reports tokens/s, TTFT p50, decode-step p50 and peak
   device memory.
6. Profile — where one decode step (B=8) and one 512-token prefill spend
   their time: wall vs device kernel time (``torch.profiler``), outside
   the engine's threads.

The second-to-last line of standard output is the ``kernels`` JSON; the
last is ``{"ok": true, "device": {...}}``.  A fuller report is written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12                                  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}       # dense, no sparsity
TOL = {"float32": 2e-5 * 4, "bfloat16": 2e-2 * 4}         # test_kernels._tol × 4
# The tight limit of phase 3: the worst output row's relative error,
# ‖o − e‖₂ / ‖e‖₂ over each row of Dh, against the plain version run in
# fp32 on the same inputs.  In bf16, rounding the output costs at most
# 2⁻⁸ ≈ 3.9e-3 of a row (the plain version's own bf16 output reads ~2.3e-3
# at these shapes); the flash tensor-core kernel also rounds P to bf16 for
# P·V, about as much again.  fp32 differs only in summation order.  A
# window, valid_len or length bound that is off by one moves some row by
# 0.5 or more, and phase 3 checks that it moves it past the limit.
ROW_TOL = {("flash_attention", "float32"): 1e-5,
           ("flash_attention", "bfloat16"): 1e-2,
           ("paged_decode_attention", "float32"): 1e-5,
           ("paged_decode_attention", "bfloat16"): 5e-3}
PARITY_ATOL = {"float32": 2e-3, "bfloat16": 1.5e-1}       # see phase_parity
REPORT = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ------------------------------------------------------------------ phase 1
def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    REPORT["card"] = card
    REPORT["torch"] = torch.__version__
    REPORT["cuda"] = torch.version.cuda
    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    return card


# ------------------------------------------------------------------ phase 2
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    info = {k: v for k, v in _build.build_info.items() if k != "ptxas"}
    REPORT["build"] = {**info, "wall_s": secs}
    regs = [line.split("info    : ")[-1] for line in
            str(_build.build_info.get("ptxas", "")).splitlines()
            if "registers" in line or "spill" in line]
    REPORT["build"]["ptxas"] = regs
    log(f"[build] kernels built in {secs:.1f} s ({info.get('directory')})")


# ------------------------------------------------------------------ phase 3
def _time_ms(torch, fn, flush, reps=25, warmup=3):
    """Median device time of one call: CUDA events around each call, L2
    flushed (64 MB written) before each, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _row_err(o, e) -> float:
    """The worst row's ‖o − e‖₂ / ‖e‖₂, rows along the last dim."""
    o, e = o.float(), e.float()
    return ((o - e).norm(dim=-1) / e.norm(dim=-1).clamp_min(1e-12)).max().item()


def _flash_inputs(torch, gen, B, S, H, KV, Dh, dtype):
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return mk(B, S, H, Dh), mk(B, S, KV, Dh), mk(B, S, KV, Dh)


def _paged_inputs(torch, gen, lens, H, KV, Dh, page, maxp, dtype):
    B = len(lens)
    P = B * maxp + 1
    kp = torch.randn(P, page, KV, Dh, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, page, KV, Dh, generator=gen, device="cuda").to(dtype)
    q = torch.randn(B, H, Dh, generator=gen, device="cuda").to(dtype)
    perm = 1 + torch.randperm(P - 1, generator=gen, device="cuda")[: B * maxp]
    pt = perm.reshape(B, maxp).to(torch.int32).contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, lengths


def phase_kernels(torch, np):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (paged_decode_attention_fwd,
                                                      paged_decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in fp32
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    checks = []
    worst = {k: {"abs": 0.0, "row": 0.0, "off_by_one": math.inf}
             for k in ("flash_attention", "paged_decode_attention")}

    def record(kind, shape, dtype, o, e, e32, off_by_one):
        """o: the kernel's output; e: its plain version on the same inputs;
        e32: the plain version in fp32 on them; off_by_one: the fp32 plain
        version with one bound moved by one (None where the case has none)."""
        name = "float32" if dtype == torch.float32 else "bfloat16"
        err = (o.float() - e.float()).abs().max().item()
        row, row_tol = _row_err(o, e32), ROW_TOL[kind, name]
        moved = None if off_by_one is None else _row_err(off_by_one, e32)
        ok = err <= TOL[name] and row <= row_tol and (moved is None or moved > row_tol)
        checks.append({"kernel": kind, "shape": shape, "dtype": name,
                       "max_abs_err": err, "tol": TOL[name], "max_row_err": row,
                       "row_tol": row_tol, "off_by_one_row_err": moved, "ok": ok})
        w = worst[kind]
        w["abs"], w["row"] = max(w["abs"], err), max(w["row"], row)
        if moved is not None:
            w["off_by_one"] = min(w["off_by_one"], moved)
        check(ok, f"{kind} {shape} {name}: max abs err {err} (tol {TOL[name]}), "
                  f"row err {row} (tol {row_tol}), off-by-one bound moves {moved}")

    # (B, S, H, KV, Dh), causal, window, valid_len
    slice_shape = (1, 512, 24, 2, 128)
    flash_cases = [((1, S, 24, 2, 128), True, 0, 0) for S in (128, 512, 1000)]
    # the slice's shapes with a window (both kernels' tile skip) and with
    # K positions masked past valid_len, causal and not
    flash_cases += [(slice_shape, True, 128, 0), ((1, 1000, 24, 2, 128), True, 200, 0)]
    flash_cases += [(slice_shape, causal, 0, 300) for causal in (True, False)]
    flash_cases += [((2, 200, 4, 2, 64), causal, 0, 150) for causal in (True, False)]
    flash_cases += [(shape, causal, 0, 0)
                    for shape in [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64),
                                  (1, 384, 8, 1, 32), (2, 200, 4, 2, 64)]
                    for causal in (True, False)]
    flash_cases += [((2, 256, 4, 2, 64), True, 64, 0)]
    # both sides of the bf16 dispatch (tensor cores up to head_dim 128)
    flash_cases += [((1, 100, 2, 1, 16), True, 0, 0), ((1, 130, 2, 2, 256), True, 0, 0),
                    ((1, 130, 2, 2, 256), False, 0, 70)]
    slice_lens = rng.integers(1, 577, size=8).tolist()
    paged_cases = [(slice_lens, 24, 2, 128, 16, 64)]
    for (B, H, KV, Dh, page, maxp) in [(3, 4, 2, 64, 32, 8), (2, 8, 8, 32, 16, 4),
                                       (1, 8, 1, 64, 64, 4)]:
        paged_cases.append((rng.integers(1, page * maxp + 1, size=B).tolist(),
                            H, KV, Dh, page, maxp))
    for dtype in (torch.float32, torch.bfloat16):
        for (B, S, H, KV, Dh), causal, window, vl in flash_cases:
            q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, dtype)
            masks = {"causal": causal, "window": window, "valid_len": vl}
            o = flash_attention_fwd(q, k, v, **masks)
            torch.cuda.synchronize()
            f32 = [x.float() for x in (q, k, v)]
            moved = None
            if window or vl:
                key = "window" if window else "valid_len"
                moved = flash_attention_plain(*f32, **{**masks, key: masks[key] - 1})
            record("flash_attention", [B, S, H, KV, Dh, int(causal), window, vl], dtype,
                   o, flash_attention_plain(q, k, v, **masks),
                   flash_attention_plain(*f32, **masks), moved)
        for lens, H, KV, Dh, page, maxp in paged_cases:
            q, kp, vp, pt, lengths = _paged_inputs(torch, gen, lens, H, KV, Dh, page,
                                                   maxp, dtype)
            o = paged_decode_attention_fwd(q, kp, vp, pt, lengths)
            torch.cuda.synchronize()
            f32 = [x.float() for x in (q, kp, vp)]
            record("paged_decode_attention", [len(lens), H, KV, Dh, page, maxp], dtype,
                   o, paged_decode_attention_plain(q, kp, vp, pt, lengths),
                   paged_decode_attention_plain(*f32, pt, lengths),
                   paged_decode_attention_plain(*f32, pt, (lengths - 1).clamp_min(1)))
    REPORT["kernel_checks"] = checks
    fw, pw = worst["flash_attention"], worst["paged_decode_attention"]
    log(f"[kernels] {len(checks)} checks within tolerance; worst abs err flash "
        f"{fw['abs']:.3g}, paged {pw['abs']:.3g} (tol {TOL}); worst row err flash "
        f"{fw['row']:.3g}, paged {pw['row']:.3g} (tol {ROW_TOL}); an off-by-one bound "
        f"moves a row by at least {fw['off_by_one']:.3g} (flash), "
        f"{pw['off_by_one']:.3g} (paged)")

    # timings at the serving path's shapes, bf16
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    bf16 = torch.bfloat16
    timings = {"flash_attention": [], "paged_decode_attention": []}
    for S in (128, 512, 1000):
        B, H, KV, Dh = 1, 24, 2, 128
        q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, bf16)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        err = (flash_attention_fwd(q, k, v).float()
               - flash_attention_plain(q, k, v).float()).abs().max().item()
        nbytes = 2 * (2 * B * S * H * Dh + 2 * B * S * KV * Dh)  # q, o, k, v
        flops = 4 * Dh * H * B * S * (S + 1) / 2                   # causal pairs
        bound_ms, bound_by = _bound(nbytes, flops, "bfloat16")
        timings["flash_attention"].append({
            "shape": {"B": B, "S": S, "H": H, "KV": KV, "Dh": Dh, "dtype": "bfloat16",
                      "causal": True},
            "max_abs_err": err,
            "ms": _time_ms(torch, lambda: flash_attention_fwd(q, k, v), flush),
            "plain_ms": _time_ms(torch, lambda: flash_attention_plain(q, k, v), flush),
            "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops})
    for B in (8,):
        H, KV, Dh, page, maxp = 24, 2, 128, 16, 64
        lens = rng.integers(16, 577, size=B).tolist()   # prompts 16–512 + 64 new
        args = _paged_inputs(torch, gen, lens, H, KV, Dh, page, maxp, bf16)
        err = (paged_decode_attention_fwd(*args).float()
               - paged_decode_attention_plain(*args).float()).abs().max().item()
        tokens = sum(lens)
        npages = sum(-(-n // page) for n in lens)
        nbytes = (2 * 2 * B * H * Dh            # q and o
                  + 2 * 2 * tokens * KV * Dh    # live K and V
                  + 4 * npages + 4 * B)         # page-table entries walked, lengths
        flops = 4 * Dh * H * tokens
        bound_ms, bound_by = _bound(nbytes, flops, "bfloat16")
        timings["paged_decode_attention"].append({
            "shape": {"B": B, "H": H, "KV": KV, "Dh": Dh, "page": page, "maxp": maxp,
                      "lengths": lens, "dtype": "bfloat16"},
            "max_abs_err": err,
            "ms": _time_ms(torch, lambda: paged_decode_attention_fwd(*args), flush),
            "plain_ms": _time_ms(torch, lambda: paged_decode_attention_plain(*args),
                                 flush),
            "library_ms": None,  # no single PyTorch call does paged attention
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops})
    REPORT["kernel_timings"] = timings
    for name, rows in timings.items():
        for r in rows:
            log(f"[kernels] {name} {r['shape']}: {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return timings


# ------------------------------------------------------------------ phase 4
def _path(torch, cfg, params, device, prompts, steps, forced=None):
    """Prefill the prompts (right-padded, valid_len), admit them into a
    paged cache as the engine does, then ``steps`` paged decode steps.
    Feeds ``forced`` tokens when given (so both sides see the same
    inputs); returns the logits per step and the greedy tokens."""
    from repro_torch.models.model import Model
    from repro_torch.serve.kv_cache import PagedKVCache

    model = Model(cfg, device=device)
    cp = model.compute_params({k: v.to(device) for k, v in params.items()})
    B, page, maxp = len(prompts), 16, 8
    S = max(len(p) for p in prompts)
    toks = torch.zeros(B, S, dtype=torch.long)
    for b, p in enumerate(prompts):
        toks[b, : len(p)] = torch.tensor(p)
    kv = PagedKVCache(model, num_pages=B * maxp + 1, page_size=page, max_batch=B,
                      max_pages_per_req=maxp, name=f"parity-{device}")
    logits_out, greedy = [], []
    with torch.inference_mode():
        lg, c = model.prefill(cp, {"tokens": toks.to(device)}, cache_len=S,
                              valid_len=torch.tensor([len(p) for p in prompts],
                                                     dtype=torch.int32, device=device))
        for b, p in enumerate(prompts):
            check(kv.admit(b, {"k": c["k"][:, b:b + 1], "v": c["v"][:, b:b + 1]},
                           len(p)), "parity: admit failed")
        for step in range(steps + 1):
            if step:
                for b in range(B):
                    check(kv.ensure_next_token(b), "parity: pool full")
                lg, _ = model.decode_paged(cp, kv.device_cache(), tok[:, None])
                kv.pos[:] += 1
            lg = lg[:, : cfg.vocab_size].float().cpu()
            logits_out.append(lg)
            greedy.append(lg.argmax(-1))
            tok = (forced[step] if forced is not None else greedy[-1]).to(device)
    return logits_out, greedy


def phase_parity(torch, np):
    """fp32: the card (TF32 off) and the CPU compute the same fp32 math in
    other summation orders; the logits of sums over 3072–12288 terms agree
    to ~1e-5 relative, so 2e-3 absolute on O(1–10) logits.  bf16: both
    sides round to bf16 after every product and norm, at points that
    differ (cuBLAS vs CPU GEMM tiling, kernel vs plain attention), so the
    logits agree only to ~bf16 resolution times the depth: 1.5e-1."""
    from repro_torch.configs.starcoder2_3b import full_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(full_config(), num_layers=2, dtype="float32")
    t0 = time.perf_counter()
    params = Model(cfg, device="cpu").init(SEED)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (37, 20)]
    steps = 4
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = replace(cfg, dtype=dtype)
        ref_logits, ref_tok = _path(torch, c, params, "cpu", prompts, steps)
        ops.reset_launch_counts()
        gpu_logits, gpu_tok = _path(torch, c, params, "cuda", prompts, steps,
                                    forced=ref_tok)
        counts = ops.launch_counts()
        check(counts == {"flash_attention": 2, "paged_decode_attention": 2 * steps},
              f"parity: launches {counts}")
        errs = [(a - b).abs().max().item() for a, b in zip(gpu_logits, ref_logits)]
        scale = max(b.abs().max().item() for b in ref_logits)
        same = [bool(torch.equal(a, b)) for a, b in zip(gpu_tok, ref_tok)]
        out[dtype] = {"max_abs_err": max(errs), "per_step": errs, "tol": PARITY_ATOL[dtype],
                      "max_abs_logit": scale, "greedy_equal": same}
        log(f"[parity] {dtype}: logits max abs err {max(errs):.3g} (tol "
            f"{PARITY_ATOL[dtype]}, |logit| ≤ {scale:.3g}), greedy equal {same}")
        check(max(errs) <= PARITY_ATOL[dtype], f"parity {dtype}: logits differ")
        if dtype == "float32":
            check(all(same), "parity float32: greedy tokens differ")
    out["seconds"] = time.perf_counter() - t0
    REPORT["parity"] = out


# ------------------------------------------------------------------ phase 5
def phase_serve(torch, np, card):
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.obs import trace
    from repro_torch.serve.engine import SamplingParams, ServeConfig
    from repro_torch.serve.router import Router, default_extra_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("starcoder2_3b")
    max_new = 64
    core.init(pools={"default": 4, "prefill": 2, "io": 1})
    try:
        t0 = time.perf_counter()
        model = Model(cfg)  # cuda
        params = model.init(SEED)
        scfg = ServeConfig(max_batch=8, cache_len=1024, page_size=16,
                           max_new_tokens=max_new, seed=SEED)
        router = Router.replicate(model, params, scfg, 1,
                                  extra_inputs=default_extra_inputs(cfg))
        del params  # the engine holds the bf16 compute copy
        torch.cuda.empty_cache()
        eng = router.engines[0]
        torch.cuda.synchronize()  # init and cast are enqueued, not done
        setup_s = time.perf_counter() - t0
        # warm-up request (cuBLAS handles, allocator), outside the measured run
        check(len(router.submit([1] * 16, max_new=2).get(timeout=600)) == 3,
              "serve: warm-up failed")

        rng = np.random.default_rng(SEED)
        greedy = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                  for n in rng.integers(16, 513, size=16)]
        sampled = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in rng.integers(16, 513, size=2)]
        hot = SamplingParams(temperature=0.8, top_k=40)
        reqs = [(p, None) for p in greedy] + [(p, hot) for p in sampled]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trace.enable()
        trace.clear()
        base_prefills, base_steps = eng.prefill_count, eng.step_count
        ops.reset_launch_counts()  # ← the main path's run starts here
        t_run = time.perf_counter()
        streams = [router.submit_stream(p, sampling=sp) for p, sp in reqs]
        outs = [None] * len(reqs)

        def drain(i, ch):
            outs[i] = list(ch)

        threads = [threading.Thread(target=drain, args=(i, ch), daemon=True)
                   for i, (ch, _) in enumerate(streams)]
        for th in threads:
            th.start()
        results = [fut.get(timeout=900) for _, fut in streams]
        for th in threads:
            th.join(timeout=60)
        wall = time.perf_counter() - t_run
        launches = ops.launch_counts()  # ← and ends here
        trace.disable()
        prefills = eng.prefill_count - base_prefills
        steps = eng.step_count - base_steps
        peak = torch.cuda.max_memory_allocated()

        for i, (res, streamed) in enumerate(zip(results, outs)):
            check(len(res) == max_new + 1, f"serve: request {i} has {len(res)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in res),
                  f"serve: request {i} has a token outside the vocab")
            check(streamed == res, f"serve: request {i} streamed {streamed} != {res}")
        L = cfg.num_layers
        check(prefills == len(reqs), f"serve: {prefills} prefills for {len(reqs)} requests")
        check(launches["flash_attention"] == L * prefills,
              f"serve: flash launches {launches['flash_attention']} != {L}×{prefills}")
        check(launches["paged_decode_attention"] == L * steps,
              f"serve: paged launches {launches['paged_decode_attention']} != {L}×{steps}")

        evs = trace.events()
        begins = {e[5]: e[3] for e in evs if e[0] == "b" and e[1] == "request"}
        first = {}
        for e in evs:
            if e[0] == "n" and e[1] == "token" and e[5] not in first:
                first[e[5]] = e[3]
        ttft = [first[a] - begins[a] for a in begins if a in first]
        step_s = [e[4] for e in evs if e[0] == "X" and e[1] == "decode_step"]
        prefill_s = [e[4] for e in evs if e[0] == "X" and e[1] == "prefill"]
        check(len(ttft) == len(reqs), f"serve: {len(ttft)} TTFTs for {len(reqs)} requests")
        total = sum(len(r) for r in results)
        serve = {
            "card": card, "requests": len(reqs), "generated_tokens": total,
            "wall_s": wall, "tokens_per_s": total / wall,
            "ttft_p50_s": statistics.median(ttft),
            "decode_step_p50_s": statistics.median(step_s),
            "prefill_p50_s": statistics.median(prefill_s),
            "decode_steps": steps, "prefills": prefills, "launches": launches,
            "max_memory_allocated_bytes": peak, "setup_s": setup_s,
            "prompt_lengths": [len(p) for p, _ in reqs],
        }
        REPORT["serve"] = serve
        log(f"[serve] {card}: {len(reqs)} requests, {total} tokens in {wall:.2f} s = "
            f"{total / wall:.1f} tokens/s; TTFT p50 {serve['ttft_p50_s'] * 1e3:.1f} ms; "
            f"decode step p50 {serve['decode_step_p50_s'] * 1e3:.2f} ms; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB")
        log(f"[serve] launches {launches} = {L} × {prefills} prefills, "
            f"{L} × {steps} decode steps")
        phase_profile(torch, np, eng, card)
        return launches
    finally:
        core.finalize()


# ------------------------------------------------------------------ phase 6
def _device_profile(torch, fn, n):
    """Wall time of ``n`` calls of ``fn`` (each ends in a synchronize),
    then the same under torch.profiler with its device kernel time; device
    time None if the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: the aten ops that launched them carry the
    # same time again as their own device time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    out = {"wall_ms": wall_plain * 1e3 / n, "profiled_wall_ms": wall * 1e3 / n}
    if not kernels:
        return {**out, "device_ms": None}
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {**out, "device_ms": device_us / 1e3 / n,
            "busy_share": device_us / 1e6 / wall_plain,
            "kernels_per_call": sum(e.count for e in kernels) / n,
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / n, e.count / n)
                    for e in top]}


def phase_profile(torch, np, eng, card):
    """Where a decode step's and a prefill's time goes, outside the
    engine's threads: the engine's own model, params and cache layout;
    decode at B=8 with ~300 live tokens per slot, prefill of a 512 bucket."""
    from repro_torch.serve.kv_cache import PagedKVCache

    model, params, cfg = eng.model, eng.params, eng.model.cfg
    rng = np.random.default_rng(SEED + 2)
    B, page, maxp = 8, 16, 64
    kv = PagedKVCache(model, num_pages=B * maxp + 1, page_size=page, max_batch=B,
                      max_pages_per_req=maxp, name="profile")
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    for b, n in enumerate(rng.integers(250, 350, size=B).tolist()):
        zeros = torch.zeros(L, 1, n, KV, Dh, dtype=torch.bfloat16, device="cuda")
        check(kv.admit(b, {"k": zeros, "v": zeros}, n), "profile: admit failed")
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, 1))).cuda()

    def decode():
        for b in range(B):
            kv.ensure_next_token(b)
        model.decode_paged(params, kv.device_cache(), tok)
        kv.pos[:] += 1

    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, 512))).cuda()
    vl = torch.tensor([500], dtype=torch.int32, device="cuda")

    def prefill():
        model.prefill(params, {"tokens": prompt}, cache_len=512, valid_len=vl)

    out = {"card": card}
    with torch.inference_mode():
        for name, fn, n in (("decode_step_b8", decode, 10), ("prefill_s512", prefill, 3)):
            fn()
            torch.cuda.synchronize()
            out[name] = _device_profile(torch, fn, n)
            r = out[name]
            busy = ("device time not measured (the profiler saw none)"
                    if r["device_ms"] is None else
                    f"device busy {r['device_ms']:.2f} ms ({100 * r['busy_share']:.1f}%), "
                    f"{r['kernels_per_call']:.0f} kernels")
            log(f"[profile] {name}: wall {r['wall_ms']:.2f} ms (profiled "
                f"{r['profiled_wall_ms']:.2f} ms), {busy}")
    REPORT["profile"] = out


# --------------------------------------------------------------------- main
def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase_device(torch)
    phase_build()
    timings = phase_kernels(torch, np)
    phase_parity(torch, np)
    launches = phase_serve(torch, np, card)

    kernels = []
    for name, source, replaces in (
            ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:90"),
            ("paged_decode_attention",
             "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
             "src/repro/kernels/decode_attention.py:156")):
        main_shape = timings[name][1 if name == "flash_attention" else 0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": main_shape["max_abs_err"],
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"]})
    REPORT["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
