#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. Device — the card's name and power limit (``nvidia-smi``); no CUDA → exit 2.
2. Build — the CUDA kernels from ``src/repro_torch/kernels/csrc``, timed.
3. Kernels — each kernel, through its ``repro_torch::`` torch op, against
   its plain PyTorch version on the card, in fp32 and bf16, at the sweeps
   of ``tests/test_kernels.py`` and at full widths: flash and paged
   decode at the serving path's shapes (H=24, KV=2, Dh=128; prefill S ∈
   {128, 512, 1000}, also with a window and with valid_len < S; decode
   B=8 with mixed lengths, pages of 16); flash also
   at every head dim 16–256, at 1, 2, 12 and 24 q heads per KV head, at S
   off the tile (100, 130, 200, 1000), with windows and valid_len one off
   a K-tile edge on either side, and over a grid of more than one wave
   (B=4, S=2048); dense decode
   at starcoder2_3b's cache (B=8, T=1024; per-row, scalar and clamped
   lengths; a row of length 0) and recurrentgemma_2b's local attention
   (B=4, T=2048, H=10, KV=1, Dh=256); both decode kernels also at their
   split edges (lengths on an edge of ``decode_splits``'s ranges and ±1, a
   lone long request, requests all shorter than one split, and a cache
   small enough for one split), at 20 query heads per KV head (two
   m-tiles), with pages of 24 and 128 tokens, and with splits that walk
   4–16 chunks (a batch of 32 at the serving shape, 40 requests of
   recurrentgemma_2b's local attention, every request at starcoder2_3b's
   16,384-token context); the SSD scan at
   mamba2_780m (S=2048, H=48, P=64, N=128, chunk 256; ragged S=2000; a
   steep decay); the RG-LRU scan at recurrentgemma_2b (S=2048, W=2560);
   the triad at N = 2²⁷; both scans also across their chunk edges (S on
   an edge ± 1, 8 and 32 SSD chunks, a steep decay over 8, B=2 with G=2
   at mamba2_780m's widths, chunk 40; RG-LRU S below one 64-step chunk,
   W=2561, B=4, 256 chunks at S=16,384, a slow decay a in (0.9, 1)); the
   SSD also as the Mamba-2 block calls it, bf16 x, B and C with an fp32
   dt, at S=2048 and 2000, and its fp32 final state at S = 2048, 2000,
   1024 ± 1 and 100 (the state after S − 1 steps is the off-by-one).
   Limits: absolute ``test_kernels.py::_tol`` × 4 (SSD × 8 with rtol
   1e-2; the triad exact) and a tight limit on each output row's relative
   error (``ROW_TOL``), which an off-by-one length is shown to break; then
   each kernel timed (CUDA events, L2 flushed, median of 25, device time
   only: see ``_time_ms``) beside its plain version, its bound and, where
   one PyTorch call computes the same function, that call as a yardstick;
   flash at S = 128, 512, 1000 and 256 and at recurrentgemma_2b's local
   attention (S=2048, H=10, KV=1, Dh=256), beside SDPA;
   both decode kernels also at a long context (B=8, every request at
   starcoder2_3b's 16,384 tokens), dense decode also at recurrentgemma_2b's
   full ring (B=8, T=2048), and each decode row names its split count; the
   SSD and the RG-LRU also as the models call them (fp32 dt and the final
   state; fp32 a and b); the triad at N = 2²⁷ in fp32 and bf16 gives
   STREAM's GB/s.  The training path's flash backward
   (``flash_attention_bwd``, PyTorch math) against ``torch.autograd.grad``
   through the plain version at starcoder2_3b's training shape (B=2,
   S=512, causal; and a window of 128), fp32 and bf16, each gradient's
   worst row within ``ROW_TOL`` (a window one short moves it past).
   The MoE family's attention: flash at G = 1 (H = KV = 16, Dh 128,
   deepseek_moe_16b's prefill) and G = 3 (24 / 8 heads, Dh 64,
   granite_moe_3b_a800m's training microbatch), and paged decode at both
   (B=8), each against its plain version and timed beside SDPA.  The
   scans' training backward (``ops.ssd_scan_bwd``: autograd through the
   plain chunked form; ``ops.rglru_scan_bwd``: the kernel over the
   reversed sequence) against autograd through the sequential oracles,
   fp32, at mamba2_780m's and recurrentgemma_2b's widths (the RG-LRU's
   off-by-one shown to break its limit), and each timed as the models'
   backward calls it.  The enc-dec and VLM families' shapes: flash
   non-causal over whisper_small's 1500 encoder frames (12 / 12 heads, Dh
   64; also with valid_len 1500, whose off-by-one breaks the limit), at its
   decoder's prefill and its training microbatch (2048 positions, causal
   and not), and at internvl2_2b's prefill (16 / 8 heads, Dh 128; also
   bucketed); dense decode at whisper's cross-attention (B=8, T=1500, every
   row full) and its self-attention cache (T=512); paged decode at
   internvl2_2b (B=8, pages of 16, mixed lengths); each timed beside SDPA;
   ``flash_attention_bwd`` non-causal against autograd at whisper's encoder
   training shape; and the plain cross-attention's device time beside SDPA.
   The dense configs' head layouts (Dh 128): flash at qwen25_3b (16 / 2
   heads, G = 8), starcoder2_15b (48 / 4, G = 12) and granite_34b (MQA, 48
   / 1, G = 48) at S = 512, granite_34b's also at S = 1000 and with
   valid_len 700; paged decode at all three (B=8, pages of 16, phase 5e's
   lengths) and at G = 48 on a ``decode_splits`` edge ± 1; each timed.
   The flash plan's modes (``flash_attention.py::flash_modes``): each
   flash timing row names the mode the plan chose and its ratio to SDPA;
   and the bf16 kernel is held against its plain version with the plan
   forced to each mode (two consumers shared or split, three shared) at
   whisper's encoder (with valid_len and its off-by-one), causal with a
   window and valid_len (rows with no unmasked key give zeros) and
   head_dim 256, each call repeated bit-equal (``_check_flash_modes``).
4. Path parity — starcoder2_3b at full width and 2 layers, the same params
   on the card and on the CPU: prefill + 4 paged decode steps; fp32 (TF32
   off) logits and greedy tokens, then bf16 logits.
4b. The same for the recurrent families in fp32: mamba2_780m at full width
   and 2 layers (B=2, a 300-token prompt: two SSD chunks, the second
   ragged) and recurrentgemma_2b at full width, one (rec, rec, attn) group
   and the 2-layer tail (a 2046-token prompt, so the decode wraps the
   2048-slot ring); prefill + 4 decode steps through the dense-slot cache,
   exact launch counts.
4c. The same for the MoE family in fp32, paged: deepseek_moe_16b (its
   dense layer and one MoE layer) and granite_moe_3b_a800m (2 MoE
   layers) at full width, two prompts right-padded into one prefill,
   then 4 paged decode steps; exact launch counts.
4d. The same for the enc-dec and VLM families in fp32: whisper_small at
   full width with 2 encoder and 2 decoder layers (the encoder over 300
   frames, a prefill, 4 decode steps on the dense slots) and internvl2_2b
   at full width and 2 layers (patches and two prompts right-padded into
   one paged prefill, 4 paged decode steps); exact launch counts.
4e. The same for the dense configs no other phase runs, fp32: qwen25_3b,
   starcoder2_15b and granite_34b at full width and 2 layers (params drawn
   on the card, copied to the CPU), two prompts right-padded into one
   prefill, 4 paged decode steps; exact launch counts.
5. Serve — the full 30-layer starcoder2_3b through ``Router.replicate``
   with one engine (random init from seed 0, max_batch 8, cache_len 1024,
   page 16): 16 greedy requests with prompts of 16–512 tokens and 2
   sampled ones (T=0.8, top-k 40), 64 new tokens each.  Checks lengths,
   token ids and that the kernels launched exactly 30 × prefills and
   30 × decode steps (and the other four kernels never); reports
   tokens/s, TTFT p50, decode-step p50 and peak device memory.  The
   greedy requests go in with ``slo="interactive"`` and the sampled ones
   with ``slo="batch"`` (one untiered engine takes both).  From the run's
   trace (``obs.export.merged_trace``): each request's critical path
   (``obs.critical_path``), which must tile the request with no gap and
   clamp under 1 % of its wall time, and the SLOW report
   (``obs.attribution``), which must hold both tiers; the p50 over
   requests of each class's share of the request and of its TTFT window
   is printed.  While the engine lives, one ``/metrics`` scrape through
   ``obs.metrics.MetricsExporter``, parsed strictly, must read the
   engine's completed requests (19, the warm-up's included), generated
   tokens and first-token p99.
5c. Serve the MoE family — full deepseek_moe_16b (28 layers, 16.4 B
   params, made one tensor at a time in bf16) on phase 5's engine and
   traffic: exactly 28 flash launches a prefill and 28 paged decodes a
   step; the same reports, the setup's peak memory and phase 6's profile.
5b. Serve on the dense slots — through ``Router.replicate`` with one
   engine, random init from seed 0, full width and depth, each model freed
   before the next: mamba2_780m and recurrentgemma_2b, 8 greedy requests
   (prompts of 16–1024 tokens, the hybrid's last one 2030, so its ring
   wraps; 32 new tokens each), then starcoder2_3b in the seed baseline
   (``paged=False, pipeline_admission=False``; 4 greedy requests).  Checks
   lengths, token ids, one decode-step signature and exact launches:
   mamba2_780m 48 SSD scans a prefill and nothing else; recurrentgemma_2b
   18 RG-LRU scans and 8 flash launches a prefill and 8 dense decodes a
   step; the seed baseline 30 flash launches a prefill and 30 dense
   decodes a step.  Reports tokens/s, TTFT p50, decode-step p50 and peak
   device memory for each, and profiles one decode step of each engine's
   model on its own dense slots as phase 6 does, and a 64-token prefill.
5d. Serve the enc-dec and VLM families at full width and depth:
   whisper_small on the dense slots (max_batch 8, cache_len 512; 1500
   encoder frames drawn in bf16 from a seeded generator; 8 greedy and 2
   sampled requests of 4–64 prompt tokens, 128 new each): exactly 24 flash
   launches a prefill (12 non-causal) and 24 dense decodes a step (12
   self, 12 cross), a decode step and a prefill profiled as in 5b; then
   internvl2_2b on phase 5's paged engine and traffic, each prompt 256
   image positions longer (seeded patches): 24 flash launches a prefill
   and 24 paged decodes a step, and phase 6's profile.  Reports as 5.
5e. Serve the dense configs on phase 5's engine: qwen25_3b (36 layers) and
   starcoder2_15b (40) at full width and depth, granite_34b at full width
   and 40 of its 88 layers (88 would hold 95.7 GB of serving params, more
   than the card); 8 greedy requests of 16–512 prompt tokens and 1 sampled
   (T=0.8, top-k 40), 32 new tokens each, no profile: exactly L flash
   launches a prefill and L paged decodes a step; tokens/s, TTFT p50,
   decode-step p50, the setup's peak beside ``_serving_bytes``'s
   prediction, the serving peak.
6. Profile — where one decode step (B=8) and one 512-token prefill spend
   their time: wall vs device kernel time (``torch.profiler``), and the
   decode-attention and flash kernels' shares, outside the engine's threads.
7. Ops and STREAM — the reference's single-source kernel API
   (``repro_torch.kernels.ops``) at full widths, once each:
   ``decode_attention`` on starcoder2_3b's dense cache, ``ssd_scan`` at
   mamba2_780m, ``rglru_scan`` at recurrentgemma_2b and ``stream_triad``
   at N = 2²⁷ in fp32 and bf16.  Checks each output against its plain
   version (the absolute limit, and ``ROW_TOL`` against the plain version
   in fp32; the triad bit-equal) and that each kernel launched exactly
   once per call.  Reports STREAM (HPX.Compute) from phase 3's triad
   timings: GB/s (2 reads + 1 write) beside torch's native fp32
   ``torch.add(a, b, alpha=3.0)`` and their ratio.
8. Training — (a) parity: starcoder2_3b at full width and 2 layers, fp32
   (TF32 off), B=1, S=256: one step's loss and every gradient on the card
   against the CPU (none all zero), the same grads under full and dots
   remat (``REMAT_RTOL``; 4 flash launches each), and the AdamW update on
   the card's grads against the CPU's, within ``TRAIN_*`` limits.  (b) The full
   30-layer starcoder2_3b (3.18 B params, fp32 masters, bf16 compute)
   trained by ``Trainer.fit`` under the futurized plan, B=2, S=512, 3
   steps, log_every 1: finite loss and grad norm, exactly 30 flash
   launches a step; step-time p50, tokens/s, peak memory and one step
   under torch.profiler; then one bsp step (full remat) on the same
   params and batch as a futurized step: 60 launches, the same loss,
   grads and grad norm within bf16 limits; then two futurized steps of
   16,384 tokens (8 microbatches of one 2048-token sequence): 240
   launches each, AdamW's share of the step's device time, tokens/s and
   peak memory.  (c) A checkpoint on the card at 2 layers: async save
   after step 2, a new trainer resumed equal, the next step's loss equal.
8c. Training the other families — granite_moe_3b_a800m, mamba2_780m and
   recurrentgemma_2b, each first held card against CPU (fp32, full width,
   2 layers; recurrentgemma_2b one (rec, rec, attn) group: the loss and
   every gradient), then at full width and depth through ``Trainer.fit``,
   futurized, 16,384 tokens a step (8 microbatches of one 2048-token
   sequence): 2 steps with exact launches a microbatch (32 flash; 48 SSD;
   18 RG-LRU forward + 18 backward and 8 flash), finite losses, step
   times, tokens/s and peak memory; then one step more with forward +
   backward against AdamW, and under torch.profiler.
8d. The same for whisper_small (parity at 2 + 2 layers; its synthetic
   batches carry ``seq_len`` encoder frames) and internvl2_2b (2 layers;
   256 patch positions without loss): 24 flash launches a microbatch each.
9. The HPX local runtime — (a) the fourteen parallel algorithms of
   ``core.algorithms`` (reduce and both scans also under an elementwise
   maximum) under ``vec`` on CUDA tensors of 2²⁷ int64 and fp32 elements,
   each held against the port's ``vec`` on the CPU over the same data
   (exact, or fp32 sums and scans within ``RUNTIME_SUM_RTOL`` of the
   magnitudes they add), then against ``seq``, ``par`` and ``par_task``
   over a 2¹⁶-element host cut, ``par_task`` and ``vec`` with ``task``
   returning futures; each timed, GB/s beside phase 7's triad.  (b) Full
   starcoder2_3b's compute params in AGAS: a parcel takes their global
   norm where they live (equal to the direct one; the parcel counters
   step by one), a migration to the host and back (generations 0 → 1 →
   2, the GID kept, bit-equal, GB/s each way); ``save_gid`` /
   ``restore_gid`` of phase 8's 2-layer training state (bit-equal, the
   name kept, a new GID).  (c) The dataflow 1F1B pipeline
   (``train/pipeline.py``) over full starcoder2_3b in 4 stages by
   ``split_stages``, 4 microbatches of one 512-token sequence: fp32 at 4
   layers against one monolithic autograd pass (``PIPE_TOL``), exactly 36
   tasks and 16 flash launches; then 30 layers in bf16, 2 steps with
   exactly 120 flash launches each, finite loss and grads, the step's wall
   time, peak memory and a profiled step, beside the monolithic pass.

10. Serve across localities — full starcoder2_3b in bf16 (seed 0,
   max_batch 8, cache_len 1024, pages of 16) on every locality, each its
   own process and CUDA context on the one card (``repro_torch.net``; the
   workers are spawned, so this script's top level only defines).  (a)
   ``Router.over_localities`` puts engine#0 at the root and engine#1 at
   locality 1; 12 streamed greedy requests (prompts of 16–512 tokens, 32
   new each): every stream equals its future, both localities generate,
   and at every locality flash launched exactly 30 × its prefills and
   paged decode 30 × its decode steps (each locality's own
   ``ops.launch_counts()``, read through ``run_on``).  (b) ``grow_engine``
   spawns locality 2 (engine#2, tier ``batch``); twelve requests go
   straight to engine#1 twice without migration, then a third time with
   ``migrate_engine`` moving engine#1 to locality 2 once every active
   stream holds 8 tokens: every stream equals its future (33 tokens), the
   relay's duplicate counter does not move, the requests moved equal
   locality 2's ``migrated_in`` and include the 8 active ones, and
   engine#1 serves at its new home; the cutover's time and the KV bytes
   moved are reported.  (c) During the first unmigrated run one active
   slot's KV goes from locality 1 to locality 2 through ``run_on``, is
   restored into engine#2's pool, snapshotted again and shipped back:
   bit-equal as bf16 bits.  (d) If the two unmigrated runs agree bit for
   bit, the migrated tokens must equal them (else the count that agrees is
   reported).  (e) A traced run (``enable_fleet``, clock-corrected
   ``merged_trace``) of 9 requests over the three engines: every critical
   path tiles its request with no gap and clamps under 1 %, every remote
   request's path holds a latency segment, and one ``/metrics`` sweep
   reads every locality's engine counters equal to ``query_counters``.
   Reports tokens/s per engine, decode-step p50 and peak memory per
   locality, the SLOW shares by locality and the phase's seconds.

11. The data half of the multi-locality runtime — two localities (the
   root and a spawned worker, each its own CUDA context on the card).  (a)
   A block ``PartitionedVector`` of 2²⁷ fp32 elements (512 MB) filled in
   place by a seeded ``fill_with`` generator; ``reduce``,
   ``transform_reduce``, ``count_if``, ``min_element``, ``max_element``,
   ``transform``, both scans (two-pass) and ``fill`` on it, each held
   against the port's ``vec`` on one CUDA tensor of the same elements
   (exact, or sums and scans within ``RUNTIME_SUM_RTOL`` of the magnitudes
   added); cyclic and explicit layouts (one empty and one single-element
   segment) and ``sort`` at 2¹⁶ elements; the wire bytes
   (``/net{*}/bytes/sent`` over both localities) of the segmented reduce,
   under 1 % of the element bytes, against ``to_array`` + a local sum;
   ``move_segment`` to locality 1 and back (the GID kept, bit-equal, still
   on ``cuda``); the reduce body's device GB/s at each owner beside phase
   7's triad.  (b) ``launch.train.main`` in process: full starcoder2_3b
   (30 layers), ``--localities 2 --sharded-rows 16384 --batch 2 --seq 512
   --steps 3 --log-every 1`` with ``--trace``, ``--print-counters
   '/train*'``, ``--metrics-port`` and ``--timeline`` into
   ``chiprun_out/``: 8192 local rows; each step's batch equal to
   ``synth_token_rows`` of the rows the feeder picked; finite losses and
   grad norms; exactly 30 flash launches a step; the dataset's creation
   under 1 % of its 33.6 MB on the wire; the merged trace holding both
   localities; ``obs.top --once --metrics`` rendering a frame while the
   exporter lives; step p50, tokens/s and peak beside phase 8b's.  (c) The
   sharded dataset saved by ``save_partitioned`` after a ``move_segment``
   (each shard written by its owner, locality 1), freed, restored at those
   owners bit-equal; phase 8's 2-layer training state with its bf16
   compute params made at locality 1, saved by GID, unregistered, restored
   by ``restore_gid`` onto a grown locality 2 and fetched back: every
   leaf's dtype, shape and sum of bit patterns (bf16 as its bits) equal to
   the state made at locality 1; the seconds of each step.

12. The device plane — a one-rank NCCL process group made by
   ``launch.mesh`` (NCCL puts no two ranks on one card; multi-rank meshes
   are held on gloo by the CPU tests) after phase 11's localities are
   gone, destroyed at the end.  (a) Phase 8a's fp32 2-layer state: one
   futurized step's loss and every gradient on a ("data", "model") 1×1
   mesh of DTensors (flash through ``local_map``) against the same step
   without a mesh, within phase 8a's limits, 2 flash launches either way.
   (b) Full starcoder2_3b (30 layers) under ``get_plan("futurized",
   compress_pod_grads=True)``: ``Trainer(mesh=...)`` on the 1×1 mesh at
   phase 8b's shape, 2 steps; ``elastic_restart`` onto a ("pod", "data",
   "model") 1×1×1 mesh, 2 steps through the pod-manual branch (every
   gradient a bf16 NCCL all-reduce over the pod group, counted): losses
   within ``TRAIN_BF16_LOSS_TOL`` of phase 8b's at the same seed and
   batches, the GID kept and its generation bumped once, the restart
   counter at 1, exactly 30 flash launches a step; step p50, tokens/s,
   kernels a step and device-busy share beside phase 8b's, the peak, the
   restart's seconds.  (c) Phase 8's 2-layer checkpoint restored onto the
   mesh by ``ckpt.restore(shardings=)``: every leaf bit-equal to a plain
   restore and on its requested placements.  (d) ``MeshExecutor`` over
   phase 9's 2²⁷ fp32 elements: transform, reduce, transform_reduce and
   count_if under ``mesh_policy`` against ``vec`` (exact, sums within
   ``RUNTIME_SUM_RTOL``), GB/s beside phase 7's triad.  The report lands
   in ``REPORT["mesh"]``.
13. The dry run (``launch/dryrun.py``) on the card — the kernels are
   ``repro_torch::`` torch ops, so a step traces on fake CUDA tensors on a
   ``fake`` process group with nothing launched.  (a) Full starcoder2_3b
   at phase 12(b)'s shape and plan on a fake (pod, data, model) 1×1×1
   mesh: exactly 30 flash-op calls and phase 12(b)'s bf16 all-reduces a
   step; the predicted peak beside 12(b)'s and 8b's measured ones, the
   roofline's terms beside 8b's step.  (b) One paged decode step at
   phase 5's engine shape traced: its decode-op calls equal one real
   step's launch counts.  (c) starcoder2_3b train_4k on the 256-rank pod
   mesh, the card's route, traced by ``launch/dryrun.py`` in a process of
   its own started before phase 12: trace time, predicted peak, roofline.
   (d) Real bf16 steps on a one-rank NCCL mesh against the same without
   one: full mamba2_780m training at 1,024 tokens (exact SSD launches,
   loss within ``DRY_LOSS_TOL``) and full recurrentgemma_2b prefill + 8
   decode steps (exact RG-LRU, flash and dense-decode launches, equal
   greedy tokens).  The report lands in ``REPORT["dryrun"]``.
14. The reference's last entry points, ported: ``examples/quickstart_torch.py``
   (its printed values as the reference quickstart's) and
   ``examples/serve_lm_torch.py`` in one process (10 streamed requests over
   two replicas of the qwen25_3b smoke config; 2 flash launches a request)
   on the card; then ``examples/tiled_cholesky_torch.py``'s dataflow tiled
   Cholesky at N = 16,384 in tiles of 1,024, fp32 with TF32 off, against
   ``torch.linalg.cholesky`` on the same matrix: max|L − L_lib| /
   max|L_lib| ≤ 1e-5 and exactly 816 tasks executed each call; the median
   time of each beside the other (reported, not gated).

The second-to-last line of standard output is the ``kernels`` JSON, each
kernel's launches summed over the paths of phases 5, 5c, 5b, 5d, 5e, 7, 8b,
8c, 8d, 9, 10, 11, 12, 13(d) and 14 (phase 10's summed over its localities); the last
is ``{"ok": true, "device": {...}}``.  A fuller report is written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
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
                                                          # (bf16 on tensor cores)
# The tight limit of phase 3: the worst output row's relative error,
# ‖o − e‖₂ / ‖e‖₂ over each row of Dh, against the plain version run in
# fp32 on the same inputs.  In bf16, rounding the output costs at most
# 2⁻⁸ ≈ 3.9e-3 of a row (the plain version's own bf16 output reads ~2.3e-3
# at these shapes); the flash tensor-core kernel also rounds P to bf16 for
# P·V, about as much again.  fp32 differs only in summation order.  A
# window, valid_len or length bound that is off by one moves some row by
# 0.5 or more, and phase 3 checks that it moves it past the limit.
# The scans: the RG-LRU kernel does the same rounded product and sum per
# step as its plain version, but composes the carry at each 64-step chunk
# edge in another order (a few ulps, decaying with a < 1: fp32 within
# ~5e-7 of a row even at a in (0.99, 1)); the SSD's in-chunk cumsum of dt·A
# (|cum| up to ~200) runs in another order on each side, which moves
# exp(cum_i − cum_j) by up to ~1e-4 relative; the triad is bit-equal.
ROW_TOL = {("flash_attention", "float32"): 1e-5,
           ("flash_attention", "bfloat16"): 1e-2,
           ("paged_decode_attention", "float32"): 1e-5,
           ("paged_decode_attention", "bfloat16"): 5e-3,
           ("decode_attention", "float32"): 1e-5,
           ("decode_attention", "bfloat16"): 5e-3,
           ("ssd_scan", "float32"): 1e-3,
           ("ssd_scan", "bfloat16"): 5e-3,
           ("rglru_scan", "float32"): 1e-6,
           ("rglru_scan", "bfloat16"): 5e-3,
           ("stream_triad", "float32"): 0.0,
           ("stream_triad", "bfloat16"): 5e-3}
# the absolute limit against the plain version in the kernel's own dtype
ABS_TOL = {name: {"float32": 2e-5 * m, "bfloat16": 2e-2 * m}
           for name, m in (("flash_attention", 4), ("paged_decode_attention", 4),
                           ("decode_attention", 4), ("ssd_scan", 8),
                           ("rglru_scan", 4))}
ABS_TOL["stream_triad"] = {"float32": 0.0, "bfloat16": 0.0}
SSD_RTOL = 1e-2                                            # test_kernels.py
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
@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms(torch) -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin kernel."""
    cycles = 10_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(cycles)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def _time_ms(torch, fn, flush, reps=25, warmup=3):
    """Median device time of one call: CUDA events around each call, L2
    flushed (64 MB written) before each, outside the events.  Between the
    flush and the start event a spin kernel runs for twice the host's
    enqueue time of one call (measured in the warm-up) plus 50 µs, so the
    device is still busy while the host checks inputs, allocates and
    launches: the window holds the call's device work, not a wait for the
    host."""
    enqueue = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    spin = int((2e3 * max(enqueue[1:] or enqueue) + 0.05) * _spin_cycles_per_ms(torch))
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _ops_ms(flops: dict) -> float:
    """Least time for {dtype: flops}, each at its dtype's peak rate."""
    return sum(n / PEAK_FLOPS[dtype] for dtype, n in flops.items()) * 1e3


def _bound(nbytes: float, flops: dict):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, _ops_ms(flops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _splits(torch, B, H, KV, extent_tiles, tile) -> int:
    """The split count the decode wrappers choose for this shape on this card."""
    from repro_torch.kernels.decode_attention import split_plan

    return split_plan(B, KV, extent_tiles, tile, H // KV, torch.cuda.current_device())[0]


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


def _internvl_lens():
    """Phase 5d's decode lengths at internvl2_2b, B=8: 256 image positions
    + 16–512 prompt tokens + up to 64 new (their own draw, so that the
    other cases keep theirs)."""
    import numpy as np

    return (np.random.default_rng(SEED + 9).integers(256 + 16, 256 + 512 + 65, size=8)
            .tolist())


def _time_cross_attention(torch, F, gen, flush):
    """The enc-dec decoder's full-sequence cross-attention, which the port
    computes as the reference does, in plain math (``Lx.sdpa``: fp32
    scores, softmax, P in bf16 for P·V; no kernel of either package): its
    device time in bf16 at whisper_small's prefill (64 queries over 1500
    frames) and at its training microbatch (2048 over 2048), beside SDPA
    (non-causal) on the same inputs."""
    from repro_torch.models.layers import sdpa

    H, KV, Dh = WHISPER_ATTN
    out = []
    for Sq, T in ((64, WHISPER_FRAMES), (2048, 2048)):
        q = torch.randn(1, Sq, KV, H // KV, Dh, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(1, T, KV, Dh, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        qt = q.reshape(1, Sq, H, Dh).transpose(1, 2).contiguous()
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        out.append({"Sq": Sq, "T": T, "H": H, "Dh": Dh, "dtype": "bfloat16",
                    "plain_ms": _time_ms(torch, lambda: sdpa(q, k, v, Dh ** -0.5), flush),
                    "library_ms": _time_ms(
                        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), flush)})
        log(f"[kernels] cross-attention (plain math) Sq={Sq} T={T}: "
            f"{out[-1]['plain_ms']:.4f} ms (SDPA {out[-1]['library_ms']:.4f})")
    return out


def phase_kernels(torch, np):
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (paged_decode_attention_plain,
                                                      split_ranges)
    from repro_torch.kernels.flash_attention import flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in fp32
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    checks = []
    worst = {k: {"abs": 0.0, "row": 0.0, "off_by_one": math.inf} for k in ops.KERNELS}

    def record(kind, shape, dtype, o, e, e32, off_by_one):
        """o: the kernel's output; e: its plain version on the same inputs;
        e32: the plain version in fp32 on them; off_by_one: the fp32 plain
        version with one bound moved by one (None where the case has none)."""
        name = "float32" if dtype == torch.float32 else "bfloat16"
        atol = ABS_TOL[kind][name]
        rtol = SSD_RTOL if kind == "ssd_scan" else 0.0
        diff = (o.float() - e.float()).abs()
        err = diff.max().item()
        within = bool((diff <= atol + rtol * e.float().abs()).all().item())
        row, row_tol = _row_err(o, e32), ROW_TOL[kind, name]
        moved = None if off_by_one is None else _row_err(off_by_one, e32)
        ok = within and row <= row_tol and (moved is None or moved > row_tol)
        checks.append({"kernel": kind, "shape": shape, "dtype": name,
                       "max_abs_err": err, "tol": atol, "rtol": rtol,
                       "max_row_err": row, "row_tol": row_tol,
                       "off_by_one_row_err": moved, "ok": ok})
        w = worst[kind]
        w["abs"], w["row"] = max(w["abs"], err), max(w["row"], row)
        if moved is not None:
            w["off_by_one"] = min(w["off_by_one"], moved)
        check(ok, f"{kind} {shape} {name}: max abs err {err} (tol {atol}, rtol "
                  f"{rtol}), row err {row} (tol {row_tol}), off-by-one bound "
                  f"moves {moved}")

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
    # every head dim (bf16: the wgmma body at all of them)
    flash_cases += [((1, 100, 2, 1, 16), True, 0, 0), ((1, 130, 2, 2, 256), True, 0, 0),
                    ((1, 130, 2, 2, 256), False, 0, 70), ((1, 200, 4, 2, 32), True, 0, 0),
                    ((1, 1000, 10, 1, 256), True, 0, 0)]
    # q heads per KV head G = 1, 2, 12, 24 (1, 2, 4 and 8 heads per tile),
    # at S off the 64-position tile
    flash_cases += [((1, S, H, KV, 128), True, 0, 0)
                    for S, (H, KV) in ((100, (4, 4)), (130, (4, 2)), (200, (24, 2)),
                                       (1000, (24, 1)))]
    # windows and valid_len one off a K-tile edge on either side, so each
    # edge tile's mask and the tile range are both held (each with the
    # off-by-one check); recurrentgemma_2b's local attention shape too
    flash_cases += [(slice_shape, True, w, 0) for w in (63, 64, 65, 129)]
    flash_cases += [(slice_shape, causal, 0, vl) for causal in (True, False)
                    for vl in (127, 128, 129)]
    flash_cases += [((1, 300, 10, 1, 256), True, 65, 0), ((1, 300, 10, 1, 256), False, 0, 193)]
    # a window and valid_len together: rows from 363 on have no unmasked
    # key and must be zeros, as in the plain version (a row error of
    # |o| / 1e-12 there otherwise)
    flash_cases += [(slice_shape, causal, 64, 300) for causal in (True, False)]
    # a grid of more than one wave (1,536 blocks of 128 rows on 132 SMs)
    flash_cases += [((4, 2048, 24, 2, 128), True, 0, 0)]
    # the MoE family's groups, one and three q heads per KV head (a tile
    # of 8 heads then holds a partial group, whose rows must stay its
    # own): deepseek_moe_16b's prefill (G = 1, Dh 128) and
    # granite_moe_3b_a800m's training microbatch (G = 3, Dh 64), on and off
    # the tile, with valid_len and a window
    flash_cases += [((1, S) + DEEPSEEK_ATTN, True, 0, 0) for S in (512, 300)]
    flash_cases += [((1, S) + GRANITE_ATTN, True, 0, 0) for S in (2048, 200)]
    flash_cases += [((1, 512) + DEEPSEEK_ATTN, True, 0, 300),
                    ((2, 200) + GRANITE_ATTN, True, 64, 0)]
    # the enc-dec and VLM families: whisper_small's encoder, non-causal over
    # 1500 frames (off the 64-position tile), also with valid_len on its
    # end (1499 is the off-by-one); its decoder's prefill and its training
    # microbatch (2048 positions, the decoder causal, the encoder not);
    # internvl2_2b's prefill (G = 2, Dh 128) and a bucketed one
    flash_cases += [((1, WHISPER_FRAMES) + WHISPER_ATTN, False, 0, 0),
                    ((1, WHISPER_FRAMES) + WHISPER_ATTN, False, 0, WHISPER_FRAMES),
                    ((1, 64) + WHISPER_ATTN, True, 0, 0),
                    ((1, 2048) + WHISPER_ATTN, True, 0, 0),
                    ((1, 2048) + WHISPER_ATTN, False, 0, 0),
                    ((1, 512) + INTERNVL_ATTN, True, 0, 0),
                    ((1, 512) + INTERNVL_ATTN, True, 0, 300)]
    slice_lens = rng.integers(1, 577, size=8).tolist()
    paged_cases = [(slice_lens, 24, 2, 128, 16, 64)]
    for (B, H, KV, Dh, page, maxp) in [(3, 4, 2, 64, 32, 8), (2, 8, 8, 32, 16, 4),
                                       (1, 8, 1, 64, 64, 4)]:
        paged_cases.append((rng.integers(1, page * maxp + 1, size=B).tolist(),
                            H, KV, Dh, page, maxp))
    # the split edges at the serving shape (decode_splits: 16 splits of 4
    # pages on 132 SMs): lengths on an edge and ±1, a lone long request
    # among length-1 ones, requests all shorter than one split; and a
    # 4-page table, which takes one split
    edge = 16 * split_ranges(64, _splits(torch, 8, 24, 2, 64, 16))[0][1]
    paged_cases += [([edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge, 2 * edge + 1,
                      1024 - edge, 1024], 24, 2, 128, 16, 64),
                    ([1000] + [1] * 7, 24, 2, 128, 16, 64),
                    ([1, 2, 3, 5, 8, 13, edge - 2, edge - 1], 24, 2, 128, 16, 64),
                    ([1, 17, 40, 64], 24, 2, 128, 16, 4)]
    # groups above 16 (two m-tiles, the second partial), pages that do not
    # divide a 64-token chunk, and pages longer than one
    paged_cases += [([0, 25, 200, 288], 40, 2, 64, 24, 12),
                    ([1, 130, 511], 8, 1, 32, 128, 4)]
    # splits that walk many chunks, so that the in-loop prefetch runs and
    # the ring of STAGES chunk buffers wraps: a batch of 32 at the serving
    # shape (4 splits of 256 tokens on 132 SMs) and the long context (16
    # splits of 1,024 tokens), lengths on and beside split and chunk edges
    paged_cases += [([1, 63, 64, 65, 255, 256, 257, 511, 512, 513, 767, 768, 769, 1023,
                      1024] + rng.integers(1, 1025, size=17).tolist(),
                     24, 2, 128, 16, 64),
                    ([LONG_CONTEXT, LONG_CONTEXT - 1, 1025, 1024, 9000, 5, 12345, 16000],
                     24, 2, 128, 16, LONG_CONTEXT // 16)]
    # the MoE family's decode at B=8, lengths of phase 5c's traffic: G = 1
    # (one q row of a 16-row MMA tile) and G = 3 (drawn apart, so that the
    # cases above keep their draws)
    moe_rng = np.random.default_rng(SEED + 7)
    paged_cases += [(moe_rng.integers(1, 577, size=8).tolist(), *attn, 16, 64)
                    for attn in (DEEPSEEK_ATTN, GRANITE_ATTN)]
    # internvl2_2b's decode at B=8 (G = 2, Dh 128): phase 5d's lengths, 256
    # image positions + 16–512 prompt tokens + up to 64 new
    paged_cases.append((_internvl_lens(), *INTERNVL_ATTN, 16, 64))
    for dtype in (torch.float32, torch.bfloat16):
        for (B, S, H, KV, Dh), causal, window, vl in flash_cases:
            q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, dtype)
            masks = {"causal": causal, "window": window, "valid_len": vl}
            o = torch.ops.repro_torch.flash_attention(q, k, v, causal, window, vl)
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
            o = torch.ops.repro_torch.paged_decode_attention(q, kp, vp, pt, lengths)
            torch.cuda.synchronize()
            f32 = [x.float() for x in (q, kp, vp)]
            splits = _splits(torch, len(lens), H, KV, maxp, page)
            record("paged_decode_attention", [len(lens), H, KV, Dh, page, maxp, lens,
                                              f"splits {splits}"], dtype,
                   o, paged_decode_attention_plain(q, kp, vp, pt, lengths),
                   paged_decode_attention_plain(*f32, pt, lengths),
                   paged_decode_attention_plain(*f32, pt, (lengths - 1).clamp_min(1)))
    _check_ops_kernels(torch, gen, rng, record)
    _check_dense_configs_attention(torch, record)
    _check_flash_modes(torch, gen, record)
    _check_flash_bwd(torch, gen)
    _check_scan_bwd(torch, gen)
    REPORT["kernel_checks"] = checks
    REPORT["kernel_worst"] = worst
    log(f"[kernels] {len(checks)} checks within tolerance")
    for name, w in worst.items():
        log(f"[kernels] {name}: worst abs err {w['abs']:.3g} (tol {ABS_TOL[name]}), "
            f"worst row err {w['row']:.3g}; an off-by-one length moves a row by at "
            f"least {w['off_by_one']:.3g}")

    # timings at the serving path's shapes, bf16
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    bf16 = torch.bfloat16
    timings = {"flash_attention": [], "paged_decode_attention": []}
    # S=128/512/1000 first, in this order (the kernels line reads S=512),
    # then the serving run's most common bucket, recurrentgemma_2b's
    # local attention (head_dim 256), deepseek_moe_16b's prefill (G = 1)
    # and granite_moe_3b_a800m's training microbatch (G = 3); then the
    # enc-dec and VLM families: whisper_small's encoder over 1500 frames
    # (non-causal), its decoder's 64-token prefill, its training
    # microbatch's decoder (causal) and encoder (not), and internvl2_2b's
    # prefill
    for B, S, H, KV, Dh, causal in (
            (1, 128, 24, 2, 128, True), (1, 512, 24, 2, 128, True),
            (1, 1000, 24, 2, 128, True), (1, 256, 24, 2, 128, True),
            (1, 2048) + GRIFFIN_LOCAL[2:] + (True,), (1, 512) + DEEPSEEK_ATTN + (True,),
            (1, 2048) + GRANITE_ATTN + (True,),
            (1, WHISPER_FRAMES) + WHISPER_ATTN + (False,), (1, 64) + WHISPER_ATTN + (True,),
            (1, 2048) + WHISPER_ATTN + (True,), (1, 2048) + WHISPER_ATTN + (False,),
            (1, 512) + INTERNVL_ATTN + (True,)):
        timings["flash_attention"].append(
            _flash_timing(torch, F, flush, gen, B, S, H, KV, Dh, causal))
    B, H, KV, Dh, page, maxp = 8, 24, 2, 128, 16, 64
    lens = rng.integers(16, 577, size=B).tolist()   # prompts 16–512 + 64 new
    timings["paged_decode_attention"].append(_paged_timing(
        torch, flush, gen, lens, H, KV, Dh, page, maxp))
    # long context: every request at starcoder2-3b's 16,384 tokens
    timings["paged_decode_attention"].append(_paged_timing(
        torch, flush, gen, [LONG_CONTEXT] * B, H, KV, Dh, page, LONG_CONTEXT // page))
    for attn in (DEEPSEEK_ATTN, GRANITE_ATTN):  # the MoE family's decode, B=8
        timings["paged_decode_attention"].append(_paged_timing(
            torch, flush, gen, lens, *attn, page, maxp))
    # internvl2_2b's decode (G = 2, Dh 128) at phase 5d's lengths
    timings["paged_decode_attention"].append(_paged_timing(
        torch, flush, gen, _internvl_lens(), *INTERNVL_ATTN, page, maxp))
    REPORT["cross_attention_ms"] = _time_cross_attention(torch, F, gen, flush)
    timings.update(_time_ops_kernels(torch, F, gen, flush))
    _time_dense_configs_attention(torch, F, flush, timings)
    REPORT["kernel_timings"] = timings
    for name, rows in timings.items():
        for r in rows:
            log(f"[kernels] {name} {r['shape']}: {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
                f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return timings


# The backward of the training path's flash op: flash_attention_bwd (PyTorch
# math) against torch.autograd.grad through flash_attention_plain, on the
# card, at starcoder2_3b's training shape, causal and with a window; each
# gradient's worst row against autograd in fp32 on the same inputs.  A
# row's error is taken relative to its own norm, floored at 1e-3 of the
# tensor's largest row: some rows' exact gradient is 0 (the first query's
# dq: one key, so dS = P·(dP − rowsum(P ⊙ dP)) = 0) and would otherwise be
# held to the noise of the other side.  Each side's error against fp64
# autograd on the same inputs is reported beside (``vs_fp64``).  The
# limits come from readings at this shape on the card: fp32, the two sides
# differed by up to 6.6e-6 on one draw and 1.15e-4 on another (a dq row
# near the floor: dS cancels, so it carries the rounding of the large
# terms), and against fp64 on one draw of each kind the backward's worst
# row erred by 4.3e-6 and 1.19e-4, autograd through the plain version by
# 6.9e-6 and 3.7e-5; bf16, whose rounding of the gradients (≤ 2⁻⁹ of a
# row) is the lower-precision control, by 2.1–2.3e-3.  fp32's limit sits
# between the largest sound fp32 reading and that control; a window one
# short moves every gradient's worst row by 0.34 or more.
ROW_TOL.update({("flash_attention_bwd", "float32"): 1e-3,
                ("flash_attention_bwd", "bfloat16"): 1e-2})
TRAIN_SHAPE = (2, 512, 24, 2, 128)                        # B, S, H, KV, Dh


def _grad_row_err(o, e) -> float:
    """The worst row's ‖o − e‖₂ / max(‖e‖₂, 1e-3 · the largest ‖e‖₂), in
    fp64 where ``e`` is fp64, else in fp32."""
    o, e = (o.double(), e) if e.element_size() == 8 else (o.float(), e.float())
    norms = e.norm(dim=-1)
    return ((o - e).norm(dim=-1) / norms.clamp_min(1e-3 * norms.max().item() + 1e-12)
            ).max().item()


def _check_flash_bwd(torch, gen):
    from repro_torch.kernels.flash_attention import (_mask, flash_attention_bwd,
                                                     flash_attention_plain)

    def autograd(q, k, v, do, causal, window):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = flash_attention_plain(*leaves, causal=causal, window=window)
            return torch.autograd.grad(out, leaves, do)

    def autograd64(q, k, v, do, causal, window):
        """The same gradients in fp64: softmax(q·kᵀ/√Dh)·v, the kernel's masks"""
        B, S, H, Dh = q.shape
        KV = k.shape[2]
        leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            qg = leaves[0].reshape(B, S, KV, H // KV, Dh)
            s = torch.einsum("bqkgd,btkd->bkgqt", qg, leaves[1]) / math.sqrt(Dh)
            s = s.masked_fill(~_mask(S, causal, window, 0, q.device), float("-inf"))
            out = torch.einsum("bkgqt,btkd->bqkgd", torch.softmax(s, dim=-1), leaves[2])
            return torch.autograd.grad(out.reshape(B, S, H, Dh), leaves, do.double())

    rows = []
    # starcoder2_3b's training shape, causal and with a window; whisper_small's
    # encoder at its training microbatch, non-causal (no bound to move)
    cases = [(TRAIN_SHAPE, True, 0), (TRAIN_SHAPE, True, 128),
             ((1, 2048) + WHISPER_ATTN, False, 0)]
    for dtype in (torch.float32, torch.bfloat16):
        name = "float32" if dtype == torch.float32 else "bfloat16"
        for (B, S, H, KV, Dh), causal, window in cases:
            q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, dtype)
            do = torch.randn(B, S, H, Dh, generator=gen, device="cuda").to(dtype)
            got = flash_attention_bwd(q, k, v, do, causal, window)
            torch.cuda.synchronize()
            same = autograd(q, k, v, do, causal, window)
            f32 = [x.float() for x in (q, k, v, do)]
            e32 = autograd(*f32, causal, window)
            moved = autograd(*f32, causal, window - 1) if window else None
            e64 = autograd64(q, k, v, do, causal, window)
            errs = {}
            for gname, g, e, w, m, x in zip(("dq", "dk", "dv"), got, same, e32,
                                            moved or (None,) * 3, e64):
                check(g.dtype == dtype and g.shape == e.shape and
                      bool(torch.isfinite(g).all().item()), f"flash bwd {gname}: bad output")
                errs[gname] = {"max_abs_err": (g.float() - e.float()).abs().max().item(),
                               "max_row_err": _grad_row_err(g, w),
                               "off_by_one_row_err": None if m is None else _grad_row_err(m, w),
                               "vs_fp64": {"kernel": _grad_row_err(g, x),
                                           "plain": _grad_row_err(e, x)}}
            del e64
            worst = max(r["max_row_err"] for r in errs.values())
            moves = (None if moved is None else
                     max(r["off_by_one_row_err"] for r in errs.values()))
            ok = worst <= ROW_TOL["flash_attention_bwd", name] and (moves is None or moves > ROW_TOL["flash_attention_bwd", name])
            rows.append({"shape": [B, S, H, KV, Dh, int(causal), window], "dtype": name,
                         "grads": errs,
                         "row_tol": ROW_TOL["flash_attention_bwd", name], "ok": ok})
            check(ok, f"flash bwd {[B, S, H, KV, Dh, causal, window]} {name}: row err {worst} "
                      f"(tol {ROW_TOL["flash_attention_bwd", name]}), off-by-one window moves {moves}")
    # its time at the training shape in bf16, as a layer's backward calls it
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    B, S, H, KV, Dh = TRAIN_SHAPE
    q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, torch.bfloat16)
    do = torch.randn(B, S, H, Dh, generator=gen, device="cuda").to(torch.bfloat16)
    REPORT["flash_bwd_ms"] = _time_ms(torch, lambda: flash_attention_bwd(q, k, v, do), flush)
    # and at a microbatch of phase 8b's step of 16,384 tokens
    B, S = TRAIN_WIDE[0] // TRAIN_WIDE[2], TRAIN_WIDE[1]
    q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, torch.bfloat16)
    do = torch.randn(B, S, H, Dh, generator=gen, device="cuda").to(torch.bfloat16)
    REPORT["flash_bwd_ms_wide"] = _time_ms(torch, lambda: flash_attention_bwd(q, k, v, do),
                                           flush)
    # and whisper_small's encoder backward, non-causal, at its microbatch
    Bw, Sw, Hw, KVw, Dhw = (1, 2048) + WHISPER_ATTN
    qw, kw, vw = _flash_inputs(torch, gen, Bw, Sw, Hw, KVw, Dhw, torch.bfloat16)
    dow = torch.randn(Bw, Sw, Hw, Dhw, generator=gen, device="cuda").to(torch.bfloat16)
    REPORT["flash_bwd_ms_noncausal"] = _time_ms(
        torch, lambda: flash_attention_bwd(qw, kw, vw, dow, False, 0), flush)
    REPORT["flash_bwd_checks"] = rows
    fp64 = {side: max(g["vs_fp64"][side] for r in rows if r["dtype"] == "float32"
                      for g in r["grads"].values()) for side in ("kernel", "plain")}
    log(f"[kernels] flash_attention_bwd: {len(rows)} checks within tolerance, worst row "
        f"err {max(max(g['max_row_err'] for g in r['grads'].values()) for r in rows):.3g}; "
        f"fp32 against fp64 on the same inputs: bwd {fp64['kernel']:.3g}, autograd "
        f"through plain {fp64['plain']:.3g}; "
        f"{REPORT['flash_bwd_ms']:.4f} ms at {list(TRAIN_SHAPE)} bf16 causal, "
        f"{REPORT['flash_bwd_ms_wide']:.4f} ms at B={B}, S={S}; non-causal "
        f"{REPORT['flash_bwd_ms_noncausal']:.4f} ms at {[Bw, Sw, Hw, KVw, Dhw]}")


# The scans' backward on the training path (``ops.ssd_scan_bwd`` behind
# ``ssd_scan_trainable``, ``ops.rglru_scan_bwd`` behind
# ``rglru_scan_trainable``), fp32, at mamba2_780m's and recurrentgemma_2b's
# widths on the card: each gradient's worst row (``_grad_row_err``)
# against autograd through the sequential oracle of ``kernels/ref.py``,
# the same recurrence in another form.  The SSD's backward is autograd
# through the chunked plain version, whose in-chunk cumsum of dt·A runs
# in another order than the oracle's step-by-step decay: the forward's
# fp32 limit holds it (the CPU read 2.9e-5 at S=512).  The RG-LRU's is
# the kernel run again over the reversed sequence, a few ulps apart at
# chunk edges as its forward; a_t where a_{t+1} belongs (the derivation's
# off-by-one) moves the gradient's rows far past the limit.  The SSD's
# oracle keeps every step's state for its backward, so it runs at S=1024
# (4 chunks); both backwards are then timed as the models call them
# (bf16 x, B and C with fp32 dt; fp32 a and b) at S=2048.
ROW_TOL.update({("ssd_scan_bwd", "float32"): ROW_TOL["ssd_scan", "float32"],
                ("rglru_scan_bwd", "float32"): 1e-5})
SSD_BWD_CHECK_S = 1024


def _check_scan_bwd(torch, gen):
    from repro_torch.kernels import ops, ref

    def oracle(fn, inputs, cot):
        leaves = [t.detach().requires_grad_() for t in inputs]
        with torch.enable_grad():
            return torch.autograd.grad(fn(*leaves), leaves, cot)

    out = {}
    B, S, W = GRIFFIN_LRU
    a, b = _rglru_inputs(torch, gen, B, S, W, torch.float32)
    dh = torch.randn(B, S, W, generator=gen, device="cuda")
    with torch.no_grad():
        h = ops.rglru_scan(a, b)
        got = ops.rglru_scan_bwd(a, h, dh)
        wrong = ref.rglru(a.flip(1), dh.flip(1)).flip(1)  # db with a_t for a_{t+1}
    torch.cuda.synchronize()
    want = oracle(ref.rglru, (a, b), dh)
    errs = {n: _grad_row_err(g, e) for n, g, e in zip(("da", "db"), got, want)}
    moved = _grad_row_err(wrong, want[1])
    tol = ROW_TOL["rglru_scan_bwd", "float32"]
    out["rglru_scan_bwd"] = {"shape": [B, S, W], "dtype": "float32", "row_err": errs,
                             "off_by_one_row_err": moved, "row_tol": tol}
    check(max(errs.values()) <= tol < moved,
          f"rglru bwd {[B, S, W]}: row errs {errs} (tol {tol}), off-by-one moves {moved}")
    del want, wrong

    B, _, H, P, G, N = MAMBA
    S = SSD_BWD_CHECK_S
    inputs = _ssd_inputs(torch, gen, B, S, H, P, G, N, torch.float32)
    dy = torch.randn(B, S, H, P, generator=gen, device="cuda")
    got = ops.ssd_scan_bwd(*inputs, dy, MAMBA_CHUNK)
    want = oracle(lambda *t: ref.ssd(*t)[0], inputs, dy)
    errs = {n: _grad_row_err(g, e) for n, g, e in zip(("dx", "ddt", "dA", "dBm", "dCm"),
                                                     got, want)}
    tol = ROW_TOL["ssd_scan_bwd", "float32"]
    out["ssd_scan_bwd"] = {"shape": [B, S, H, P, G, N], "chunk": MAMBA_CHUNK,
                           "dtype": "float32", "row_err": errs, "row_tol": tol}
    check(all(bool(torch.isfinite(g).all().item()) for g in got) and
          max(errs.values()) <= tol, f"ssd bwd {[B, S, H, P, G, N]}: row errs {errs} "
                                     f"(tol {tol})")
    del got, want

    # their time per call, as the models' backward calls them
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    B, S, W = GRIFFIN_LRU
    a, b = _rglru_inputs(torch, gen, B, S, W, torch.float32)
    dh = torch.randn(B, S, W, generator=gen, device="cuda")
    with torch.no_grad():
        h = ops.rglru_scan(a, b)
        out["rglru_scan_bwd"]["ms"] = _time_ms(torch, lambda: ops.rglru_scan_bwd(a, h, dh),
                                               flush)
    B, S, H, P, G, N = MAMBA
    x, dt, A, Bm, Cm = _ssd_inputs(torch, gen, B, S, H, P, G, N, torch.bfloat16,
                                   dt_fp32=True)
    dy = torch.randn(B, S, H, P, generator=gen, device="cuda").to(torch.bfloat16)
    out["ssd_scan_bwd"]["ms"] = _time_ms(
        torch, lambda: ops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, MAMBA_CHUNK), flush)
    out["ssd_scan_bwd"]["timed_shape"] = [B, S, H, P, G, N]
    out["rglru_scan_bwd"]["launches_per_call"] = 1  # rglru_scan, the sequence reversed
    out["ssd_scan_bwd"]["launches_per_call"] = 0    # PyTorch math
    REPORT["scan_bwd"] = out
    r, d = out["rglru_scan_bwd"], out["ssd_scan_bwd"]
    log(f"[kernels] rglru_scan_bwd {r['shape']} fp32: row errs "
        f"{ {k: f'{v:.3g}' for k, v in r['row_err'].items()} } (tol {r['row_tol']}), "
        f"off-by-one moves {r['off_by_one_row_err']:.3g}; {r['ms']:.4f} ms a call")
    log(f"[kernels] ssd_scan_bwd {d['shape']} fp32: row errs "
        f"{ {k: f'{v:.3g}' for k, v in d['row_err'].items()} } (tol {d['row_tol']}); "
        f"{d['ms']:.4f} ms a call at {d['timed_shape']} (bf16, fp32 dt)")


# full widths of the configurations whose math the four ops kernels carry
# (src/repro/configs): starcoder2_3b's dense cache, recurrentgemma_2b's
# local attention (window 2048) and RG-LRU width, mamba2_780m's SSD heads
STARCODER_CACHE = (8, 1024, 24, 2, 128)                   # B, T, H, KV, Dh
STARCODER_LENS = [1, 17, 300, 511, 512, 700, 1000, 1024]
LONG_CONTEXT = 16384          # starcoder2-3b's context (arXiv:2402.19173)
GRIFFIN_LOCAL = (4, 2048, 10, 1, 256)
GRIFFIN_LRU = (1, 2048, 2560)                             # B, S, W
MAMBA = (1, 2048, 48, 64, 1, 128)                         # B, S, H, P, G, N
MAMBA_CHUNK = 256
# the MoE family's attention (H, KV, Dh): deepseek_moe_16b is MHA (G = 1),
# granite_moe_3b_a800m has 24 q heads on 8 KV heads (G = 3)
DEEPSEEK_ATTN = (16, 16, 128)
GRANITE_ATTN = (24, 8, 64)
# the enc-dec and VLM families' attention (H, KV, Dh): whisper_small is MHA
# at head_dim 64 (G = 1), its encoder over whisper's 30-second window of
# 1500 frames (arXiv:2212.04356); internvl2_2b's InternLM2 backbone has 16
# q heads on 8 KV heads at head_dim 128 (G = 2)
WHISPER_ATTN = (12, 12, 64)
WHISPER_FRAMES = 1500
INTERNVL_ATTN = (16, 8, 128)
# the dense configs of phases 4e and 5e (H, KV, Dh): qwen25_3b 16 q heads on
# 2 KV heads (G = 8, one 8-head tile a group), starcoder2_15b 48 on 4 (G =
# 12, three tiles of 4), granite_34b MQA 48 on 1 (G = 48: six tiles of 8 in
# flash, three m-tiles of 16 in decode, a grid of B × 1 × 3 blocks a split)
QWEN_ATTN = (16, 2, 128)
STARCODER15_ATTN = (48, 4, 128)
GRANITE34_ATTN = (48, 1, 128)
DENSE_ATTN = {"qwen25_3b": QWEN_ATTN, "starcoder2_15b": STARCODER15_ATTN,
              "granite_34b": GRANITE34_ATTN}
STREAM_N = 2 ** 27            # 512 MiB per fp32 array, > 4× the 50 MB L2


def _dense_lens():
    """Phase 5e's decode lengths, B=8: prompts of 16–512 tokens + up to 32
    new (their own draw, so that the other cases keep theirs)."""
    import numpy as np

    return np.random.default_rng(SEED + 13).integers(16, 512 + 33, size=8).tolist()


# Forced flash modes: (B, S, H, KV, Dh), causal, window, valid_len, and the
# mode (split, consumers) the plan is forced to
FLASH_MODE_CASES = [
    ((1, WHISPER_FRAMES) + WHISPER_ATTN, False, 0, 0, (False, 3)),
    ((1, WHISPER_FRAMES) + WHISPER_ATTN, False, 0, WHISPER_FRAMES, (False, 3)),
    ((1, WHISPER_FRAMES) + WHISPER_ATTN, False, 0, WHISPER_FRAMES, (True, 2)),
    ((1, WHISPER_FRAMES) + WHISPER_ATTN, False, 0, WHISPER_FRAMES, (False, 2)),
    ((1, 2048) + WHISPER_ATTN, False, 0, 0, (True, 2)),
    ((1, 2048) + WHISPER_ATTN, True, 0, 0, (False, 3)),
    ((1, 512, 24, 2, 128), True, 64, 300, (True, 2)),
    ((1, 512, 24, 2, 128), False, 0, 300, (False, 2)),
    ((2, 256, 4, 2, 64), True, 64, 150, (False, 3)),
    ((2, 200, 4, 2, 64), False, 0, 150, (True, 2)),
    ((2, 200, 4, 2, 64), False, 0, 150, (False, 3)),
    ((1, 300, 10, 1, 256), True, 65, 0, (False, 1)),
]


def _check_flash_modes(torch, gen, record):
    """The bf16 flash kernel with its plan forced to each mode of
    ``FLASH_MODE_CASES``, against its plain version (``record``: abs and
    row limits, the off-by-one bound), and three more calls bit-equal to
    the first (a race in the ring or the split merge would show as a
    difference); whatever the plan picks at these shapes is held by phase
    3's own flash cases."""
    from repro_torch.kernels import flash_attention as fa

    plan = fa.flash_plan
    try:
        for (B, S, H, KV, Dh), causal, window, vl, (split, n) in FLASH_MODE_CASES:
            forced = fa.flash_mode(B, S, H, KV, Dh, split, n)
            fa.flash_plan = lambda *_, f=forced: f
            q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, torch.bfloat16)
            masks = {"causal": causal, "window": window, "valid_len": vl}
            o = torch.ops.repro_torch.flash_attention(q, k, v, causal, window, vl)
            again = [torch.ops.repro_torch.flash_attention(q, k, v, causal, window, vl)
                     for _ in range(3)]
            torch.cuda.synchronize()
            check(all(torch.equal(o, x) for x in again),
                  f"flash {forced.mode} {[B, S, H, KV, Dh, causal, window, vl]}: "
                  f"repeated calls differ")
            f32 = [x.float() for x in (q, k, v)]
            moved = None
            if window or vl:
                key = "window" if window else "valid_len"
                moved = fa.flash_attention_plain(*f32, **{**masks, key: masks[key] - 1})
            record("flash_attention", [B, S, H, KV, Dh, int(causal), window, vl,
                                       forced.mode], torch.bfloat16,
                   o, fa.flash_attention_plain(q, k, v, **masks),
                   fa.flash_attention_plain(*f32, **masks), moved)
    finally:
        fa.flash_plan = plan


def _check_dense_configs_attention(torch, record):
    """Phase 3 at the dense configs' head layouts (``DENSE_ATTN``), from a
    generator of their own: flash at S = 512 for each, granite_34b's also
    at S = 1000 and with valid_len 700 (its off-by-one checked); paged
    decode at B=8, pages of 16, phase 5e's lengths; and at granite_34b's G
    = 48 lengths on an edge of ``decode_splits``'s ranges and ±1."""
    from repro_torch.kernels.decode_attention import (paged_decode_attention_plain,
                                                      split_ranges)
    from repro_torch.kernels.flash_attention import flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    flash_cases = [((1, 512) + attn, 0) for attn in DENSE_ATTN.values()]
    flash_cases += [((1, 1000) + GRANITE34_ATTN, 0), ((1, 1000) + GRANITE34_ATTN, 700)]
    page, maxp = 16, 64
    paged_cases = [(_dense_lens(), attn) for attn in DENSE_ATTN.values()]
    H, KV, _ = GRANITE34_ATTN
    edge = page * split_ranges(maxp, _splits(torch, 8, H, KV, maxp, page))[0][1]
    paged_cases.append(([edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge, 2 * edge + 1,
                         1024 - edge, 1024], GRANITE34_ATTN))
    for dtype in (torch.float32, torch.bfloat16):
        for (B, S, H, KV, Dh), vl in flash_cases:
            q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, dtype)
            o = torch.ops.repro_torch.flash_attention(q, k, v, True, 0, vl)
            torch.cuda.synchronize()
            f32 = [x.float() for x in (q, k, v)]
            record("flash_attention", [B, S, H, KV, Dh, 1, 0, vl], dtype, o,
                   flash_attention_plain(q, k, v, causal=True, valid_len=vl),
                   flash_attention_plain(*f32, causal=True, valid_len=vl),
                   flash_attention_plain(*f32, causal=True, valid_len=vl - 1) if vl else None)
        for lens, (H, KV, Dh) in paged_cases:
            q, kp, vp, pt, lengths = _paged_inputs(torch, gen, lens, H, KV, Dh, page,
                                                   maxp, dtype)
            o = torch.ops.repro_torch.paged_decode_attention(q, kp, vp, pt, lengths)
            torch.cuda.synchronize()
            f32 = [x.float() for x in (q, kp, vp)]
            splits = _splits(torch, len(lens), H, KV, maxp, page)
            record("paged_decode_attention", [len(lens), H, KV, Dh, page, maxp, lens,
                                              f"splits {splits}"], dtype,
                   o, paged_decode_attention_plain(q, kp, vp, pt, lengths),
                   paged_decode_attention_plain(*f32, pt, lengths),
                   paged_decode_attention_plain(*f32, pt, (lengths - 1).clamp_min(1)))


def _time_dense_configs_attention(torch, F, flush, timings):
    """The dense configs' rows of the kernel table, appended after the
    others (whose draws they leave alone): flash at S = 512 for each head
    layout and granite_34b's at S = 1000, beside SDPA; paged decode at
    phase 5e's lengths for each."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for S, attn in [(512, a) for a in DENSE_ATTN.values()] + [(1000, GRANITE34_ATTN)]:
        timings["flash_attention"].append(
            _flash_timing(torch, F, flush, gen, 1, S, *attn, True))
    for attn in DENSE_ATTN.values():
        timings["paged_decode_attention"].append(_paged_timing(
            torch, flush, gen, _dense_lens(), *attn, 16, 64))


def _decode_inputs(torch, gen, B, T, H, KV, Dh, dtype):
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return mk(B, H, Dh), mk(B, T, KV, Dh), mk(B, T, KV, Dh)


def _ssd_inputs(torch, gen, B, S, H, P, G, N, dtype, steep=False, dt_fp32=False):
    """test_kernels.py's draws; ``steep``: dt·A in [−65, −55] every step;
    ``dt_fp32``: dt stays fp32 whatever the dtype, as the Mamba-2 block
    feeds it (an fp32 softplus beside bf16 x, B and C)."""
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    x = mk(B, S, H, P) * 0.5
    dt = torch.nn.functional.softplus(mk(B, S, H))
    A = -torch.exp(mk(H) * 0.3)
    if steep:
        dt = 55.0 + 10.0 * torch.rand(B, S, H, generator=gen, device="cuda")
        A = -torch.ones(H, device="cuda")
    Bm, Cm = mk(B, S, G, N) * 0.3, mk(B, S, G, N) * 0.3
    return (x.to(dtype), dt if dt_fp32 else dt.to(dtype), A, Bm.to(dtype),
            Cm.to(dtype))


def _rglru_inputs(torch, gen, B, S, W, dtype, slow=False):
    """``slow``: a in (0.9, 1), so a carry lives on across chunk edges."""
    a = torch.sigmoid(torch.randn(B, S, W, generator=gen, device="cuda"))
    if slow:
        a = 0.9 + 0.1 * a
    b = torch.randn(B, S, W, generator=gen, device="cuda") * 0.1
    return a.to(dtype), b.to(dtype)


def _triad_inputs(torch, gen, N, dtype):
    return tuple(torch.randn(N, generator=gen, device="cuda").to(dtype)
                 for _ in range(2))


def _check_ops_kernels(torch, gen, rng, record):
    """Phase 3 for the kernels behind ops.decode_attention, ops.ssd_scan,
    ops.rglru_scan and ops.stream_triad: full widths, then the sweeps of
    tests/test_kernels.py."""
    from repro_torch.kernels.decode_attention import (DENSE_TILE, decode_attention_plain,
                                                      lengths_for, split_ranges)
    from repro_torch.kernels.rglru_scan import rglru_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.stream import stream_triad_plain

    decode_cases = [(STARCODER_CACHE, STARCODER_LENS), (STARCODER_CACHE, 1024),
                    (STARCODER_CACHE, 2000),  # clamped to T
                    (GRIFFIN_LOCAL, rng.integers(1, 2049, size=4).tolist()),
                    ((4, 1024, 24, 2, 128), [0, 5, 300, 1024]),  # a row of length 0
                    ((2, 512, 4, 2, 64), 300), ((1, 1024, 8, 8, 32), 1024),
                    ((3, 300, 4, 1, 64), 17), ((4, 256, 4, 2, 64), [1, 17, 100, 256])]
    # the split edges at starcoder2_3b's cache (decode_splits: 16 splits of
    # DENSE_TILE tokens on 132 SMs): on an edge and ±1, a lone long request,
    # requests all shorter than one split; and a 64-token cache, one split
    B, T, H, KV, Dh = STARCODER_CACHE
    edge = DENSE_TILE * split_ranges(T // DENSE_TILE,
                                     _splits(torch, B, H, KV, T // DENSE_TILE,
                                             DENSE_TILE))[0][1]
    decode_cases += [(STARCODER_CACHE, [edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge,
                                        2 * edge + 1, T - edge, T]),
                     (STARCODER_CACHE, [T] + [0] * 7),
                     (STARCODER_CACHE, [1, 2, 3, 5, 8, 13, edge - 2, edge - 1]),
                     ((4, 64, 24, 2, 128), [0, 1, 63, 64]),
                     ((3, 300, 40, 2, 64), [0, 129, 300])]  # two m-tiles
    # splits that walk many chunks (the prefetch runs, the buffer ring
    # wraps): a batch of 32 at starcoder2_3b's cache (4 splits of 256
    # tokens on 132 SMs), the long context (16 splits of 1,024 tokens), and
    # 40 requests at recurrentgemma_2b's local attention (6 splits of 384
    # tokens, 12 chunks of 32 in fp32, the last split 128 tokens)
    decode_cases += [((32, T, H, KV, Dh),
                      [0, 1, 63, 64, 65, 255, 256, 257, 511, 512, 513, 767, 768, 769,
                       1023, 1024] + rng.integers(0, T + 1, size=16).tolist()),
                     ((B, LONG_CONTEXT, H, KV, Dh),
                      [LONG_CONTEXT, LONG_CONTEXT - 1, 1025, 1024, 9000, 0, 12345, 16000]),
                     ((40,) + GRIFFIN_LOCAL[1:],
                      [2048, 2047, 1920, 1919, 384, 385] + rng.integers(
                          0, 2049, size=34).tolist())]
    # whisper_small's decode: the cross-attention over the encoder's 1500
    # frames, every row at full length (an int and a per-row tensor, as the
    # layer passes it), and the self-attention's 512-slot cache at phase
    # 5d's lengths (prompts of 4–64 tokens + up to 128 new)
    whisper_cross = (8, WHISPER_FRAMES) + WHISPER_ATTN
    decode_cases += [(whisper_cross, WHISPER_FRAMES), (whisper_cross, [WHISPER_FRAMES] * 8),
                     ((8, 512) + WHISPER_ATTN, _whisper_self_lens())]
    ssd_cases = [(MAMBA, MAMBA_CHUNK, False), ((1, 2000, 48, 64, 1, 128), 256, False),
                 ((1, 512, 48, 64, 1, 128), 256, True),
                 ((1, 128, 2, 16, 1, 16), 32, False), ((2, 96, 4, 16, 2, 32), 32, False),
                 ((1, 100, 2, 8, 2, 16), 64, False)]
    # across the chunk edges of the chunk-parallel kernel: S = 256·k ± 1,
    # 32 chunks through the state pass, a steep decay over 8 chunks, B=2
    # with G=2 at mamba2_780m's widths, and chunks of 40 (off the 16-row
    # tile; 26 of them, the last 10 steps)
    ssd_cases += [((1, 1023, 48, 64, 1, 128), 256, False),
                  ((1, 1025, 48, 64, 1, 128), 256, False),
                  ((1, 8192, 48, 64, 1, 128), 256, False),
                  (MAMBA, MAMBA_CHUNK, True),
                  ((2, 1024, 48, 64, 2, 128), 256, False),
                  ((1, 1010, 48, 64, 1, 128), 40, False)]
    rglru_cases = [(GRIFFIN_LRU, False), ((2, 130, 100), False), ((1, 256, 128), False),
                   ((1, 64, 256), False)]
    # across the 64-step chunks of the split scan: S = 64·k ± 1, S below
    # one chunk, a ragged W, B=4, 256 chunks through the carry pass, and a
    # slow decay, whose carries live on across chunk edges
    rglru_cases += [((1, 2047, 2560), False), ((1, 2049, 2560), False),
                    ((1, 40, 2560), False), ((1, 2048, 2561), False),
                    ((4, 2048, 2560), False), ((1, 16384, 2560), False),
                    (GRIFFIN_LRU, True)]
    triad_cases = [STREAM_N, 70000, 65536, 1000]
    for dtype in (torch.float32, torch.bfloat16):
        for (B, T, H, KV, Dh), length in decode_cases:
            q, k, v = _decode_inputs(torch, gen, B, T, H, KV, Dh, dtype)
            if isinstance(length, list):
                length = torch.tensor(length, dtype=torch.int32, device="cuda")
            o = torch.ops.repro_torch.decode_attention(q, k, v,
                                                       lengths_for(length, B, T, q.device))
            torch.cuda.synchronize()
            f32 = [x.float() for x in (q, k, v)]
            shorter = (lengths_for(length, B, T, q.device) - 1).clamp_min(0)
            splits = _splits(torch, B, H, KV, -(-T // DENSE_TILE), DENSE_TILE)
            record("decode_attention", [B, T, H, KV, Dh, length if isinstance(length, int)
                                        else length.tolist(), f"splits {splits}"], dtype,
                   o, decode_attention_plain(q, k, v, length),
                   decode_attention_plain(*f32, length),
                   decode_attention_plain(*f32, shorter))
        for (B, S, H, P, G, N), chunk, steep in ssd_cases:
            args = _ssd_inputs(torch, gen, B, S, H, P, G, N, dtype, steep)
            y, _ = torch.ops.repro_torch.ssd_scan(*args, chunk, False)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all().item()), f"ssd_scan {B, S, H}: not finite")
            f32 = [x.float() for x in args]
            record("ssd_scan", [B, S, H, P, G, N, chunk] + (["steep"] if steep else []),
                   dtype, y, ssd_scan_plain(*args, chunk=chunk),
                   ssd_scan_plain(*f32, chunk=chunk), None)
        for (B, S, W), slow in rglru_cases:
            a, b = _rglru_inputs(torch, gen, B, S, W, dtype, slow)
            h = torch.ops.repro_torch.rglru_scan(a, b)
            torch.cuda.synchronize()
            record("rglru_scan", [B, S, W] + (["slow"] if slow else []), dtype, h,
                   rglru_scan_plain(a, b), rglru_scan_plain(a.float(), b.float()), None)
        for N in triad_cases:
            a, b = _triad_inputs(torch, gen, N, dtype)
            o = torch.ops.repro_torch.stream_triad(a, b, 3.0)
            torch.cuda.synchronize()
            record("stream_triad", [N], dtype, o, stream_triad_plain(a, b, 3.0),
                   stream_triad_plain(a.float(), b.float(), 3.0), None)
            del a, b, o
    _check_ssd_model_form(torch, gen, record, ssd_scan_plain)


def _check_ssd_model_form(torch, gen, record, ssd_scan_plain):
    """The SSD as the Mamba-2 block calls it, at mamba2_780m's widths: bf16
    x, B and C with an fp32 dt, and the fp32 final state (B, H, P, N).  y
    at S = 2048 and a ragged 2000; the final state there and at S on a
    chunk edge ± 1 (1023, 1024, 1025) and within one chunk (100), each
    against the plain version's, with the state after S − 1 steps as the
    off-by-one that must break the row limit."""
    B, _, H, P, G, N = MAMBA
    for S in (2048, 2000, 1023, 1024, 1025, 100):
        args = _ssd_inputs(torch, gen, B, S, H, P, G, N, torch.bfloat16, dt_fp32=True)
        y, final = torch.ops.repro_torch.ssd_scan(*args, MAMBA_CHUNK, True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all().item() and torch.isfinite(final).all().item()),
              f"ssd_scan fp32 dt S={S}: not finite")
        check(final.dtype == torch.float32 and tuple(final.shape) == (B, H, P, N),
              f"ssd_scan final state {final.dtype} {tuple(final.shape)}")
        f32 = [t.float() for t in args]
        ey, efin = ssd_scan_plain(*args, chunk=MAMBA_CHUNK, return_final_state=True)
        ey32, efin32 = ssd_scan_plain(*f32, chunk=MAMBA_CHUNK, return_final_state=True)
        shape = [B, S, H, P, G, N, MAMBA_CHUNK, "dt float32"]
        if S in (2048, 2000):
            record("ssd_scan", shape, torch.bfloat16, y, ey, ey32, None)
        _, shorter = ssd_scan_plain(*[t[:, : S - 1] for t in f32[:2]], f32[2],
                                    *[t[:, : S - 1] for t in f32[3:]],
                                    chunk=MAMBA_CHUNK, return_final_state=True)
        record("ssd_scan", shape + ["final state"], torch.bfloat16, final, efin, efin32,
               shorter)


def _timing(torch, flush, shape, kernel, plain, library, nbytes, flops):
    """One timing row: the kernel, its plain version and the library call
    (None where there is none) on the same inputs, and the bound
    (``flops``: {dtype: count}, each at its dtype's peak); ``max_abs_err``
    is the kernel's against the plain version, over every output."""
    bound_ms, bound_by = _bound(nbytes, flops)
    outs, wants = kernel(), plain()  # a tensor each, or tuples of them
    pairs = zip(outs, wants) if isinstance(outs, tuple) else ((outs, wants),)
    err = max((o.float() - w.float()).abs().max().item() for o, w in pairs)
    return {"shape": shape, "max_abs_err": err,
            "ms": _time_ms(torch, kernel, flush),
            "plain_ms": _time_ms(torch, plain, flush),
            "library_ms": None if library is None else _time_ms(torch, library, flush),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}


def _flash_timing(torch, F, flush, gen, B, S, H, KV, Dh, causal):
    """The flash kernel's timing row, bf16, beside SDPA (GQA)."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain, flash_plan)

    q, k, v = _flash_inputs(torch, gen, B, S, H, KV, Dh, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = S * (S + 1) / 2 if causal else S * S
    plan = flash_plan(B, S, H, KV, Dh, causal, 0, torch.cuda.current_device())
    row = _timing(
        torch, flush, {"B": B, "S": S, "H": H, "KV": KV, "Dh": Dh,
                       "dtype": "bfloat16", "causal": causal, "mode": plan.mode,
                       "plan": plan._asdict()},
        lambda: flash_attention_fwd(q, k, v, causal=causal),
        lambda: flash_attention_plain(q, k, v, causal=causal),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True),
        2 * (2 * B * S * H * Dh + 2 * B * S * KV * Dh),  # q, o, k, v
        {"bfloat16": 4 * Dh * H * B * pairs})  # the unmasked pairs
    row["shape"]["over_library"] = row["ms"] / row["library_ms"]
    return row


def _paged_timing(torch, flush, gen, lens, H, KV, Dh, page, maxp):
    """The paged kernel's timing row, bf16; no single PyTorch call does
    paged attention, so it has no library time."""
    from repro_torch.kernels.decode_attention import (paged_decode_attention_fwd,
                                                      paged_decode_attention_plain)

    args = _paged_inputs(torch, gen, lens, H, KV, Dh, page, maxp, torch.bfloat16)
    B, tokens = len(lens), sum(lens)
    npages = sum(-(-n // page) for n in lens)
    row = _timing(
        torch, flush, {"B": B, "H": H, "KV": KV, "Dh": Dh, "page": page, "maxp": maxp,
                       "lengths": lens if len(set(lens)) > 1 else f"{B} × {lens[0]}",
                       "dtype": "bfloat16",
                       "splits": _splits(torch, B, H, KV, maxp, page)},
        lambda: paged_decode_attention_fwd(*args),
        lambda: paged_decode_attention_plain(*args), None,
        (2 * 2 * B * H * Dh            # q and o
         + 2 * 2 * tokens * KV * Dh    # live K and V
         + 4 * npages + 4 * B),        # page-table entries walked, lengths
        {"bfloat16": 4 * Dh * H * tokens})
    del args
    return row


def _dense_timing(torch, F, flush, gen, lengths, T, H, KV, Dh):
    """The dense kernel's timing row, bf16, beside masked SDPA."""
    from repro_torch.kernels.decode_attention import (DENSE_TILE, decode_attention_fwd,
                                                      decode_attention_plain)

    B = len(lengths)
    q, k, v = _decode_inputs(torch, gen, B, T, H, KV, Dh, torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qs = q[:, :, None]                                        # (B, H, 1, Dh)
    ks, vs = (x.transpose(1, 2).contiguous() for x in (k, v))  # (B, KV, T, Dh)
    mask = (torch.arange(T, device="cuda")[None, :]
            < lens.long()[:, None])[:, None, None, :]
    tokens = sum(lengths)
    row = _timing(
        torch, flush, {"B": B, "T": T, "H": H, "KV": KV, "Dh": Dh,
                       "lengths": lengths if len(set(lengths)) > 1 else f"{B} × {T}",
                       "dtype": "bfloat16",
                       "splits": _splits(torch, B, H, KV, -(-T // DENSE_TILE), DENSE_TILE)},
        lambda: decode_attention_fwd(q, k, v, lens),
        lambda: decode_attention_plain(q, k, v, lens),
        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                               enable_gqa=True),
        2 * 2 * B * H * Dh + 2 * 2 * tokens * KV * Dh + 4 * B,  # q, o, live K/V
        {"bfloat16": 4 * Dh * H * tokens})
    del q, k, v, ks, vs
    return row


def _whisper_self_lens():
    """Phase 5d's self-attention lengths at whisper_small, B=8: prompts of
    4–64 tokens + up to 128 new (their own draw)."""
    import numpy as np

    return np.random.default_rng(SEED + 10).integers(4, 64 + 129, size=8).tolist()


def _time_ops_kernels(torch, F, gen, flush):
    """The four ops kernels at the full widths of phase 7, bf16; the triad
    in fp32, as STREAM counts it, and in bf16."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd, rglru_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain
    from repro_torch.kernels.stream import stream_triad_fwd, stream_triad_plain

    bf16 = torch.bfloat16
    out = {}
    B, T, H, KV, Dh = STARCODER_CACHE
    # starcoder2_3b's cache, then every request at its 16,384-token context
    # then recurrentgemma_2b's ring at its window, 8 requests of a served batch
    Bg, Tg, Hg, KVg, Dhg = GRIFFIN_LOCAL
    # then whisper_small's decode: the cross-attention (every row at 1500)
    # and the self-attention's cache at phase 5d's lengths
    out["decode_attention"] = [
        _dense_timing(torch, F, flush, gen, STARCODER_LENS, T, H, KV, Dh),
        _dense_timing(torch, F, flush, gen, [LONG_CONTEXT] * B, LONG_CONTEXT, H, KV, Dh),
        _dense_timing(torch, F, flush, gen, [Tg] * 8, Tg, Hg, KVg, Dhg),
        _dense_timing(torch, F, flush, gen, [WHISPER_FRAMES] * 8, WHISPER_FRAMES,
                      *WHISPER_ATTN),
        _dense_timing(torch, F, flush, gen, _whisper_self_lens(), 512, *WHISPER_ATTN)]
    # the SSD in bf16 throughout (row 0, the form timed before the models
    # called it), then as the Mamba-2 block calls it: fp32 dt and the final
    # state (row 1)
    B, S, H, P, G, N = MAMBA
    out["ssd_scan"] = []
    for model_form in (False, True):
        args = _ssd_inputs(torch, gen, B, S, H, P, G, N, bf16, dt_fp32=model_form)
        flops, ways = ops.ssd_flops(B, S, H, P, N, MAMBA_CHUNK, "bfloat16", final=model_form)
        nbytes = (2 * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * H
                  + B * S * H * (4 if model_form else 2)         # dt
                  + (4 * B * H * P * N if model_form else 0))    # the final state
        kw = {"chunk": MAMBA_CHUNK, "return_final_state": model_form}
        out["ssd_scan"].append(_timing(
            torch, flush, {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N,
                           "chunk": MAMBA_CHUNK, "dtype": "bfloat16",
                           "dt": "float32" if model_form else "bfloat16",
                           "final_state": model_form},
            lambda: ssd_scan_fwd(*args, **kw), lambda: ssd_scan_plain(*args, **kw), None,
            nbytes, flops))
        out["ssd_scan"][-1]["ops_ms_by_way"] = {k: _ops_ms(f) for k, f in ways.items()}
        del args
    # the RG-LRU in bf16 (row 0, the form timed before the models called
    # it), then in fp32 as recurrentgemma_2b's blocks call it (row 1)
    B, S, W = GRIFFIN_LRU
    out["rglru_scan"] = []
    for dtype in (bf16, torch.float32):
        a, b = _rglru_inputs(torch, gen, B, S, W, dtype)
        out["rglru_scan"].append(_timing(
            torch, flush, {"B": B, "S": S, "W": W, "dtype": str(dtype)[6:]},
            lambda: rglru_scan_fwd(a, b), lambda: rglru_scan_plain(a, b), None,
            3 * a.element_size() * B * S * W, {"float32": 2 * B * S * W}))
        del a, b
    out["stream_triad"] = []
    for dtype in (torch.float32, bf16):
        ta, tb = _triad_inputs(torch, gen, STREAM_N, dtype)
        # torch.add(alpha=) rounds once (an FMA), a + α·b twice: the same
        # function only in fp32, so the yardstick is timed there alone
        out["stream_triad"].append(_timing(
            torch, flush, {"N": STREAM_N, "dtype": str(dtype)[6:], "alpha": 3.0},
            lambda: stream_triad_fwd(ta, tb, 3.0),
            lambda: stream_triad_plain(ta, tb, 3.0),
            (lambda: torch.add(ta, tb, alpha=3.0)) if dtype == torch.float32 else None,
            3 * ta.element_size() * STREAM_N, {"float32": 2 * STREAM_N}))
        del ta, tb
    return out


# ------------------------------------------------------------------ phase 4
def _path(torch, cfg, params, device, prompts, steps, forced=None, extra=None):
    """Prefill the prompts (right-padded, valid_len; ``extra``: the vlm
    family's patches), admit them into a paged cache as the engine does,
    then ``steps`` paged decode steps.  Feeds ``forced`` tokens when given
    (so both sides see the same inputs); returns the logits per step and
    the greedy tokens."""
    from repro_torch.models.model import Model
    from repro_torch.serve.kv_cache import PagedKVCache

    model = Model(cfg, device=device)
    cp = model.compute_params({k: v.to(device) for k, v in params.items()})
    S = max(len(p) for p in prompts)
    B, page = len(prompts), 16
    maxp = max(8, -(-(S + steps + 1) // page))
    extra = {k: v.to(device) for k, v in (extra or {}).items()}
    toks = torch.zeros(B, S, dtype=torch.long)
    for b, p in enumerate(prompts):
        toks[b, : len(p)] = torch.tensor(p)
    kv = PagedKVCache(model, num_pages=B * maxp + 1, page_size=page, max_batch=B,
                      max_pages_per_req=maxp, name=f"parity-{device}")
    logits_out, greedy = [], []
    with torch.inference_mode():
        lg, c = model.prefill(cp, {"tokens": toks.to(device), **extra}, cache_len=S,
                              valid_len=torch.tensor([len(p) for p in prompts],
                                                     dtype=torch.int32, device=device))
        for b, p in enumerate(prompts):
            check(kv.admit(b, {n: c[n][:, b:b + 1] for n in kv.pools}, len(p)),
                  "parity: admit failed")
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
        check(counts == {**dict.fromkeys(ops.KERNELS, 0), "flash_attention": 2,
                         "paged_decode_attention": 2 * steps},
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


# ----------------------------------------------------------------- phase 4b
# (arch, layers kept, batch, prompt length): mamba2_780m's prompt spans two
# SSD chunks, the second ragged; recurrentgemma_2b's ends 2 short of its
# 2048-slot ring, so the third decode step wraps it
PARITY_FAMILIES = (("mamba2_780m", 2, 2, 300), ("recurrentgemma_2b", 5, 1, 2046))


def _dense_slot_path(torch, cfg, params, device, tokens, steps, forced=None,
                     extra=None, cache_len=None):
    """Prefill ``tokens`` at their exact length (``extra``: the encdec
    family's frames; ``cache_len``: its self-attention cache), then
    ``steps`` decode steps against the family's own cache (the engine's
    dense slots), feeding ``forced`` tokens when given; returns the logits
    per step and the greedy tokens."""
    from repro_torch.models.model import Model

    model = Model(cfg, device=device)
    cp = model.compute_params({k: v.to(device) for k, v in params.items()})
    extra = {k: v.to(device) for k, v in (extra or {}).items()}
    logits_out, greedy = [], []
    with torch.inference_mode():
        lg, cache = model.prefill(cp, {"tokens": tokens.to(device), **extra},
                                  cache_len=cache_len)
        for step in range(steps + 1):
            if step:
                lg, cache = model.decode(cp, cache, tok[:, None])
            lg = lg[:, : cfg.vocab_size].float().cpu()
            logits_out.append(lg)
            greedy.append(lg.argmax(-1))
            tok = (forced[step] if forced is not None else greedy[-1]).to(device)
    return logits_out, greedy


def phase_parity_families(torch, np):
    """Phase 4's check for the ssm and hybrid families: the same params on
    the card and on the CPU, fp32 with TF32 off (matmul and cuDNN's conv),
    full width, cut in depth (mamba2_780m: 2 layers; recurrentgemma_2b: one
    (rec, rec, attn) group and the 2-layer tail).  Prefill + 4 decode
    steps: logits within phase 4's fp32 limit (the same fp32 math in other
    summation orders) and equal greedy tokens; exact launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps, out = 4, {}
    for arch, layers, B, S in PARITY_FAMILIES:
        t0 = time.perf_counter()
        cfg = replace(get_config(arch), num_layers=layers, dtype="float32")
        params = Model(cfg, device="cpu").init(SEED)
        rng = np.random.default_rng(SEED + 5)
        tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, S)))
        ref_logits, ref_tok = _dense_slot_path(torch, cfg, params, "cpu", tokens, steps)
        ops.reset_launch_counts()
        gpu_logits, gpu_tok = _dense_slot_path(torch, cfg, params, "cuda", tokens, steps,
                                               forced=ref_tok)
        launches = ops.launch_counts()
        if cfg.family == "ssm":
            want = {"ssd_scan": layers}
        else:
            groups = layers // len(cfg.block_pattern)
            want = {"rglru_scan": layers - groups, "flash_attention": groups,
                    "decode_attention": groups * steps}
        _check_launches(f"parity {arch}", launches, want)
        errs = [(a - b).abs().max().item() for a, b in zip(gpu_logits, ref_logits)]
        scale = max(b.abs().max().item() for b in ref_logits)
        same = [bool(torch.equal(a, b)) for a, b in zip(gpu_tok, ref_tok)]
        out[arch] = {"layers": layers, "batch": B, "prompt": S, "max_abs_err": max(errs),
                     "per_step": errs, "tol": PARITY_ATOL["float32"],
                     "max_abs_logit": scale, "greedy_equal": same, "launches": launches,
                     "seconds": time.perf_counter() - t0}
        log(f"[parity] {arch} ({layers} layers, B={B}, S={S}) float32: logits max abs err "
            f"{max(errs):.3g} (tol {PARITY_ATOL['float32']}, |logit| ≤ {scale:.3g}), "
            f"greedy equal {same}; launches {launches}")
        check(max(errs) <= PARITY_ATOL["float32"], f"parity {arch}: logits differ")
        check(all(same), f"parity {arch}: greedy tokens differ")
        del params
    REPORT["parity_families"] = out


# ----------------------------------------------------------------- phase 4c
# the MoE family at full width and 2 layers: deepseek_moe_16b its leading
# dense layer and one MoE layer (64 experts, top-6, 2 shared),
# granite_moe_3b_a800m two MoE layers (40 experts, top-8, tied embeddings)
PARITY_MOE = ("deepseek_moe_16b", "granite_moe_3b_a800m")


def phase_parity_moe(torch, np):
    """Phase 4's check for the MoE family, fp32 with TF32 off: the same
    params on the card and on the CPU, two prompts right-padded to one
    prefill (the pad tokens route and take capacity on both sides), then
    4 paged decode steps: logits within phase 4's fp32 limit and equal
    greedy tokens; exact launches.  Routing is a top-k of fp32
    probabilities that the two sides compute in other summation orders
    (~1e-6 apart), so only a near-tie could flip an expert."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    steps, out = 4, {}
    for arch in PARITY_MOE:
        t0 = time.perf_counter()
        cfg = replace(get_config(arch), num_layers=2, dtype="float32")
        params = Model(cfg, device="cpu").init(SEED)
        rng = np.random.default_rng(SEED + 6)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (37, 20)]
        ref_logits, ref_tok = _path(torch, cfg, params, "cpu", prompts, steps)
        ops.reset_launch_counts()
        gpu_logits, gpu_tok = _path(torch, cfg, params, "cuda", prompts, steps,
                                    forced=ref_tok)
        launches = ops.launch_counts()
        _check_launches(f"parity {arch}", launches,
                        {"flash_attention": 2, "paged_decode_attention": 2 * steps})
        errs = [(a - b).abs().max().item() for a, b in zip(gpu_logits, ref_logits)]
        scale = max(b.abs().max().item() for b in ref_logits)
        same = [bool(torch.equal(a, b)) for a, b in zip(gpu_tok, ref_tok)]
        out[arch] = {"layers": 2, "first_dense": cfg.first_dense, "max_abs_err": max(errs),
                     "per_step": errs, "tol": PARITY_ATOL["float32"],
                     "max_abs_logit": scale, "greedy_equal": same, "launches": launches,
                     "seconds": time.perf_counter() - t0}
        log(f"[parity] {arch} (2 layers, first_dense {cfg.first_dense}) float32: logits "
            f"max abs err {max(errs):.3g} (tol {PARITY_ATOL['float32']}, |logit| ≤ "
            f"{scale:.3g}), greedy equal {same}; launches {launches}")
        check(max(errs) <= PARITY_ATOL["float32"], f"parity {arch}: logits differ")
        check(all(same), f"parity {arch}: greedy tokens differ")
        del params
    REPORT["parity_moe"] = out


# ----------------------------------------------------------------- phase 4d
# whisper_small at full width with 2 encoder and 2 decoder layers, its
# encoder over 300 frames; internvl2_2b at full width and 2 layers, each
# prompt 256 image positions longer than phase 4's
PARITY_ENCDEC = (2, 300)                                   # layers a stack, frames


def _parity_report(torch, tag, gpu, ref, launches, **info):
    """Phase 4's verdict on one path: the card's logits within the fp32
    limit of the CPU's at every step, and equal greedy tokens."""
    (gpu_logits, gpu_tok), (ref_logits, ref_tok) = gpu, ref
    errs = [(a - b).abs().max().item() for a, b in zip(gpu_logits, ref_logits)]
    scale = max(b.abs().max().item() for b in ref_logits)
    same = [bool(torch.equal(a, b)) for a, b in zip(gpu_tok, ref_tok)]
    log(f"[parity] {tag} float32: logits max abs err {max(errs):.3g} (tol "
        f"{PARITY_ATOL['float32']}, |logit| ≤ {scale:.3g}), greedy equal {same}; "
        f"launches {launches}")
    check(max(errs) <= PARITY_ATOL["float32"], f"parity {tag}: logits differ")
    check(all(same), f"parity {tag}: greedy tokens differ")
    return {**info, "max_abs_err": max(errs), "per_step": errs,
            "tol": PARITY_ATOL["float32"], "max_abs_logit": scale, "greedy_equal": same,
            "launches": launches}


def phase_parity_encdec_vlm(torch, np):
    """Phase 4's check for the enc-dec and VLM families, fp32 with TF32 off:
    the same params on the card and on the CPU.  whisper_small (2 + 2
    layers): the encoder over 300 frames, a 24-token prefill of two
    prompts, then 4 decode steps on the dense slots: 4 flash launches (2
    non-causal) and 4 dense decodes a step (2 self, 2 cross).
    internvl2_2b (2 layers): patches and two prompts (256 + 37 and 256 +
    20 tokens) right-padded into one paged prefill, then 4 paged decode
    steps: 2 flash launches and 2 paged decodes a step.  Logits within
    phase 4's fp32 limit, equal greedy tokens, exact launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps, out = 4, {}
    layers, frames = PARITY_ENCDEC
    t0 = time.perf_counter()
    cfg = replace(get_config("whisper_small"), enc_layers=layers, dec_layers=layers,
                  num_layers=2 * layers, dtype="float32")
    params = Model(cfg, device="cpu").init(SEED)
    rng = np.random.default_rng(SEED + 11)
    B, S = 2, 24
    kw = {"extra": {"enc": torch.from_numpy(
              rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32))},
          "cache_len": S + steps + 4}
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, S)))
    ref = _dense_slot_path(torch, cfg, params, "cpu", tokens, steps, **kw)
    ops.reset_launch_counts()
    gpu = _dense_slot_path(torch, cfg, params, "cuda", tokens, steps, forced=ref[1], **kw)
    launches = ops.launch_counts()
    _check_launches("parity whisper_small", launches,
                    {"flash_attention": 2 * layers, "decode_attention": 2 * layers * steps})
    out["whisper_small"] = _parity_report(
        torch, f"whisper_small ({layers} + {layers} layers, {frames} frames, B={B}, S={S})",
        gpu, ref, launches, layers=[layers, layers], frames=frames, batch=B, prompt=S,
        seconds=time.perf_counter() - t0)
    del params
    t0 = time.perf_counter()
    cfg = replace(get_config("internvl2_2b"), num_layers=2, dtype="float32")
    params = Model(cfg, device="cpu").init(SEED)
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(1, cfg.vocab_size, size=cfg.n_patches + n).tolist()
               for n in (37, 20)]
    extra = {"patches": torch.from_numpy(rng.standard_normal(
        (2, cfg.n_patches, cfg.d_model)).astype(np.float32))}
    ref = _path(torch, cfg, params, "cpu", prompts, steps, extra=extra)
    ops.reset_launch_counts()
    gpu = _path(torch, cfg, params, "cuda", prompts, steps, forced=ref[1], extra=extra)
    launches = ops.launch_counts()
    _check_launches("parity internvl2_2b", launches,
                    {"flash_attention": 2, "paged_decode_attention": 2 * steps})
    out["internvl2_2b"] = _parity_report(
        torch, f"internvl2_2b (2 layers, prompts {[len(p) for p in prompts]})", gpu, ref,
        launches, layers=2, prompts=[len(p) for p in prompts],
        seconds=time.perf_counter() - t0)
    del params
    REPORT["parity_encdec_vlm"] = out


# ----------------------------------------------------------------- phase 4e
def phase_parity_dense(torch, np):
    """Phase 4's check for the dense configs no other phase runs, fp32 with
    TF32 off: qwen25_3b, starcoder2_15b and granite_34b at full width and
    2 layers, the same params on the card and on the CPU (drawn on the
    card, where granite_34b's 6.7 GB of fp32 draws take no host time, and
    copied to the host), two prompts right-padded into one prefill, then 4
    paged decode steps: logits within phase 4's fp32 limit, equal greedy
    tokens, exactly 2 flash launches and 2 paged decodes a step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps, out = 4, {}
    for arch in DENSE_ATTN:
        t0 = time.perf_counter()
        cfg = replace(get_config(arch), num_layers=2, dtype="float32")
        params = {k: v.cpu() for k, v in Model(cfg).init(SEED).items()}
        torch.cuda.empty_cache()
        rng = np.random.default_rng(SEED + 15)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (37, 20)]
        ref = _path(torch, cfg, params, "cpu", prompts, steps)
        ops.reset_launch_counts()
        gpu = _path(torch, cfg, params, "cuda", prompts, steps, forced=ref[1])
        launches = ops.launch_counts()
        _check_launches(f"parity {arch}", launches,
                        {"flash_attention": 2, "paged_decode_attention": 2 * steps})
        out[arch] = _parity_report(
            torch, f"{arch} (2 layers, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_model "
                   f"{cfg.d_model}, vocab {cfg.vocab_size})", gpu, ref, launches,
            layers=2, heads=[cfg.num_heads, cfg.num_kv_heads], prompts=[37, 20],
            seconds=time.perf_counter() - t0)
        del params, ref, gpu
        gc.collect()
    REPORT["parity_dense"] = out


# ------------------------------------------------------------------ phase 5
def _drive(torch, router, eng, reqs, max_new, card, vocab, slos=None):
    """Run ``reqs`` [(prompt, sampling)] through the router, each streamed
    (with its SLO tier from ``slos`` when given), with the launch counts
    set to 0 just before and read just after; check each request's length,
    vocab range and stream; report tokens/s, TTFT p50, decode-step p50 and
    peak device memory.  The run's trace stays in the rings."""
    from repro_torch.kernels import ops
    from repro_torch.obs import trace

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.enable()
    trace.clear()
    base_prefills, base_steps = eng.prefill_count, eng.step_count
    ops.reset_launch_counts()  # ← the path's run starts here
    t_run = time.perf_counter()
    slos = slos or [None] * len(reqs)
    streams = [router.submit_stream(p, sampling=sp, slo=s)
               for (p, sp), s in zip(reqs, slos)]
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
        check(all(0 <= t < vocab for t in res),
              f"serve: request {i} has a token outside the vocab")
        check(streamed == res, f"serve: request {i} streamed {streamed} != {res}")
    check(prefills == len(reqs), f"serve: {prefills} prefills for {len(reqs)} requests")
    evs = trace.events()
    begins = {e[6]["req"]: e[3] for e in evs if e[0] == "b" and e[1] == "request"}
    first = _first_token_at((e[1], e[3], e[6]) for e in evs if e[0] == "X")
    ttft = [first[a] - begins[a] for a in begins if a in first]
    step_s = [e[4] for e in evs if e[0] == "X" and e[1] == "decode_step"]
    prefill_s = [e[4] for e in evs if e[0] == "X" and e[1] == "prefill"]
    check(len(ttft) == len(reqs), f"serve: {len(ttft)} TTFTs for {len(reqs)} requests")
    check(eng.decode_compile_count() == 1,
          f"serve: {eng.decode_compile_count()} decode-step signatures, not 1")
    total = sum(len(r) for r in results)
    return {
        "card": card, "requests": len(reqs), "generated_tokens": total,
        "wall_s": wall, "tokens_per_s": total / wall,
        "ttft_p50_s": statistics.median(ttft),
        "decode_step_p50_s": statistics.median(step_s),
        "prefill_p50_s": statistics.median(prefill_s),
        "decode_steps": steps, "prefills": prefills, "launches": launches,
        "max_memory_allocated_bytes": peak,
        "prompt_lengths": [len(p) for p, _ in reqs],
        "decode_signatures": eng.decode_compile_count(),
    }


def _first_token_at(spans):
    """Request tag → when its first token was handed over, from
    time-ordered (name, start, args) of complete spans: the engine admits
    a request and emits its prefill's token just before the first
    ``decode_step`` that holds it starts."""
    first = {}
    for name, start, args in spans:
        if name == "decode_step":
            for tag in args["reqs"]:
                first.setdefault(tag, start)
    return first


def _log_serve(tag, serve):
    log(f"[{tag}] {serve['card']}: {serve['requests']} requests, "
        f"{serve['generated_tokens']} tokens in {serve['wall_s']:.2f} s = "
        f"{serve['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{serve['ttft_p50_s'] * 1e3:.1f} ms; decode step p50 "
        f"{serve['decode_step_p50_s'] * 1e3:.2f} ms; max_memory_allocated "
        f"{serve['max_memory_allocated_bytes'] / 2**30:.2f} GiB")


def _check_launches(tag, launches, want):
    """Exact launch counts: ``want`` for the kernels it names, 0 for the rest."""
    from repro_torch.kernels import ops

    full = {**dict.fromkeys(ops.KERNELS, 0), **want}
    check(launches == full, f"{tag}: launches {launches} != {full}")


def _slow_shares(intervals, t_end):
    """Each SLOW class's share of the intervals' time up to ``t_end``."""
    from repro_torch.obs.critical_path import CLASS_NAMES

    by = dict.fromkeys(CLASS_NAMES.values(), 0.0)
    for iv in intervals:
        if iv.t0 < t_end:
            by[CLASS_NAMES[iv.cls]] += min(iv.t1, t_end) - iv.t0
    total = sum(by.values())
    return {k: v / total for k, v in by.items()}


def _serve_slow(eng, n_reqs):
    """The SLOW breakdown of phase 5's traced run and one ``/metrics``
    scrape, with the engine still alive.  Each of the ``n_reqs`` measured
    requests must have a critical path that tiles it with no gap and
    clamps under 1 % of its wall time; the SLOW report must hold both
    tiers; the scrape, parsed strictly, must read the engine's own
    counters.  Reports the p50 over requests of each class's share of the
    request's wall time and of its TTFT window (its intervals cut where
    its first token was handed over: the start of its first
    ``decode_step``)."""
    from repro_torch.net.httpd import http_get
    from repro_torch.obs import attribution, export
    from repro_torch.obs import critical_path as cpm
    from repro_torch.obs.metrics import MetricsExporter, parse_prometheus_text

    t0 = time.perf_counter()
    tr = export.merged_trace()
    check(not tr.get("lossy"), f"serve slow: the trace's rings wrapped: {tr.get('ring_drops')}")
    idx = cpm.TraceIndex(tr)
    tags = cpm.request_ids(idx)
    check(len(tags) == n_reqs, f"serve slow: {len(tags)} requests in the trace, not {n_reqs}")
    first = _first_token_at(sorted(((e["name"], e["ts"], e["args"]) for e in tr["traceEvents"]
                                    if e["ph"] == "X"), key=lambda s: s[1]))
    cps, whole, ttft = {}, [], []
    for tag in tags:
        cp = cpm.critical_path(idx, tag)
        check(cp is not None, f"serve slow: no critical path for {tag}")
        ivs = cp.intervals
        check(bool(ivs) and ivs[0].t0 == cp.t0 and ivs[-1].t1 == cp.t1
              and all(b.t0 == a.t1 for a, b in zip(ivs, ivs[1:])),
              f"serve slow: {tag}'s path leaves a gap in [{cp.t0}, {cp.t1}]")
        check(cp.clamped_us < 0.01 * cp.total_us,
              f"serve slow: {tag} clamps {cp.clamped_us:.1f} of {cp.total_us:.1f} µs")
        check(tag in first, f"serve slow: {tag} has no decode step")
        cps[tag] = cp
        whole.append(_slow_shares(ivs, cp.t1))
        ttft.append(_slow_shares(ivs, first[tag]))
    report = attribution.slow_report(idx, cps)
    check({"interactive", "batch"} <= set(report["tiers"]),
          f"serve slow: tiers {sorted(report['tiers'])}")
    analysis_s = time.perf_counter() - t0

    eng_label = eng.scfg.name.split("#")[1]
    with MetricsExporter(port=0) as ex:
        status, body = http_get(ex.url)
    check(status == 200, f"serve metrics: /metrics answered {status}")
    fams = parse_prometheus_text(body, strict=True)

    def read(family):
        hits = [v for _n, labels, v in fams.get(family, {}).get("samples", [])
                if labels.get("engine") == eng_label]
        check(len(hits) == 1, f"serve metrics: {len(hits)} samples of {family}")
        return hits[0]

    scraped = {"requests_completed": read("repro_serve_requests_completed_total"),
               "tokens_generated": read("repro_serve_tokens_generated_total"),
               "first_token_p99_s": read("repro_serve_request_first_token_p99")}
    own = {"requests_completed": eng.c_done.get_value(),
           "tokens_generated": eng.c_tok.get_value(),
           "first_token_p99_s": eng.t_first.quantile(0.99)}
    check(scraped == own, f"serve metrics: scraped {scraped} != the engine's {own}")
    check(own["requests_completed"] == n_reqs + 1,
          f"serve metrics: {own['requests_completed']} requests completed, not {n_reqs + 1}")

    def p50(rows):
        return {k: statistics.median(r[k] for r in rows) for k in rows[0]}

    out = {"events": len(tr["traceEvents"]), "requests": len(tags),
           "share_p50": p50(whole), "ttft_window_share_p50": p50(ttft),
           "max_clamped_fraction": max(cp.clamped_us / cp.total_us for cp in cps.values()),
           "report": report, "scrape": scraped, "metric_families": len(fams),
           "analysis_s": analysis_s, "wall_s": time.perf_counter() - t0}
    REPORT["serve_slow"] = out

    def fmt(d):
        return " ".join(f"{k}={v:.4f}" for k, v in d.items())

    log(f"[serve slow] {out['events']} events, {len(tags)} paths, tiers "
        f"{sorted(report['tiers'])}; p50 share of a request: {fmt(out['share_p50'])}; "
        f"of its TTFT window: {fmt(out['ttft_window_share_p50'])}")
    log(f"[serve slow] /metrics: {len(fams)} families; {scraped} equal to the "
        f"engine's; analysis {analysis_s:.2f} s, with the scrape {out['wall_s']:.2f} s")


SERVE_TRAFFIC = (16, 2, 64)  # greedy requests, sampled ones, new tokens each


def _serve_paged(torch, np, card, arch, tag, extra=None, observe=False, cfg=None,
                 traffic=SERVE_TRAFFIC, profile=True):
    """Phases 5, 5c, 5d's VLM and 5e: ``arch`` (``cfg`` when given, else its
    full config) through ``Router.replicate`` with one paged engine and
    pipelined admission (random init from SEED, made one tensor at a time
    in bf16; max_batch 8, cache_len 1024, page 16): ``traffic``'s greedy
    requests with prompts of 16–512 tokens and its sampled ones (T=0.8,
    top-k 40), each with its new tokens (16, 2 and 64 but in phase 5e);
    exactly one flash launch per layer a prefill and one paged decode per
    layer a step; then, with ``profile``, phase 6's profile of the
    engine's model.  The vlm family's prompts are ``n_patches`` tokens
    longer (its image positions), its patches ``extra``.  With ``observe``
    the greedy requests are ``interactive`` and the sampled ``batch``, and
    the run's trace and counters go through ``_serve_slow``.  Returns the
    path's launches."""
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import SamplingParams, ServeConfig
    from repro_torch.serve.router import Router, default_extra_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or get_config(arch)
    n_greedy, n_sampled, max_new = traffic
    core.init(pools={"default": 4, "prefill": 2, "io": 1})
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg)  # cuda
        params = model.init_compute(SEED)
        scfg = ServeConfig(max_batch=8, cache_len=1024, page_size=16,
                           max_new_tokens=max_new, seed=SEED)
        router = Router.replicate(model, params, scfg, 1,
                                  extra_inputs=extra or default_extra_inputs(cfg))
        del params  # the engine holds them
        eng = router.engines[0]
        torch.cuda.synchronize()  # init and cast are enqueued, not done
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated()
        image = cfg.n_patches if cfg.family == "vlm" else 0
        # warm-up request (cuBLAS handles, allocator), outside the measured run
        check(len(router.submit([1] * (image + 16), max_new=2).get(timeout=600)) == 3,
              f"{tag}: warm-up failed")

        rng = np.random.default_rng(SEED)
        greedy = [rng.integers(1, cfg.vocab_size, size=image + n).tolist()
                  for n in rng.integers(16, 513, size=n_greedy)]
        sampled = [rng.integers(1, cfg.vocab_size, size=image + n).tolist()
                   for n in rng.integers(16, 513, size=n_sampled)]
        hot = SamplingParams(temperature=0.8, top_k=40)
        reqs = [(p, None) for p in greedy] + [(p, hot) for p in sampled]
        slos = (["interactive"] * len(greedy) + ["batch"] * len(sampled)
                if observe else None)
        serve = _drive(torch, router, eng, reqs, max_new, card, cfg.vocab_size, slos)
        serve.update(setup_s=setup_s, setup_peak_bytes=setup_peak, arch=arch,
                     layers=cfg.num_layers)
        if observe:
            _serve_slow(eng, len(reqs))
        launches, prefills, steps = serve["launches"], serve["prefills"], serve["decode_steps"]
        L = cfg.num_layers
        _check_launches(tag, launches, {"flash_attention": L * prefills,
                                        "paged_decode_attention": L * steps})
        REPORT[tag.replace(" ", "_")] = serve
        _log_serve(tag, serve)
        log(f"[{tag}] setup {setup_s:.1f} s, peak {setup_peak / 2**30:.2f} GiB; launches "
            f"{launches} = {L} × {prefills} prefills, {L} × {steps} decode steps")
        if profile:
            phase_profile(torch, np, eng, card,
                          tag.replace("serve", "profile").replace(" ", "_"))
        eng.close()
        return launches
    finally:
        core.finalize()
        gc.collect()
        torch.cuda.empty_cache()


def phase_serve(torch, np, card):
    return _serve_paged(torch, np, card, "starcoder2_3b", "serve", observe=True)


def phase_serve_moe(torch, np, card):
    """Phase 5c: full deepseek_moe_16b (28 layers: one dense, 27 MoE with
    64 routed experts top-6 and 2 shared; 16.4 B params, 32.8 GB in bf16)
    on phase 5's traffic: 28 flash launches a prefill, 28 paged decodes a
    step."""
    return _serve_paged(torch, np, card, "deepseek_moe_16b", "serve deepseek_moe_16b")


# ----------------------------------------------------------------- phase 5e
# (arch, layers served: None for the config's own): granite_34b is 47.25 B
# params, 94.5 GB in bf16, more than one card holds, so it serves at full
# width and 40 of its 88 layers (the widths set every kernel's shape)
SERVE_DENSE = (("qwen25_3b", None), ("starcoder2_15b", None), ("granite_34b", 40))
SERVE_DENSE_TRAFFIC = (8, 1, 32)


def _serving_bytes(cfg):
    """(bytes of the serving params, bytes of the largest fp32 draw) by the
    port's param specs: each param at the dtype ``compute_params`` gives
    it (bf16 but the fp32 norms and biases of ``FP32_PARAMS``) and the fp32
    unembedding beside them; ``init_compute`` draws each param in fp32
    before the cast, so the setup peaks near their sum."""
    from repro_torch.models import transformer
    from repro_torch.models.model import param_specs

    specs = param_specs(cfg)
    size = {p: math.prod(s.shape) for p, s in specs.items()}
    held = sum(n * (4 if p.rsplit("/", 1)[-1] in transformer.FP32_PARAMS else 2)
               for p, n in size.items())
    held += 4 * size["tok_embed" if cfg.tie_embeddings else "lm_head"]
    return held, 4 * max(size.values())


def phase_serve_dense(torch, np, card):
    """Phase 5e: qwen25_3b (36 layers) and starcoder2_15b (40) at full width
    and depth and granite_34b at full width and 40 of 88 layers, each on
    phase 5's engine (max_batch 8, cache_len 1024, page 16) with 8 greedy
    requests of 16–512 prompt tokens and 1 sampled (T=0.8, top-k 40), 32 new
    tokens each, no profile: exactly L flash launches a prefill and L paged
    decodes a step, token ids in the vocab; tokens/s, TTFT p50, decode-step
    p50, the setup's and the serving run's peaks beside the param bytes.
    Returns the launches summed over the three runs."""
    from repro_torch.configs import get_config

    total, out = {}, {}
    for arch, layers in SERVE_DENSE:
        full = get_config(arch)
        cfg = full if layers is None else replace(full, num_layers=layers)
        held, draw = _serving_bytes(cfg)
        cut = ("" if layers is None else
               f", {layers} of {full.num_layers} layers: all {full.num_layers} hold "
               f"{_serving_bytes(full)[0] / 1e9:.1f} GB of serving params, more than the "
               f"card's {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
        log(f"[serve {arch}] full width{cut}; {cfg.num_layers} layers: serving params "
            f"{held / 1e9:.1f} GB, largest fp32 draw {draw / 1e9:.2f} GB, setup peak "
            f"predicted ≤ {(held + draw) / 1e9:.1f} GB")
        tag = f"serve {arch}"
        launches = _serve_paged(torch, np, card, arch, tag, cfg=cfg,
                                traffic=SERVE_DENSE_TRAFFIC, profile=False)
        run = REPORT.pop(tag.replace(" ", "_"))
        run.update(full_layers=full.num_layers, serving_param_bytes=held,
                   largest_fp32_draw_bytes=draw)
        out[arch] = run
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    REPORT["serve_dense"] = out
    return total


# ----------------------------------------------------------------- phase 5b
def _serve_one(torch, np, card, arch, scfg, reqs, max_new, extra=None):
    """Serve ``reqs`` [(prompt, sampling)] through ``Router.replicate`` with
    one engine, full width and depth, random init from SEED, side inputs
    ``extra`` (default: the family's ``default_extra_inputs``); a warm-up
    request runs first, outside the measured run.  The masters are freed
    once the engine holds its compute copy, and the model and engine once
    done.  Profiles one decode step and one prefill of a 64-token prompt
    with the engine's side inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.router import Router, default_extra_inputs

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg)  # cuda
    params = model.init(SEED)
    router = Router.replicate(model, params, scfg, 1,
                              extra_inputs=extra or default_extra_inputs(cfg))
    del params
    torch.cuda.empty_cache()
    eng = router.engines[0]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(len(router.submit([1] * 16, max_new=2).get(timeout=600)) == 3,
          f"serve {arch}: warm-up failed")
    serve = _drive(torch, router, eng, reqs, max_new, card, cfg.vocab_size)
    serve.update(setup_s=setup_s, paged=eng.paged,
                 pipeline_admission=scfg.pipeline_admission)
    # where a decode step's time goes: the engine's model, params and
    # dense-slot cache (all max_batch rows, as the engine steps them),
    # outside the engine's threads
    tok = torch.ones(scfg.max_batch, 1, dtype=torch.long, device=eng.device)
    cache = eng.backend.device_cache()
    with torch.inference_mode():
        def step():
            model.decode(eng.params, cache, tok)

        step()
        torch.cuda.synchronize()
        serve["profile_decode_step"] = prof = _device_profile(torch, step, 10)
    busy = ("device time not measured (the profiler saw none)" if prof["device_ms"] is None
            else f"device busy {prof['device_ms']:.2f} ms ({100 * prof['busy_share']:.1f}%), "
                 f"{prof['kernels_per_call']:.0f} kernels")
    log(f"[profile] {arch} decode step, B={scfg.max_batch}: wall {prof['wall_ms']:.2f} ms, "
        f"{busy}")
    pin = {"tokens": torch.ones(1, 64, dtype=torch.long, device=eng.device),
           **eng.prefill_inputs}
    with torch.inference_mode():
        def prefill():
            model.prefill(eng.params, pin, cache_len=scfg.cache_len)

        prefill()
        torch.cuda.synchronize()
        serve["profile_prefill"] = prof = _device_profile(torch, prefill, 3)
    log(f"[profile] {arch} prefill of 64 tokens: wall {prof['wall_ms']:.2f} ms, "
        f"device {prof['device_ms']} ms, flash {prof.get('flash_attention_ms')} ms in "
        f"{prof.get('flash_attention_kernels')} kernels, kinds {prof.get('groups_ms')}")
    del router, eng, model, cache, step
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, serve


def phase_serve_families(torch, np, card):
    """The dense-slot engine at full width and depth: mamba2_780m and
    recurrentgemma_2b (8 greedy requests, prompts of 16–1024 tokens, the
    hybrid's last one 2030 so that its decode wraps the 2048-slot ring; 32
    new tokens each), then starcoder2_3b in the seed baseline (dense cache,
    inline prefill; 4 greedy requests).  Exact launch counts per path:
    mamba2_780m 48 SSD scans a prefill and nothing else; recurrentgemma_2b
    18 RG-LRU scans and 8 flash launches a prefill and 8 dense decodes a
    step; the seed baseline 30 flash launches a prefill and 30 dense
    decodes a step.  Returns the launches summed over the three paths."""
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    max_new = 32
    rng = np.random.default_rng(SEED + 4)
    vocab = min(get_config(a).vocab_size for a in ("mamba2_780m", "recurrentgemma_2b"))
    prompts = [rng.integers(1, vocab, size=n).tolist() for n in rng.integers(16, 1025, size=8)]
    long_prompt = rng.integers(1, vocab, size=2030).tolist()
    seed_prompts = [rng.integers(1, get_config("starcoder2_3b").vocab_size, size=n).tolist()
                    for n in rng.integers(16, 513, size=4)]
    dense_slots = ServeConfig(max_batch=8, cache_len=1024, max_new_tokens=max_new, seed=SEED)
    runs = (("mamba2_780m", dense_slots, prompts),
            ("recurrentgemma_2b", dense_slots, prompts[:-1] + [long_prompt]),
            ("starcoder2_3b", replace(dense_slots, max_batch=4, paged=False,
                                      pipeline_admission=False), seed_prompts))
    total = {}
    core.init(pools={"default": 4, "prefill": 2, "io": 1})
    try:
        for arch, scfg, reqs in runs:
            cfg, serve = _serve_one(torch, np, card, arch, scfg, [(p, None) for p in reqs],
                                    max_new)
            launches, prefills, steps = (serve["launches"], serve["prefills"],
                                         serve["decode_steps"])
            check(not serve["paged"], f"serve {arch}: not on the dense slots")
            if cfg.family == "ssm":
                want = {"ssd_scan": cfg.num_layers * prefills}
            elif cfg.family == "hybrid":
                groups = cfg.num_layers // len(cfg.block_pattern)
                want = {"rglru_scan": (cfg.num_layers - groups) * prefills,
                        "flash_attention": groups * prefills,
                        "decode_attention": groups * steps}
            else:
                want = {"flash_attention": cfg.num_layers * prefills,
                        "decode_attention": cfg.num_layers * steps}
            _check_launches(f"serve {arch}", launches, want)
            tag = f"serve {arch}" + ("" if scfg.pipeline_admission else " seed-baseline")
            REPORT[tag.replace(" ", "_")] = serve
            _log_serve(tag, serve)
            log(f"[{tag}] launches {launches} for {prefills} prefills, {steps} decode "
                f"steps")
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
    finally:
        core.finalize()
    return total


# ----------------------------------------------------------------- phase 5d
def phase_serve_encdec_vlm(torch, np, card):
    """The enc-dec and VLM families at full width and depth, random init
    from SEED, each model freed before the next.  whisper_small on the
    dense slots (max_batch 8, cache_len 512), its encoder frames 1500 (the
    30-second window) drawn in bf16 from a seeded generator: 8 greedy and 2
    sampled (T=0.8, top-k 40) requests of 4–64 prompt tokens, 128 new
    each; exactly 24 flash launches a prefill (12 non-causal, 12 causal)
    and 24 dense decodes a step (12 self, 12 cross); a decode step and a
    prefill profiled.  internvl2_2b on phase 5's paged engine and traffic,
    each prompt 256 image positions longer, its patches (1, 256, 2048) bf16
    drawn from a seed: 24 flash launches a prefill and 24 paged decodes a
    step.  Returns the launches summed over the two paths."""
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import SamplingParams, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("whisper_small")
    max_new = 128
    rng = np.random.default_rng(SEED + 13)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in rng.integers(4, 65, size=10)]
    hot = SamplingParams(temperature=0.8, top_k=40)
    reqs = [(p, None) for p in prompts[:8]] + [(p, hot) for p in prompts[8:]]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    enc = torch.randn(1, WHISPER_FRAMES, cfg.d_model, generator=gen, device="cuda")
    extra = {"enc": enc.to(torch.bfloat16), "enc_len": WHISPER_FRAMES}
    scfg = ServeConfig(max_batch=8, cache_len=512, max_new_tokens=max_new, seed=SEED)
    core.init(pools={"default": 4, "prefill": 2, "io": 1})
    try:
        cfg, serve = _serve_one(torch, np, card, "whisper_small", scfg, reqs, max_new,
                                extra=extra)
    finally:
        core.finalize()
    launches, prefills, steps = serve["launches"], serve["prefills"], serve["decode_steps"]
    check(not serve["paged"], "serve whisper_small: not on the dense slots")
    _check_launches("serve whisper_small", launches,
                    {"flash_attention": (cfg.enc_layers + cfg.dec_layers) * prefills,
                     "decode_attention": 2 * cfg.dec_layers * steps})
    serve["frames"] = WHISPER_FRAMES
    REPORT["serve_whisper_small"] = serve
    _log_serve("serve whisper_small", serve)
    log(f"[serve whisper_small] launches {launches} for {prefills} prefills, {steps} "
        f"decode steps")
    total = dict(launches)
    del enc, extra
    gc.collect()
    torch.cuda.empty_cache()
    vlm = get_config("internvl2_2b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    patches = torch.randn(1, vlm.n_patches, vlm.d_model, generator=gen, device="cuda")
    for k, n in _serve_paged(torch, np, card, "internvl2_2b", "serve internvl2_2b",
                             extra={"patches": patches.to(torch.bfloat16)}).items():
        total[k] += n
    return total


# ------------------------------------------------------------------ phase 6
# kernel kinds of a profile, by words in the kernel's name, first match
PROFILE_GROUPS = (("flash", ("flash_fwd",)), ("decode", ("repro_torch::decode::",)),
                  ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "nvjet")),
                  ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))


def _device_kernels(prof):
    """[(name, device µs, count)] of a finished ``torch.profiler`` run's
    device-side events (kernels, copies, fills), summed by name, read from
    its raw kineto events: the aten ops that launched them would carry
    the same time again, and ``key_averages()`` first builds a Python
    event tree, which takes about a minute for a training step's ~10⁵
    kernels."""
    from torch.autograd import DeviceType

    by = {}
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0
                and not ev.is_hidden_event()):
            us, count = by.get(ev.name(), (0.0, 0))
            by[ev.name()] = (us + ev.duration_ns() / 1e3, count + 1)
    return [(name, us, count) for name, (us, count) in by.items()]


def _device_profile(torch, fn, n):
    """Wall time of ``n`` calls of ``fn`` (each ends in a synchronize),
    then the same under torch.profiler with its device kernel time and the
    attention kernels' share of it (decode: the split and combine kernels
    of ``csrc/decode_attention.cuh``; flash: ``csrc/flash_attention.cu``);
    device time None if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    out = {"wall_ms": wall_plain * 1e3 / n, "profiled_wall_ms": wall * 1e3 / n}
    if not kernels:
        return {**out, "device_ms": None}
    device_us = sum(us for _, us, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:6]
    decode = [k for k in kernels if "repro_torch::decode::" in k[0]]
    flash = [k for k in kernels if "flash_fwd" in k[0]]
    groups = {}  # device ms by kind of kernel
    for name, us, _ in kernels:
        key = name.lower()
        kind = next((g for g, words in PROFILE_GROUPS if any(w in key for w in words)),
                    "other")
        groups[kind] = groups.get(kind, 0.0) + us / 1e3 / n
    return {**out, "device_ms": device_us / 1e3 / n, "groups_ms": groups,
            "decode_attention_ms": sum(us for _, us, _ in decode) / 1e3 / n,
            "decode_attention_kernels": sum(c for _, _, c in decode) / n,
            "flash_attention_ms": sum(us for _, us, _ in flash) / 1e3 / n,
            "flash_attention_kernels": sum(c for _, _, c in flash) / n,
            "busy_share": device_us / 1e6 / wall_plain,
            "kernels_per_call": sum(c for _, _, c in kernels) / n,
            "top": [(name[:60], us / 1e3 / n, c / n) for name, us, c in top]}


def phase_profile(torch, np, eng, card, key="profile"):
    """Where a decode step's and a prefill's time goes, outside the
    engine's threads: the engine's own model, params and cache layout;
    decode at B=8 with ~300 live tokens per slot, prefill of a 512 bucket.
    Reported under ``key``."""
    from repro_torch.serve.kv_cache import PagedKVCache

    model, params, cfg = eng.model, eng.params, eng.model.cfg
    rng = np.random.default_rng(SEED + 2)
    B, page, maxp = 8, 16, 64
    kv = PagedKVCache(model, num_pages=B * maxp + 1, page_size=page, max_batch=B,
                      max_pages_per_req=maxp, name="profile")
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    for b, n in enumerate(rng.integers(250, 350, size=B).tolist()):
        zeros = {name: torch.zeros(pool.shape[0], 1, n, KV, Dh, dtype=torch.bfloat16,
                                   device="cuda") for name, pool in kv.pools.items()}
        check(kv.admit(b, zeros, n), "profile: admit failed")
    tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, 1))).cuda()

    def decode():
        for b in range(B):
            kv.ensure_next_token(b)
        model.decode_paged(params, kv.device_cache(), tok)
        kv.pos[:] += 1

    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, 512))).cuda()
    vl = torch.tensor([500], dtype=torch.int32, device="cuda")
    def prefill():  # with the vlm family's patches
        model.prefill(params, {"tokens": prompt, **eng.prefill_inputs}, cache_len=512,
                      valid_len=vl)

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
                    f"{r['kernels_per_call']:.0f} kernels; decode attention "
                    f"{r['decode_attention_ms']:.3f} ms in "
                    f"{r['decode_attention_kernels']:.0f} kernels; flash "
                    f"{r['flash_attention_ms']:.3f} ms in "
                    f"{r['flash_attention_kernels']:.0f} kernels")
            log(f"[{key}] {name}: wall {r['wall_ms']:.2f} ms (profiled "
                f"{r['profiled_wall_ms']:.2f} ms), {busy}")
    kv.close()
    REPORT[key] = out


# ------------------------------------------------------------------ phase 7
def phase_ops(torch, np, card, timings):
    """The reference's single-source kernel API at full widths, then
    STREAM from phase 3's triad timings: ops.stream_triad against torch's
    native fp32 triad."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.rglru_scan import rglru_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.stream import stream_triad_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf16 = torch.bfloat16
    B, T, H, KV, Dh = STARCODER_CACHE
    q, k, v = _decode_inputs(torch, gen, B, T, H, KV, Dh, bf16)
    lens = torch.tensor(STARCODER_LENS, dtype=torch.int32, device="cuda")
    ssd_args = _ssd_inputs(torch, gen, *MAMBA, bf16)
    a, b = _rglru_inputs(torch, gen, *GRIFFIN_LRU, bf16)
    triads = {"float32": _triad_inputs(torch, gen, STREAM_N, torch.float32),
              "bfloat16": _triad_inputs(torch, gen, STREAM_N, bf16)}
    torch.cuda.synchronize()

    ops.reset_launch_counts()  # ← this slice's path starts here
    o = ops.decode_attention(q, k, v, lens)
    y = ops.ssd_scan(*ssd_args, chunk=MAMBA_CHUNK)
    h = ops.rglru_scan(a, b)
    triad_out = {name: ops.stream_triad(ta, tb, 3.0) for name, (ta, tb) in triads.items()}
    torch.cuda.synchronize()
    launches = ops.launch_counts()  # ← and ends here

    want = {"flash_attention": 0, "paged_decode_attention": 0, "decode_attention": 1,
            "ssd_scan": 1, "rglru_scan": 1, "stream_triad": 2}
    check(launches == want, f"ops: launches {launches} != {want}")
    check(o.shape == q.shape and y.shape == ssd_args[0].shape and h.shape == a.shape,
          "ops: output shapes")
    f32 = lambda xs: [x.float() for x in xs]  # noqa: E731
    plain = {  # (the plain version in bf16, in fp32) on the same inputs
        "decode_attention": (decode_attention_plain(q, k, v, lens),
                             decode_attention_plain(*f32((q, k, v)), lens)),
        "ssd_scan": (ssd_scan_plain(*ssd_args, chunk=MAMBA_CHUNK),
                     ssd_scan_plain(*f32(ssd_args), chunk=MAMBA_CHUNK)),
        "rglru_scan": (rglru_scan_plain(a, b), rglru_scan_plain(*f32((a, b)))),
    }
    errs = {}
    for name, out in (("decode_attention", o), ("ssd_scan", y), ("rglru_scan", h)):
        e, e32 = plain[name]
        check(bool(torch.isfinite(out).all().item()), f"ops: {name} not finite")
        diff = (out.float() - e.float()).abs()
        rtol = SSD_RTOL if name == "ssd_scan" else 0.0
        row = _row_err(out, e32)
        errs[name] = {"max_abs_err": diff.max().item(), "max_row_err": row}
        check(bool((diff <= ABS_TOL[name]["bfloat16"] + rtol * e.float().abs()).all()),
              f"ops: {name} max abs err {errs[name]['max_abs_err']}")
        check(row <= ROW_TOL[name, "bfloat16"],
              f"ops: {name} row err {row} (tol {ROW_TOL[name, 'bfloat16']})")
    for name, (ta, tb) in triads.items():
        check(torch.equal(triad_out[name], stream_triad_plain(ta, tb, 3.0)),
              f"ops: stream_triad {name} differs from a + 3·b")

    fp32_row, bf16_row = timings["stream_triad"]
    rate = lambda nbytes, ms: nbytes / ms / 1e6  # noqa: E731  (GB/s)
    stream = {"card": card, "N": STREAM_N, "from": "phase 3 timings",
              "float32": {"ms": fp32_row["ms"], "GB_per_s": rate(fp32_row["bytes"],
                                                                 fp32_row["ms"])},
              "bfloat16": {"ms": bf16_row["ms"], "GB_per_s": rate(bf16_row["bytes"],
                                                                  bf16_row["ms"])},
              "native_float32": {"ms": fp32_row["library_ms"],
                                 "GB_per_s": rate(fp32_row["bytes"],
                                                  fp32_row["library_ms"])}}
    stream["ratio_float32"] = (stream["float32"]["GB_per_s"]
                               / stream["native_float32"]["GB_per_s"])
    REPORT["ops"] = {"launches": launches, "bf16_errors": errs}
    REPORT["stream"] = stream
    log(f"[ops] launches {launches}; bf16 errors vs plain {errs}")
    log(f"[stream] {card}: N = 2^27, triad fp32 {stream['float32']['GB_per_s']:.1f} GB/s "
        f"({stream['float32']['ms']:.4f} ms), bf16 {stream['bfloat16']['GB_per_s']:.1f} GB/s "
        f"({stream['bfloat16']['ms']:.4f} ms); native torch.add fp32 "
        f"{stream['native_float32']['GB_per_s']:.1f} GB/s; ratio "
        f"{stream['ratio_float32']:.4f}")
    return launches


# ------------------------------------------------------------------ phase 8
# parity: layers kept, batch, sequence; the full run: batch, sequence,
# futurized steps (1,024 tokens a step: a short run whose steps show the
# step's fixed costs, AdamW's above all); then batch, sequence and
# microbatches of a step of 16,384 tokens, one starcoder2_3b context's
# worth (arXiv:2402.19173), over which those fixed costs spread
TRAIN_PARITY = (2, 1, 256)
TRAIN_RUN = (2, 512, 3)      # 3 steps, not 6: the whole script's time limit
TRAIN_WIDE = (8, 2048, 8)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
# parity limits, fp32 with TF32 off: the loss (a mean of ~10.8-nat NLLs,
# the same fp32 math in other summation orders: ~1e-6 relative); each
# gradient's worst element against 1e-3 of that tensor's largest (sums of
# 256 tokens' products over 3072–49152 terms, in other orders); the AdamW
# update on the same grads (elementwise fp32; the global norm summed in
# another order moves the clip scale by ulps)
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_UPDATE_ATOL = 1e-6
TRAIN_NORM_RTOL = 1e-5
# the remat policies on the card: the same ops on the same inputs, so the
# same grads; only sums whose order follows atomics (the embedding's
# gradient) may differ, by ulps
REMAT_RTOL = 1e-5
# bsp (full remat) against futurized on the same params and batch, bf16:
# the same forward ops, so equal up to bf16 rounding (test_torch_train.py's
# bf16 loss limit); each gradient's worst element against that tensor's
# largest, and the global grad norm, within one bf16 rounding (2⁻⁸)
TRAIN_BF16_LOSS_TOL = 2e-2
BSP_GRAD_RTOL = 2 ** -8


def phase_train_parity(torch, np):
    """One train step at full width and 2 layers, fp32 (TF32 off), on the
    card and on the CPU, same params and batch: the loss and every
    gradient (none all zero: attention's projections above all); the same
    grads on the card under the full and dots remat policies (flash
    launching again in the backward); then the AdamW update.  The update is held on the card's own gradients, applied
    on both devices: Adam's first step moves a param by ±lr·sign(g), so a
    gradient at rounding level would flip it and hide the update's math."""
    from repro_torch.configs.starcoder2_3b import full_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.dist.plan import get_plan
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, S = TRAIN_PARITY
    t0 = time.perf_counter()
    cfg = replace(full_config(), num_layers=layers, dtype="float32")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(SEED)
    batch = synth_batch(cfg, DataConfig(batch_size=B, seq_len=S, seed=SEED), 0)
    loss_c, grads_c = step_mod.value_and_grad(cpu.loss, params, batch)
    gpu = Model(cfg)
    pg = {k: v.cuda() for k, v in params.items()}
    ops.reset_launch_counts()
    loss_g, grads_g = step_mod.value_and_grad(gpu.loss, pg,
                                              {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _check_launches("train parity", launches, {"flash_attention": layers})
    loss_err = abs(loss_g.item() - loss_c.item())
    grad_errs = {}
    for k, gc_ in grads_c.items():
        gg = grads_g[k].cpu()
        scale = gc_.abs().max().item()
        grad_errs[k] = {"max_abs_err": (gg - gc_).abs().max().item(), "max_abs": scale,
                        "card_max_abs": gg.abs().max().item()}
        check(bool(torch.isfinite(gg).all().item()), f"train parity: {k} grad not finite")
        check(grad_errs[k]["card_max_abs"] > 0, f"train parity: {k} grad all zero")
        check(grad_errs[k]["max_abs_err"] <= TRAIN_GRAD_RTOL * scale,
              f"train parity: {k} grad err {grad_errs[k]['max_abs_err']} > "
              f"{TRAIN_GRAD_RTOL} × {scale}")
    check(loss_err <= TRAIN_LOSS_TOL, f"train parity: loss err {loss_err}")
    remat = {}
    for policy in ("full", "dots"):
        m = Model(cfg, plan=get_plan("futurized", remat_policy=policy))
        ops.reset_launch_counts()
        _, g = step_mod.value_and_grad(m.loss, pg, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        _check_launches(f"train parity {policy} remat", ops.launch_counts(),
                        {"flash_attention": 2 * layers})  # again in the backward
        remat[policy] = max(((g[k] - grads_g[k]).abs().max() /
                             grads_g[k].abs().max().clamp_min(1e-30)).item() for k in g)
        check(remat[policy] <= REMAT_RTOL,
              f"train parity: {policy} remat grads differ from none by {remat[policy]}")
        del g
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    host_grads = {k: g.to("cpu", copy=True) for k, g in grads_g.items()}
    _, _, mg = adamw.update(opt, pg, grads_g, adamw.init(pg))
    pc = {k: v.clone() for k, v in params.items()}
    _, _, mc = adamw.update(opt, pc, host_grads, adamw.init(pc))
    upd_err = max((pg[k].cpu() - pc[k]).abs().max().item() for k in pc)
    moved = min((pc[k] - params[k]).abs().max().item() for k in pc)
    norm_err = abs(mg["grad_norm"].item() / mc["grad_norm"].item() - 1)
    check(upd_err <= TRAIN_UPDATE_ATOL and moved > 0 and norm_err <= TRAIN_NORM_RTOL,
          f"train parity: update err {upd_err} (a param moved by at least {moved}), "
          f"grad norm rel err {norm_err}")
    worst = max(grad_errs, key=lambda k: grad_errs[k]["max_abs_err"] / grad_errs[k]["max_abs"])
    REPORT["train_parity"] = {
        "layers": layers, "batch": B, "seq": S, "loss_card": loss_g.item(),
        "loss_cpu": loss_c.item(), "loss_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
        "grad_rtol": TRAIN_GRAD_RTOL, "grads": grad_errs, "update_err": upd_err,
        "update_tol": TRAIN_UPDATE_ATOL, "grad_norm_rel_err": norm_err,
        "launches": launches, "remat_rel_err": remat, "remat_rtol": REMAT_RTOL,
        "seconds": time.perf_counter() - t0}
    log(f"[train parity] {layers} layers, B={B}, S={S}, float32: loss {loss_g.item():.6f} "
        f"(err {loss_err:.3g}, tol {TRAIN_LOSS_TOL}); worst grad {worst}: "
        f"{grad_errs[worst]['max_abs_err']:.3g} of max {grad_errs[worst]['max_abs']:.3g} "
        f"(rtol {TRAIN_GRAD_RTOL}); AdamW update err {upd_err:.3g} (tol "
        f"{TRAIN_UPDATE_ATOL}); launches {launches}; full / dots remat grads within "
        f"{remat['full']:.3g} / {remat['dots']:.3g} of none (rtol {REMAT_RTOL})")


def _train_wide(torch, cfg, tr, opt):
    """Two futurized steps of ``TRAIN_WIDE`` tokens on the trainer's params
    (the first a warm-up), as the train step runs them: the microbatches'
    grads, then AdamW, CUDA events between.  Each: finite loss and grad
    norm, exactly 30 flash launches a microbatch; wall and device times,
    tokens/s, AdamW's share, peak memory; then one more under
    torch.profiler.  Returns the report with the launches of the two."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.dist.plan import get_plan
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    B, S, n_mb = TRAIN_WIDE
    model = Model(cfg, plan=get_plan("futurized", microbatches=n_mb))
    dcfg = DataConfig(batch_size=B, seq_len=S, seed=SEED)

    def one(i):
        batch = {k: v.cuda() for k, v in synth_batch(cfg, dcfg, 2 * 10 ** 6 + i).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ops.reset_launch_counts()  # ← one step of TRAIN_WIDE tokens
        t0 = time.perf_counter()
        ev[0].record()
        loss, grads = step_mod._microbatch_grads(model.loss, tr.params, batch, n_mb)
        ev[1].record()
        tr.params, tr.opt_state, m = adamw.update(opt, tr.params, grads, tr.opt_state)
        ev[2].record()
        loss, norm = loss.item(), m["grad_norm"].item()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()  # ← and its end
        del grads
        _check_launches("train wide", launches, {"flash_attention": cfg.num_layers * n_mb})
        check(math.isfinite(loss) and math.isfinite(norm),
              f"train wide: loss {loss} or grad norm {norm} not finite")
        fb, ad = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        return {"loss": loss, "grad_norm": norm, "wall_ms": wall * 1e3,
                "tokens_per_s": B * S / wall, "forward_backward_ms": fb,
                "adamw_ms": ad, "adamw_share": ad / (fb + ad),
                "peak_bytes": torch.cuda.max_memory_allocated(), "launches": launches}

    steps = [one(0), one(1)]
    total = {k: steps[0]["launches"][k] + steps[1]["launches"][k] for k in steps[0]["launches"]}
    # where the device time goes, two steps more (the profiler's launches
    # are not the measured steps')
    prof = _device_profile(torch, lambda: one(2), 1)
    return {"batch": B, "seq": S, "microbatches": n_mb, "tokens_per_step": B * S,
            "plan": "futurized", "steps": steps, "launches": total,
            "profile_one_step": prof}


def phase_train(torch, np, card):
    """Full starcoder2_3b (30 layers, fp32 masters, bf16 compute) trained
    through ``Trainer.fit`` under the futurized plan, one step a call
    (log_every 1: each ends in the loss's copy to the host): finite loss
    and global grad norm (finite only if every grad is), exactly 30 flash
    launches a step; step-time p50, tokens/s, peak memory; one step under
    torch.profiler; then one bsp step (full remat) on the same params and
    a batch whose futurized loss and grads were just taken: 60 flash
    launches, the same loss, grads and grad norm within bf16 limits; then
    two steps at ``TRAIN_WIDE`` tokens (``_train_wide``)."""
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.dist.plan import get_plan
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = get_config("starcoder2_3b")
    B, S, steps = TRAIN_RUN
    L = cfg.num_layers
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    dcfg = DataConfig(batch_size=B, seq_len=S, seed=SEED)
    core.init(pools={"default": 4, "io": 1})
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(Model(cfg), opt, dcfg, TrainConfig(steps=steps, log_every=1),
                     rng_seed=SEED)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        hist, step_s = [], []
        ops.reset_launch_counts()  # ← the training path starts here
        for _ in range(steps):
            t0 = time.perf_counter()
            hist += tr.fit(1)
            step_s.append(time.perf_counter() - t0)
        launches = ops.launch_counts()  # ← and ends here
        peak = torch.cuda.max_memory_allocated()
        _check_launches("train", launches, {"flash_attention": L * steps})
        check(len(hist) == steps and all(math.isfinite(h["loss"]) and
                                         math.isfinite(h["grad_norm"]) for h in hist),
              f"train: loss or grad norm not finite: {hist}")
        p50 = statistics.median(step_s)
        prof = _device_profile(torch, lambda: tr.fit(1), 1)
        # one step's device-clock split: forward + backward, then AdamW
        # (the step's own two calls, CUDA events between them)
        batch = {k: v.cuda() for k, v in synth_batch(cfg, dcfg, 10 ** 6 + 1).items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        _, grads = step_mod.value_and_grad(tr.model.loss, tr.params, batch)
        ev[1].record()
        adamw.update(opt, tr.params, grads, tr.opt_state)
        ev[2].record()
        torch.cuda.synchronize()
        del grads
        split_ms = {"forward_backward": ev[0].elapsed_time(ev[1]),
                    "adamw": ev[1].elapsed_time(ev[2])}

        # one bsp step (the train step's two calls) on the same params and a
        # batch whose futurized loss and grads were just taken
        batch = {k: v.cuda() for k, v in synth_batch(cfg, dcfg, 10 ** 6).items()}
        loss_f, grads_f = step_mod.value_and_grad(tr.model.loss, tr.params, batch)
        loss_f, norm_f = loss_f.item(), adamw.global_norm(grads_f.values()).item()
        bsp = Model(cfg, plan=get_plan("bsp"))
        ops.reset_launch_counts()  # ← one bsp step
        t0 = time.perf_counter()
        loss_b, grads_b = step_mod.value_and_grad(bsp.loss, tr.params, batch)
        loss_b = loss_b.item()
        bsp_s = time.perf_counter() - t0
        bsp_errs = {k: (grads_b[k] - g).abs_().max().item() / max(g.abs().max().item(), 1e-30)
                    for k, g in grads_f.items()}
        del grads_f
        t0 = time.perf_counter()
        tr.params, tr.opt_state, m = adamw.update(opt, tr.params, grads_b, tr.opt_state)
        norm_b = m["grad_norm"].item()
        bsp_s += time.perf_counter() - t0
        bsp_launches = ops.launch_counts()  # ← and its end
        del grads_b
        _check_launches("train bsp", bsp_launches, {"flash_attention": 2 * L})
        worst = max(bsp_errs, key=bsp_errs.get)
        check(abs(loss_b - loss_f) <= TRAIN_BF16_LOSS_TOL and
              bsp_errs[worst] <= BSP_GRAD_RTOL and
              abs(norm_b - norm_f) <= BSP_GRAD_RTOL * norm_f,
              f"train bsp: loss {loss_b} vs futurized {loss_f}, grad {worst} off by "
              f"{bsp_errs[worst]} of its max, grad norm {norm_b} vs {norm_f}")

        # the cost per token at 16,384 tokens a step (microbatched)
        wide = _train_wide(torch, cfg, tr, opt)
        train = {"card": card, "arch": cfg.name, "layers": L, "batch": B, "seq": S,
                 "plan": "futurized", "steps": steps, "history": hist, "step_s": step_s,
                 "step_p50_s": p50, "tokens_per_s": B * S / p50, "setup_s": setup_s,
                 "max_memory_allocated_bytes": peak, "held_before_bytes": held,
                 "launches": launches, "profile_one_step": prof, "split_ms": split_ms,
                 "bsp": {"loss": loss_b, "futurized_loss": loss_f, "step_s": bsp_s,
                         "launches": bsp_launches, "tol": TRAIN_BF16_LOSS_TOL,
                         "grad_norm": norm_b, "futurized_grad_norm": norm_f,
                         "grad_rel_err": bsp_errs, "grad_rtol": BSP_GRAD_RTOL},
                 "wide": wide}
        REPORT["train"] = train
        busy = ("device time not measured (the profiler saw none)"
                if prof["device_ms"] is None else
                f"device busy {prof['device_ms']:.1f} ms ({100 * prof['busy_share']:.1f}%), "
                f"{prof['kernels_per_call']:.0f} kernels, flash "
                f"{prof['flash_attention_ms']:.3f} ms in {prof['flash_attention_kernels']:.0f}")
        log(f"[train] {card}: {cfg.name} {L} layers, B={B}, S={S}, futurized: losses "
            f"{[round(h['loss'], 4) for h in hist]}; step p50 {p50 * 1e3:.1f} ms "
            f"({[round(t * 1e3, 1) for t in step_s]}), {B * S / p50:.0f} tokens/s; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB (held before "
            f"{held / 2**30:.2f}); launches {launches}")
        log(f"[train] kernel kinds, device ms: "
            f"{ {g: round(t, 1) for g, t in prof.get('groups_ms', {}).items()} }")
        log(f"[train] one step profiled: wall {prof['wall_ms']:.1f} ms, {busy}; device "
            f"clock: forward + backward {split_ms['forward_backward']:.1f} ms, AdamW "
            f"{split_ms['adamw']:.1f} ms")
        log(f"[train] bsp step: loss {loss_b:.5f} vs futurized {loss_f:.5f}, grad norm "
            f"{norm_b:.6g} vs {norm_f:.6g}, worst grad {worst} off by "
            f"{bsp_errs[worst]:.3g} of its max (limit {BSP_GRAD_RTOL}); "
            f"{bsp_s * 1e3:.1f} ms, launches {bsp_launches}")
        w = wide["steps"][-1]
        log(f"[train] {wide['tokens_per_step']} tokens a step ({wide['microbatches']} "
            f"microbatches of B={wide['batch'] // wide['microbatches']}, S={wide['seq']}), "
            f"futurized: step {w['wall_ms']:.1f} ms (warm-up "
            f"{wide['steps'][0]['wall_ms']:.1f}), {w['tokens_per_s']:.0f} tokens/s; device "
            f"clock: forward + backward {w['forward_backward_ms']:.1f} ms, AdamW "
            f"{w['adamw_ms']:.1f} ms ({100 * w['adamw_share']:.1f}%); loss "
            f"{w['loss']:.4f}; max_memory_allocated {w['peak_bytes'] / 2**30:.2f} GiB; "
            f"launches {w['launches']}")
        wp = wide["profile_one_step"]
        if wp["device_ms"] is not None:
            log(f"[train] {wide['tokens_per_step']} tokens, one step profiled: device busy "
                f"{wp['device_ms']:.1f} ms ({100 * wp['busy_share']:.1f}%), kernel kinds, "
                f"device ms: { {g: round(t, 1) for g, t in wp['groups_ms'].items()} }")
        tr.close()
        del tr, bsp
        return {k: launches[k] + bsp_launches[k] + wide["launches"][k] for k in launches}
    finally:
        core.finalize()
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 8c
# the families this slice trains, at full width: the layers kept for the
# card-vs-CPU parity (recurrentgemma_2b: one (rec, rec, attn) group, so
# that both scans' backward and the local attention are held)
TRAIN_FAMILIES = (("granite_moe_3b_a800m", 2), ("mamba2_780m", 2), ("recurrentgemma_2b", 3))
# phase 8d: whisper_small 2 encoder + 2 decoder layers, internvl2_2b 2
TRAIN_ENCDEC_VLM = (("whisper_small", 4), ("internvl2_2b", 2))
# key biases (whisper_small's): q·b_k shifts every score of a row, which
# softmax does not see, so their exact gradient is 0 and each side's is
# rounding noise, held within TRAIN_GRAD_RTOL of the largest gradient
ZERO_GRAD = ("bk", "xbk")


def _microbatch_launches(cfg, layers):
    """Kernel launches of one microbatch's forward and backward under the
    futurized plan (no remat): the flash forward per attention layer, the
    SSD forward per Mamba-2 block, the RG-LRU forward and its reversed
    twin in the backward per recurrent layer."""
    if cfg.family == "ssm":
        return {"ssd_scan": layers}
    if cfg.family == "hybrid":
        groups = layers // len(cfg.block_pattern)
        return {"rglru_scan": 2 * (layers - groups), "flash_attention": groups}
    return {"flash_attention": layers}


def _train_family_parity(torch, cfg, layers):
    """Phase 8a's loss-and-gradient check for another family: one step's
    loss and every gradient at full width and ``layers`` layers (the
    encdec family: half encoder, half decoder), fp32 (TF32 off), on the
    card against the CPU, same params and batch (the family's side inputs
    among it); exact launches."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, B, S = TRAIN_PARITY
    S += cfg.n_patches  # the vlm family's image positions carry no loss
    t0 = time.perf_counter()
    cut = {"enc_layers": layers // 2, "dec_layers": layers // 2} if cfg.family == "encdec" else {}
    cfg = replace(cfg, num_layers=layers, dtype="float32", **cut)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(SEED)
    batch = synth_batch(cfg, DataConfig(batch_size=B, seq_len=S, seed=SEED), 0)
    loss_c, grads_c = step_mod.value_and_grad(cpu.loss, params, batch)
    pg = {k: v.cuda() for k, v in params.items()}
    ops.reset_launch_counts()
    loss_g, grads_g = step_mod.value_and_grad(Model(cfg).loss, pg,
                                              {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _check_launches(f"train parity {cfg.name}", launches, _microbatch_launches(cfg, layers))
    loss_err = abs(loss_g.item() - loss_c.item())
    rel = {}
    largest = max(g.abs().max().item() for g in grads_c.values())
    for k, gc_ in grads_c.items():
        gg = grads_g[k].cpu()
        check(bool(torch.isfinite(gg).all().item()), f"train parity {cfg.name}: {k} grad "
                                                     f"not finite")
        if k.split("/")[-1] in ZERO_GRAD:
            noise = max(gg.abs().max().item(), gc_.abs().max().item()) / largest
            check(noise <= TRAIN_GRAD_RTOL, f"train parity {cfg.name}: {k} grad {noise} of "
                                            f"the largest, where it is 0")
            continue
        scale = gc_.abs().max().item()
        rel[k] = (gg - gc_).abs().max().item() / max(scale, 1e-30)
        check(gg.abs().max().item() > 0, f"train parity {cfg.name}: {k} grad all zero")
    worst = max(rel, key=rel.get)
    check(loss_err <= TRAIN_LOSS_TOL and rel[worst] <= TRAIN_GRAD_RTOL,
          f"train parity {cfg.name}: loss err {loss_err} (tol {TRAIN_LOSS_TOL}), grad "
          f"{worst} off by {rel[worst]} of its max (tol {TRAIN_GRAD_RTOL})")
    return {"layers": layers, "batch": B, "seq": S, "loss_card": loss_g.item(),
            "loss_cpu": loss_c.item(), "loss_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
            "grad_rel_err": rel, "worst_grad": worst, "grad_rtol": TRAIN_GRAD_RTOL,
            "launches": launches, "seconds": time.perf_counter() - t0}


def _train_family(torch, card, arch):
    """``arch`` at full width and depth through ``Trainer.fit`` under the
    futurized plan at ``TRAIN_WIDE`` tokens a step (8 microbatches of one
    2048-token sequence), fp32 masters and moments, bf16 compute: 2 steps,
    exact launches, finite loss and grad norm, step times, tokens/s, peak;
    then one step more as the train step runs it (the microbatches'
    grads, then AdamW, CUDA events between), and again under
    torch.profiler: forward + backward against AdamW and the device-busy
    share.  Returns the report; its launches are the 2 steps'."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.dist.plan import get_plan
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config(arch)
    B, S, n_mb = TRAIN_WIDE
    steps = 2
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    dcfg = DataConfig(batch_size=B, seq_len=S, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, plan=get_plan("futurized", microbatches=n_mb))
    tr = Trainer(model, opt, dcfg, TrainConfig(steps=steps, log_every=1), rng_seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tr.params.values())
    hist, step_s = [], []
    ops.reset_launch_counts()  # ← the training path starts here
    for _ in range(steps):
        t0 = time.perf_counter()
        hist += tr.fit(1)
        step_s.append(time.perf_counter() - t0)
    launches = ops.launch_counts()  # ← and ends here
    peak = torch.cuda.max_memory_allocated()
    per_mb = _microbatch_launches(cfg, cfg.num_layers)
    _check_launches(f"train {arch}", launches,
                    {k: n * n_mb * steps for k, n in per_mb.items()})
    check(len(hist) == steps and all(math.isfinite(h["loss"]) and
                                     math.isfinite(h["grad_norm"]) for h in hist),
          f"train {arch}: loss or grad norm not finite: {hist}")
    batch = {k: v.cuda() for k, v in synth_batch(cfg, dcfg, 10 ** 6).items()}
    splits = []

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        _, grads = step_mod._microbatch_grads(model.loss, tr.params, batch, n_mb)
        ev[1].record()
        tr.params, tr.opt_state, _ = adamw.update(opt, tr.params, grads, tr.opt_state)
        ev[2].record()
        del grads
        torch.cuda.synchronize()
        splits.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))

    prof = _device_profile(torch, step, 1)
    fb, ad = splits[0]  # the step outside the profiler
    p50 = statistics.median(step_s)
    out = {"card": card, "arch": arch, "layers": cfg.num_layers, "params": n_params,
           "batch": B, "seq": S, "microbatches": n_mb, "tokens_per_step": B * S,
           "plan": "futurized", "history": hist, "step_s": step_s, "step_p50_s": p50,
           "tokens_per_s": B * S / p50, "setup_s": setup_s,
           "max_memory_allocated_bytes": peak, "launches": launches,
           "launches_per_microbatch": per_mb,
           "split_ms": {"forward_backward": fb, "adamw": ad, "adamw_share": ad / (fb + ad)},
           "profile_one_step": prof}
    busy = ("device time not measured (the profiler saw none)" if prof["device_ms"] is None
            else f"device busy {prof['device_ms']:.1f} ms ({100 * prof['busy_share']:.1f}%), "
                 f"{prof['kernels_per_call']:.0f} kernels, kinds "
                 f"{ {g: round(t, 1) for g, t in prof['groups_ms'].items()} }")
    log(f"[train {arch}] {card}: {n_params / 1e9:.2f} B params, {cfg.num_layers} layers, "
        f"{B * S} tokens a step ({n_mb} microbatches of S={S}), futurized: losses "
        f"{[round(h['loss'], 4) for h in hist]}; steps "
        f"{[round(t * 1e3, 1) for t in step_s]} ms, p50 {p50 * 1e3:.1f} ms, "
        f"{B * S / p50:.0f} tokens/s; max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    log(f"[train {arch}] one step: wall {prof['wall_ms']:.1f} ms, {busy}; device clock: "
        f"forward + backward {fb:.1f} ms, AdamW {ad:.1f} ms ({100 * ad / (fb + ad):.1f}%)")
    tr.close()
    del tr, model, batch
    return out


def phase_train_families(torch, np, card, families=TRAIN_FAMILIES, key="train_families"):
    """Phase 8c (and 8d with ``TRAIN_ENCDEC_VLM``): each family first held
    card against CPU at full width and a few layers, then trained at full
    width and depth (``_train_family``).  Exact launches a microbatch: 32
    flash (granite_moe_3b_a800m), 48 SSD (mamba2_780m), 18 RG-LRU forward
    + 18 backward and 8 flash (recurrentgemma_2b); 24 flash for
    whisper_small (12 non-causal in its encoder over ``seq_len`` frames,
    12 causal) and for internvl2_2b.  Reported under ``key``; returns the
    launches summed over the training paths."""
    import repro_torch.core as core
    from repro_torch.configs import get_config

    out, total = {}, {}
    core.init(pools={"default": 4, "io": 1})
    try:
        for arch, layers in families:
            parity = _train_family_parity(torch, get_config(arch), layers)
            log(f"[train parity] {arch} ({layers} layers, B={parity['batch']}, "
                f"S={parity['seq']}) float32: loss {parity['loss_card']:.6f} (err "
                f"{parity['loss_err']:.3g}, tol {TRAIN_LOSS_TOL}); worst grad "
                f"{parity['worst_grad']} off by {parity['grad_rel_err'][parity['worst_grad']]:.3g}"
                f" of its max (tol {TRAIN_GRAD_RTOL}); launches {parity['launches']}")
            gc.collect()
            torch.cuda.empty_cache()
            run = _train_family(torch, card, arch)
            run["parity"] = parity
            out[arch] = run
            for k, n in run["launches"].items():
                total[k] = total.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        core.finalize()
    REPORT[key] = out
    return total


CHECKPOINT_DIR = []  # phase 8's 2-layer checkpoint, restored by phase 12


@contextlib.contextmanager
def _kept_dir():
    """A temporary directory that outlives its block: phase 12 removes it."""
    import tempfile

    CHECKPOINT_DIR.append(tempfile.TemporaryDirectory())
    yield CHECKPOINT_DIR[-1].name


def phase_train_checkpoint(torch, np):
    """Checkpoint on the card at full width and 2 layers (the full state is
    51 GB): two steps with an async checkpoint after the second, a new
    trainer resumed from it (params, moments and step equal), then the
    next step on both from the same state: the same loss."""
    import tempfile

    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = replace(get_config("starcoder2_3b"), num_layers=2)
    opt = adamw.AdamWConfig(**TRAIN_OPT)
    dcfg = DataConfig(batch_size=1, seq_len=64, seed=SEED)
    core.init(pools={"default": 4, "io": 1})
    try:
        with _kept_dir() as d:  # kept for phase 12, which restores it onto a mesh
            t0 = time.perf_counter()
            tr = Trainer(Model(cfg), opt, dcfg,
                         TrainConfig(steps=2, log_every=1, ckpt_every=2, ckpt_dir=d),
                         rng_seed=SEED)
            tr.fit()  # joins the async write of step 2
            tr2 = Trainer(Model(cfg), opt, dcfg,
                          TrainConfig(steps=1, log_every=1, ckpt_dir=d), rng_seed=SEED + 1)
            check(tr2.resume() == 2, "checkpoint: resumed at the wrong step")
            for name, a, b in (("params", tr.params, tr2.params),
                               ("m", tr.opt_state["m"], tr2.opt_state["m"]),
                               ("v", tr.opt_state["v"], tr2.opt_state["v"])):
                check(a.keys() == b.keys() and all(
                    b[k].device.type == "cuda" and torch.equal(a[k], b[k]) for k in a),
                      f"checkpoint: restored {name} differ")
            check(int(tr2.opt_state["step"]) == 2, "checkpoint: optimizer step")
            nxt, resumed = tr.fit(1)[0], tr2.fit(1)[0]
            check(nxt["step"] == resumed["step"] == 3 and
                  abs(nxt["loss"] - resumed["loss"]) <= 1e-6,
                  f"checkpoint: resumed step {resumed} vs {nxt}")
            REPORT["train_checkpoint"] = {"layers": 2, "next_step": nxt,
                                          "resumed_step": resumed,
                                          "seconds": time.perf_counter() - t0}
            log(f"[train checkpoint] 2 layers: saved async at step 2, resumed equal; "
                f"step 3 loss {resumed['loss']:.6f} (uninterrupted {nxt['loss']:.6f}), "
                f"{time.perf_counter() - t0:.1f} s")
            tr2.close()  # the record both trainers bound in turn
            del tr, tr2
    finally:
        core.finalize()


# ------------------------------------------------------------------ phase 9
# The HPX local runtime on the card.  (a) The fourteen parallel algorithms
# of ``core.algorithms`` (reduce and both scans also under a non-add op,
# ``_maximum``) under ``vec`` on CUDA tensors of STREAM_N elements, int64
# and fp32 drawn from the seed with numpy; each result held against the
# port's ``vec`` over the same data on the CPU: integers, orderings,
# extrema and predicates exact; fp32 sums and scans within
# RUNTIME_SUM_RTOL of the sum of the magnitudes each output adds (the
# card's sums run as fp32 trees, the CPU's cumsum accumulates in fp64, so
# an output near 0 after cancellation differs by more than itself); then
# each against ``seq`` and ``par`` (and ``par_task`` / ``vec`` with
# ``task`` returning futures) over the first RUNTIME_HOST_N elements as a
# host list, whose floats add in fp64 (so ``transform`` too is held to
# the limit there).  Each ``vec`` algorithm timed on the device with
# ``_time_ms`` (L2 flushed, a spin kernel covering the host's enqueue, so
# a lowering of many small kernels reads its device time, not the host's
# launch gaps) after the CPU's results are in (their pool threads would
# otherwise share the host with the card's launches), GB/s beside phase
# 7's triad, and its wall time a call ending in a synchronize (report
# only).  count_if, all_of and any_of return host numbers, so their
# device window also holds one round trip to the host.  (b) Parcels and migration at
# full width: full starcoder2_3b's compute params in AGAS, a parcel that
# takes their global norm where they live, a migration to the host and
# back; ``save_gid`` / ``restore_gid`` of phase 8's 2-layer training state.
# (c) The dataflow 1F1B pipeline (``train/pipeline.py``) over full
# starcoder2_3b, PIPE_STAGES stages by ``split_stages``, PIPE_MB
# microbatches of one PIPE_SEQ-token sequence.
RUNTIME_HOST_N = 2 ** 16
RUNTIME_SUM_RTOL = 1e-5
RUNTIME_REPS = 10                           # timed calls of each vec algorithm
PIPE_STAGES, PIPE_MB, PIPE_SEQ = 4, 4, 512
PIPE_CHECK_LAYERS = 4                       # one layer a stage for check (i)
PIPE_TOL = 1e-5                             # of each tensor's largest, fp32
RUNTIME_NAME = "/chip_smoke/runtime/starcoder2_3b"


def _maximum(a, b):
    """The non-add op of phase 9's reductions and scans: elementwise on
    tensors (``vec``), Python's ``max`` on host numbers (``seq``, ``par``)."""
    import torch

    return torch.maximum(a, b) if isinstance(a, torch.Tensor) else max(a, b)


def _global_norm(obj):
    """Phase 9's parcel action: the fp32 L2 norm over every tensor of the
    object, computed where the tensors live."""
    import torch

    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t, dtype=torch.float32) for t in obj.values()]))


def _runtime_algos():
    """(name, call(alg, policy, data), bytes moved in units of n·itemsize,
    "sum" where the output adds values up)."""
    return (
        ("for_each", lambda a, p, d: a.for_each(p, d, lambda x: x * 2), 1, None),
        ("transform", lambda a, p, d: a.transform(p, d, lambda x: 3 * x + 1), 2, "transform"),
        ("reduce", lambda a, p, d: a.reduce(p, d, init=5), 1, "sum"),
        ("reduce_max", lambda a, p, d: a.reduce(p, d, init=-10 ** 4, op=_maximum), 1, None),
        ("transform_reduce", lambda a, p, d: a.transform_reduce(p, d, lambda x: x * x), 1,
         "sum"),
        ("inclusive_scan", lambda a, p, d: a.inclusive_scan(p, d), 2, "sum"),
        ("inclusive_scan_max", lambda a, p, d: a.inclusive_scan(p, d, op=_maximum), 2, None),
        ("exclusive_scan", lambda a, p, d: a.exclusive_scan(p, d, init=7), 2, "sum"),
        ("exclusive_scan_max",
         lambda a, p, d: a.exclusive_scan(p, d, init=-10 ** 4, op=_maximum), 2, None),
        ("sort", lambda a, p, d: a.sort(p, d), 2, None),
        ("count_if", lambda a, p, d: a.count_if(p, d, lambda x: x > 0), 1, None),
        ("all_of", lambda a, p, d: a.all_of(p, d, lambda x: x > -2000), 1, None),
        ("any_of", lambda a, p, d: a.any_of(p, d, lambda x: x > 0.999), 1, None),
        ("fill", lambda a, p, d: a.fill(p, d, 3), 1, None),
        ("min_element", lambda a, p, d: a.min_element(p, d), 1, None),
        ("max_element", lambda a, p, d: a.max_element(p, d), 1, None),
        ("copy", lambda a, p, d: a.copy(p, d), 2, None),
    )


def _sum_scale(torch, name, mag):
    """What an output adds up, in magnitudes (``mag`` = |x| in fp64 on the
    CPU): the limit of a fp32 sum or scan is RUNTIME_SUM_RTOL of it."""
    if name == "reduce":
        return 5 + mag.sum()
    if name == "transform_reduce":
        return (mag * mag).sum()
    if name == "inclusive_scan":
        return torch.cumsum(mag, 0)
    if name == "exclusive_scan":
        return 7 + torch.cat([mag.new_zeros(1), torch.cumsum(mag, 0)[:-1]])
    return 3 * mag + 1  # transform, where the host's fp64 meets fp32


def _host_value(torch, x):
    """An algorithm's result as host values: a Future's value, a tensor's
    elements (fp64 for floats), lists and numbers as they are."""
    from repro_torch.core.future import Future

    if isinstance(x, Future):
        x = x.get(timeout=600)
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return x.double() if x.is_floating_point() else x
    if isinstance(x, (list, int, float)) and not isinstance(x, bool):
        floats = any(isinstance(v, float) for v in (x if isinstance(x, list) else [x]))
        return torch.tensor(x, dtype=torch.float64 if floats else torch.int64)
    return x


def _held(torch, got, want, kind, mag, name, what):
    """Exact, or within RUNTIME_SUM_RTOL of the magnitudes added where
    ``kind`` names a sum over floats."""
    got, want = _host_value(torch, got), _host_value(torch, want)
    if not isinstance(want, torch.Tensor):  # None (for_each), a bool (all_of, any_of)
        check(got is want, f"runtime: {what} {name}: {got} vs {want}")
        return 0.0
    check(got.shape == want.shape, f"runtime: {what} {name}: shape {tuple(got.shape)} "
                                   f"vs {tuple(want.shape)}")
    if kind is None or not want.is_floating_point():
        check(torch.equal(got.to(want.dtype), want), f"runtime: {what} {name} differs")
        return 0.0
    scale = _sum_scale(torch, name, mag)
    err = ((got.double() - want.double()).abs() / scale).max().item()
    check(err <= RUNTIME_SUM_RTOL, f"runtime: {what} {name} off by {err:.3g} of the "
                                   f"magnitudes it adds (limit {RUNTIME_SUM_RTOL})")
    return err


def _runtime_algorithms(torch, np, rt):
    """Phase 9(a): see the block comment above."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.executor import par, par_task, seq, vec
    from repro_torch.core.future import Future

    rng = np.random.default_rng(SEED + 9)
    data = {"int64": torch.from_numpy(rng.integers(-1000, 1000, size=STREAM_N)),
            "float32": torch.from_numpy(rng.uniform(-1.0, 1.0, size=STREAM_N)
                                        .astype(np.float32))}
    # the CPU's vec results, as tasks on the runtime's pool, the two sorts
    # (each one thread's work for ~10-25 s) queued first; all in before
    # the card is timed
    t0 = time.perf_counter()
    cpu_vec = vec.on(rt.get_executor("default")).with_(task=True)
    jobs = sorted(((dt, name, call) for dt in data for name, call, _, _ in _runtime_algos()),
                  key=lambda job: job[1] != "sort")
    refs = {(dt, name): call(alg, cpu_vec, data[dt]) for dt, name, call in jobs}
    refs = {k: f.get(timeout=600) for k, f in refs.items()}
    out = {"N": STREAM_N, "host_cut": RUNTIME_HOST_N, "sum_rtol": RUNTIME_SUM_RTOL,
           "reps": RUNTIME_REPS, "cpu_reference_s": time.perf_counter() - t0,
           "card": {}, "worst_sum_err": {}}
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for dt, x in data.items():
        gpu = x.cuda()
        mag = x.abs().double()
        host = x[:RUNTIME_HOST_N].tolist()
        hmag = mag[:RUNTIME_HOST_N]
        for name, call, units, kind in _runtime_algos():
            got = call(alg, vec, gpu)  # the first call: vmap's set-up
            torch.cuda.synchronize()
            if isinstance(got, torch.Tensor):
                check(got.device.type == "cuda", f"runtime: vec {name} left the card")
            ms = _time_ms(torch, lambda: call(alg, vec, gpu), flush, reps=RUNTIME_REPS)
            wall = []
            for _ in range(3):
                t0 = time.perf_counter()
                call(alg, vec, gpu)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            nbytes = units * STREAM_N * x.element_size()
            err = _held(torch, got, refs[(dt, name)], kind, mag, name, f"card vs CPU {dt}")
            del got
            # the host cut: seq, par and par_task over a host list, vec
            # (eager and task) over the card's first elements
            want = call(alg, seq, list(host))
            vec_cut = call(alg, vec, gpu[:RUNTIME_HOST_N])
            _held(torch, vec_cut, want, kind, hmag, name, f"vec vs seq {dt}")
            _held(torch, call(alg, par, list(host)), want, kind, hmag, name, f"par vs seq {dt}")
            fut = call(alg, par_task, list(host))
            check(isinstance(fut, Future), f"runtime: par_task {name} returned {type(fut)}")
            _held(torch, fut, want, kind, hmag, name, f"par_task vs seq {dt}")
            fut = call(alg, vec.with_(task=True), gpu[:RUNTIME_HOST_N])
            check(isinstance(fut, Future), f"runtime: vec task {name} returned {type(fut)}")
            _held(torch, fut, vec_cut, kind, hmag, name, f"vec task vs vec {dt}")
            out["card"][f"{name} {dt}"] = {"ms": ms, "bytes": nbytes,
                                           "GB_per_s": nbytes / ms / 1e6,
                                           "wall_ms": statistics.median(wall)}
            if kind == "sum":
                out["worst_sum_err"][f"{name} {dt}"] = err
        check(torch.equal(gpu.cpu(), x), f"runtime: an algorithm wrote into its {dt} input")
        del gpu
    del refs
    stream = REPORT.get("stream", {})
    out["triad_GB_per_s"] = stream.get("float32", {}).get("GB_per_s")
    out["torch_add_GB_per_s"] = stream.get("native_float32", {}).get("GB_per_s")
    return out


def _runtime_parcels(torch, params):
    """Phase 9(b), parcels and migration: the params in AGAS, a parcel
    taking their global norm where they live (equal to the direct
    computation; the port's counters step by one), then a migration to
    the host and back: generations 0 → 1 → 2, the GID kept, every leaf
    bit-equal, GB/s each way."""
    from repro_torch.core import agas, counters, migration, parcel

    a = agas.default()
    gid = a.register_name(RUNTIME_NAME, params, replace=True)
    port = parcel.default_port()
    names = ("/parcel{port#0}/count/sent", "/parcel{port#0}/actions/executed")
    before = [counters.get_value(n) for n in names]
    want = _global_norm(params)
    got = parcel.apply(_global_norm, RUNTIME_NAME).get(timeout=300)
    after = [counters.get_value(n) for n in names]
    check(got.device.type == "cuda" and torch.equal(got, want),
          f"runtime: the parcel's norm {got} vs the direct {want}")
    check(after == [b + 1 for b in before], f"runtime: parcel counters {before} → {after}")
    check(a.record(gid).generation == 0, "runtime: a fresh record's generation")
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen1 = migration.migrate(gid, "cpu")
    d2h = time.perf_counter() - t0
    rec = a.record(gid)
    check(gen1 == 1 and rec.gid == gid and rec.generation == 1 and
          all(t.device.type == "cpu" for t in rec.obj.values()),
          f"runtime: migration to the host: generation {gen1}")
    t0 = time.perf_counter()
    gen2 = migration.migrate(RUNTIME_NAME, "cuda")
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    rec = a.record(RUNTIME_NAME)
    check(gen2 == 2 and rec.gid == gid and rec.generation == 2 and
          rec.obj.keys() == params.keys() and
          all(v.device.type == "cuda" and torch.equal(v, params[k])
              for k, v in rec.obj.items()),
          f"runtime: migration back to the card: generation {gen2}, leaves differ")
    a.unregister(gid)
    del rec
    return {"params": len(params), "bytes": nbytes, "norm": got.item(),
            "parcel_counters": dict(zip(names, after)), "generations": [0, gen1, gen2],
            "to_host_s": d2h, "to_host_GB_per_s": nbytes / d2h / 1e9,
            "to_card_s": h2d, "to_card_GB_per_s": nbytes / h2d / 1e9}


def _runtime_gid_checkpoint(torch):
    """Phase 9(b), checkpoints by GID: phase 8's 2-layer training state
    after one step, registered by its trainer, saved by name under
    ``TMPDIR``; the trainer closed (its record gone), then restored: the
    old name, a new GID, every leaf bit-equal; migrated back to the card
    under the same GID."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import agas, migration
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = replace(get_config("starcoder2_3b"), num_layers=2)
    tr = Trainer(Model(cfg), adamw.AdamWConfig(**TRAIN_OPT),
                 DataConfig(batch_size=1, seq_len=64, seed=SEED),
                 TrainConfig(steps=1, log_every=1), rng_seed=SEED)
    tr.fit()
    a = agas.default()
    name, old = f"/train/state/{cfg.name}", tr.gid
    state = tr.state()
    flat = ckpt._flatten(state)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save_gid(d, 1, name)
        save_s = time.perf_counter() - t0
        tr.close()
        check(not a.contains(name), "runtime: the trainer's record outlived close()")
        t0 = time.perf_counter()
        step, gid = ckpt.restore_gid(d)
        restore_s = time.perf_counter() - t0
    check(step == 1 and gid != old and a.gid_of(name) == gid,
          f"runtime: restore_gid gave step {step}, GID {gid} (was {old})")
    gen = migration.migrate(gid, "cuda")
    back = ckpt._flatten(a.resolve(gid))
    check(gen == 1 and back.keys() == flat.keys() and
          all(back[k].device.type == "cuda" and torch.equal(back[k], flat[k]) for k in flat),
          "runtime: the GID checkpoint did not restore bit-equal")
    a.unregister(gid)
    leaves = len(flat)
    del tr, state, flat, back
    return {"layers": 2, "leaves": leaves, "bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "old_gid": str(old), "new_gid": str(gid)}


def _stage_fns(cfg, n_stages):
    """The pipeline's stage functions, from the model's own pieces: stage
    0 embeds (``layers.embed``), every stage runs its layers
    (``transformer._layer_body``), the last norms and unembeds
    (``transformer.logits``)."""
    import torch

    from repro_torch.models import layers as Lx
    from repro_torch.models import transformer as T

    def make(s):
        def fn(p, x):
            if s == 0:
                x = Lx.embed(cfg, p["tok_embed"], x)
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
            for lp in p["layers"]:
                x, _, _ = T._layer_body(cfg, x, lp, positions)
            return T.logits(cfg, p, x) if s == n_stages - 1 else x
        return fn

    return [make(s) for s in range(n_stages)]


def _stage_params(cfg, params, n_stages):
    """Each stage's params: its layers' slices (``unbind_layers``, split by
    ``split_stages``), the embedding on stage 0, the final norm and
    ``lm_head`` on the last."""
    from repro_torch.models import transformer as T
    from repro_torch.train.pipeline import split_stages

    groups = split_stages(T.unbind_layers(params, cfg.num_layers), n_stages)
    out = [{"layers": g} for g in groups]
    out[0]["tok_embed"] = params["tok_embed"]
    out[-1]["final_ln"], out[-1]["lm_head"] = params["final_ln"], params["lm_head"]
    return out


def _monolithic(torch, cfg, sp, tokens):
    """One autograd pass of the same stage functions over the whole batch:
    (loss, every stage's grads as flat lists, in the pipeline's leaf
    order)."""
    from repro_torch.models import layers as Lx
    from repro_torch.train.pipeline import _leaves, _tree_map

    leaves = [_tree_map(lambda t: t.detach().requires_grad_(), p) for p in sp]
    x = tokens[:, :-1]
    for fn, p in zip(_stage_fns(cfg, len(sp)), leaves):
        x = fn(p, x)
    loss = Lx.cross_entropy(x, tokens[:, 1:])
    flat = [_leaves(p) for p in leaves]
    grads = torch.autograd.grad(loss, [t for f in flat for t in f])
    out, i = [], 0
    for f in flat:
        out.append(list(grads[i:i + len(f)]))
        i += len(f)
    return loss.detach(), out


def _pipeline_step(torch, cfg, sp, tokens):
    """One step of the dataflow 1F1B pipeline over ``tokens`` (B = PIPE_MB
    sequences, one a microbatch): (loss, every stage's grads), both read."""
    from repro_torch.models import layers as Lx
    from repro_torch.train.pipeline import pipeline_value_and_grad

    mbs = [(tokens[m:m + 1, :-1], tokens[m:m + 1, 1:]) for m in range(tokens.shape[0])]
    loss_f, grad_fs = pipeline_value_and_grad(_stage_fns(cfg, len(sp)), Lx.cross_entropy,
                                              sp, mbs)
    return loss_f.get(timeout=600), [g.get(timeout=600) for g in grad_fs]


def _pipeline_tokens(cfg, step):
    from repro_torch.data.pipeline import DataConfig, synth_batch

    return synth_batch(cfg, DataConfig(batch_size=PIPE_MB, seq_len=PIPE_SEQ, seed=SEED),
                       step)["tokens"].cuda()


def _runtime_pipeline(torch, np, card, params):
    """Phase 9(c): (i) fp32 at full width, PIPE_CHECK_LAYERS layers one a
    stage: the pipeline's loss and every stage's grads against one
    monolithic autograd pass (PIPE_TOL of each tensor's largest), exactly
    2·S·M + M tasks and layers × M flash launches; (iv) the full 30 layers
    in bf16, two steps (the first a warm-up) with exactly layers × M flash
    launches each: finite loss and grads, the step's wall time, peak
    memory and a profiled step, beside one monolithic pass of the same
    work.  Returns the 30-layer steps' launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import counters
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.train.pipeline import _leaves

    tasks = counters.counter("/pipeline{1f1b}/tasks/cumulative")
    S, M = PIPE_STAGES, PIPE_MB

    # (i) fp32, full width, one layer a stage
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("starcoder2_3b")
    c4 = replace(cfg, num_layers=PIPE_CHECK_LAYERS, dtype="float32")
    sp = _stage_params(c4, Model(c4).init(SEED), S)
    tokens = _pipeline_tokens(c4, 0)
    before = tasks.get_value()
    ops.reset_launch_counts()
    loss, grads = _pipeline_step(torch, c4, sp, tokens)
    launches = ops.launch_counts()
    check_tasks = tasks.get_value() - before
    want_loss, want = _monolithic(torch, c4, sp, tokens)
    check(check_tasks == 2 * S * M + M,
          f"pipeline: {check_tasks} tasks ran, not {2 * S * M + M}")
    _check_launches("pipeline fp32", launches, {"flash_attention": PIPE_CHECK_LAYERS * M})
    loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    worst = 0.0
    for s in range(S):
        got = _leaves(grads[s])
        check(len(got) == len(want[s]), f"pipeline: stage {s}'s grads")
        for g, w in zip(got, want[s]):
            worst = max(worst, (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30))
    check(loss_err <= PIPE_TOL and worst <= PIPE_TOL,
          f"pipeline fp32: loss off by {loss_err:.3g}, worst grad by {worst:.3g} of its "
          f"largest (limit {PIPE_TOL})")
    del sp, grads, want
    gc.collect()
    torch.cuda.empty_cache()

    # (iv) the full model in bf16
    L = cfg.num_layers
    sp = _stage_params(cfg, params, S)
    tokens = _pipeline_tokens(cfg, 1)

    def step():
        loss, grads = _pipeline_step(torch, cfg, sp, tokens)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32)
             for gs in grads for g in _leaves(gs)]))
        return loss.item(), norm.item()

    before = tasks.get_value()
    ops.reset_launch_counts()  # ← phase 9's main path starts here
    first = step()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    second = step()
    step_s = time.perf_counter() - t0
    path_launches = ops.launch_counts()  # ← and ends here
    peak = torch.cuda.max_memory_allocated()
    ran = tasks.get_value() - before
    check(ran == 2 * (2 * S * M + M), f"pipeline: {ran} tasks in two steps")
    _check_launches("pipeline", path_launches, {"flash_attention": 2 * L * M})
    check(all(math.isfinite(v) for v in first + second),
          f"pipeline: loss or grad norm not finite: {first}, {second}")
    gc.collect()
    prof = _device_profile(torch, step, 1)

    def mono():
        loss, grads = _monolithic(torch, cfg, sp, tokens)
        return loss.item()

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mono_loss = mono()
    torch.cuda.synchronize()
    mono_s = time.perf_counter() - t0
    mono_peak = torch.cuda.max_memory_allocated()
    mono_prof = _device_profile(torch, mono, 1)
    check(abs(mono_loss - second[0]) <= TRAIN_BF16_LOSS_TOL,
          f"pipeline: bf16 loss {second[0]} vs monolithic {mono_loss}")
    del sp
    return {"check": {"layers": PIPE_CHECK_LAYERS, "dtype": "float32", "tasks": check_tasks,
                      "loss_rel_err": loss_err, "worst_grad_err": worst, "tol": PIPE_TOL,
                      "launches": launches},
            "layers": L, "stages": S, "microbatches": M, "seq": PIPE_SEQ,
            "stage_layers": [len(p["layers"]) for p in _stage_params(cfg, params, S)],
            "losses": [first[0], second[0]], "grad_norms": [first[1], second[1]],
            "tasks_two_steps": ran, "step_s": step_s, "tokens_per_s": M * PIPE_SEQ / step_s,
            "peak_bytes": peak, "launches": path_launches, "profile_one_step": prof,
            "monolithic": {"loss": mono_loss, "step_s": mono_s, "peak_bytes": mono_peak,
                           "profile": mono_prof}}


def phase_runtime(torch, np, card):
    """Phase 9, the HPX local runtime on the card: (a) the parallel
    algorithms (``_runtime_algorithms``), (b) parcels, migration and
    checkpoints by GID over full starcoder2_3b (``_runtime_parcels``,
    ``_runtime_gid_checkpoint``), (c) the dataflow 1F1B pipeline over full
    starcoder2_3b (``_runtime_pipeline``).  Returns the pipeline's
    launches."""
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rt = core.init(pools={"default": 4, "io": 1})
    try:
        t0 = time.perf_counter()
        algos = _runtime_algorithms(torch, np, rt)
        algos["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = Model(get_config("starcoder2_3b")).init_compute(SEED)
        parcels = _runtime_parcels(torch, params)
        gid_ckpt = _runtime_gid_checkpoint(torch)
        parcels["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pipe = _runtime_pipeline(torch, np, card, params)
        pipe["seconds"] = time.perf_counter() - t0
        del params
    finally:
        core.finalize()
        gc.collect()
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    REPORT["runtime"] = {"card": card, "seconds": secs, "algorithms": algos,
                         "parcels": parcels, "gid_checkpoint": gid_ckpt, "pipeline": pipe}
    rates = {k: round(v["GB_per_s"], 1) for k, v in algos["card"].items()}
    walls = {k: round(v["wall_ms"], 3) for k, v in algos["card"].items()}
    log(f"[runtime] {card}: vec algorithms at N = 2^27 on the card, device GB/s (in + out): "
        f"{rates}; wall ms a call: {walls}; CPU reference "
        f"{algos['cpu_reference_s']:.1f} s; triad {algos['triad_GB_per_s']}, torch.add "
        f"{algos['torch_add_GB_per_s']}; worst fp32 sum error "
        f"{max(algos['worst_sum_err'].values()):.3g} of the magnitudes added; "
        f"{algos['seconds']:.1f} s")
    log(f"[runtime] parcel: global norm {parcels['norm']:.6g} at the object; migration of "
        f"{parcels['bytes'] / 1e9:.2f} GB: to the host {parcels['to_host_GB_per_s']:.2f} GB/s, "
        f"back {parcels['to_card_GB_per_s']:.2f} GB/s, generations "
        f"{parcels['generations']}; GID checkpoint {gid_ckpt['bytes'] / 1e9:.2f} GB: save "
        f"{gid_ckpt['save_s']:.1f} s, restore {gid_ckpt['restore_s']:.1f} s, GID "
        f"{gid_ckpt['old_gid']} → {gid_ckpt['new_gid']}")
    busy = ("device time not measured (the profiler saw none)"
            if pipe["profile_one_step"]["device_ms"] is None else
            f"device busy {100 * pipe['profile_one_step']['busy_share']:.1f}%, "
            f"{pipe['profile_one_step']['kernels_per_call']:.0f} kernels a step")
    mb = pipe["monolithic"]["profile"]
    mbusy = ("not measured" if mb["device_ms"] is None else
             f"busy {100 * mb['busy_share']:.1f}%, {mb['kernels_per_call']:.0f} kernels")
    log(f"[runtime] pipeline fp32 {PIPE_CHECK_LAYERS} layers: loss off by "
        f"{pipe['check']['loss_rel_err']:.3g}, worst grad {pipe['check']['worst_grad_err']:.3g}"
        f" of its largest; {pipe['check']['tasks']} tasks")
    log(f"[runtime] pipeline {pipe['layers']} layers in {pipe['stage_layers']}, "
        f"{pipe['microbatches']} × {pipe['seq']} tokens, bf16: losses "
        f"{[round(v, 4) for v in pipe['losses']]}; step {pipe['step_s'] * 1e3:.1f} ms "
        f"({pipe['tokens_per_s']:.0f} tokens/s), {busy}, peak "
        f"{pipe['peak_bytes'] / 2**30:.2f} GiB; launches {pipe['launches']}; monolithic "
        f"{pipe['monolithic']['step_s'] * 1e3:.1f} ms, {mbusy}, peak "
        f"{pipe['monolithic']['peak_bytes'] / 2**30:.2f} GiB; phase {secs:.1f} s")
    return pipe["launches"]


# ----------------------------------------------------------------- phase 10
LOC_POOLS = {"default": 4, "prefill": 2, "io": 1}
LOC_REQS = 12                 # requests of each run: 8 fill the slots, 4 queue
LOC_MAX_NEW = 32              # halved from 64: the whole script's time limit
LOC_MIGRATE_AFTER = 8         # tokens every active stream holds before the cutover
LOC_TRACED_REQS = 9           # the traced run of (e), three to an engine
ENGINE_PREFIX = "/engines/"
# A locality's engines kept reachable after they leave AGAS (a migration's
# husk), so that the launch counts of the process can still be accounted.
_HELD = {}


def _loc_engines():
    """This locality's engines: those named ``/engines/<name>`` in AGAS, and
    the held ones."""
    from repro_torch.core import agas

    found = {}
    for rec in list(agas.default()):
        if rec.name and rec.name.startswith(ENGINE_PREFIX):
            found[id(rec.obj)] = (rec.name[len(ENGINE_PREFIX):], rec.obj)
    for name, eng in _HELD.items():
        found.setdefault(id(eng), (name, eng))
    return list(found.values())


def _loc_hold(rt, name):
    """At a locality: keep its engine ``name`` reachable once it leaves AGAS."""
    from repro_torch.core import agas

    _HELD[name] = agas.resolve(ENGINE_PREFIX + name)
    return True


def _loc_reset(rt):
    """At a locality: launch counts and the peak-memory mark to 0."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    return True


def _loc_stats(rt):
    """At a locality: its kernel launches since ``_loc_reset``, its peak
    device memory, and each engine's prefills, decode steps and tokens."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    return {"launches": ops.launch_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "engines": {name: {"prefills": eng.prefill_count, "steps": eng.step_count,
                               "tokens": eng.c_tok.get_value(),
                               "step_s": eng.t_step.total}
                        for name, eng in _loc_engines()}}


def _kv_take(rt, name):
    """At the locality of engine ``name``: pause it at a step boundary,
    snapshot its first active slot (its live pages, to the host), resume."""
    from repro_torch.core import agas

    eng = agas.resolve(ENGINE_PREFIX + name)
    eng.pause()
    try:
        slot = next(i for i, r in enumerate(eng.slots) if r is not None)
        return eng.backend.snapshot_slot(slot)
    finally:
        eng.resume()


def _kv_roundtrip(rt, name, snap):
    """At another locality: restore ``snap`` into a free slot of engine
    ``name``'s page pool (an idle engine), snapshot that slot again, and
    free it."""
    from repro_torch.core import agas

    kv = agas.resolve(ENGINE_PREFIX + name).kv
    slot = next(i for i in range(kv.max_batch) if not kv._owned[i])
    check(kv.restore_slot(slot, snap), "localities (c): the pool cannot hold the slot")
    try:
        return kv.snapshot_slot(slot)
    finally:
        kv.release(slot)


def _loc_window(net, L, tag, body):
    """Run ``body()`` with every locality's launch counts set to 0 just
    before and read just after; each locality must have launched exactly
    L flash kernels a prefill and L paged decodes a decode step of its
    engines, and nothing else.  Returns (body's result, launches summed
    over the localities, {locality: stats after}, {locality: {engine:
    deltas}})."""
    from repro_torch import net as tnet

    def sweep(fn):
        futs = {lid: tnet.run_on(lid, fn) for lid in net.live_ids()}
        return {lid: f.get(timeout=300) for lid, f in futs.items()}

    sweep(_loc_reset)
    before = sweep(_loc_stats)
    result = body()
    after = sweep(_loc_stats)
    deltas, total = {}, {}
    for lid, st in after.items():
        was = before.get(lid, {"engines": {}})["engines"]
        d = {name: {k: v - was.get(name, {}).get(k, 0) for k, v in e.items()}
             for name, e in st["engines"].items()}
        deltas[lid] = d
        _check_launches(f"localities {tag} locality#{lid}", st["launches"],
                        {"flash_attention": L * sum(e["prefills"] for e in d.values()),
                         "paged_decode_attention": L * sum(e["steps"] for e in d.values())})
        for k, v in st["launches"].items():
            total[k] = total.get(k, 0) + v
    return result, total, after, deltas


def _stream_all(submit_stream, prompts):
    """Submit each prompt streamed; a thread drains each stream, stamping
    each token's arrival.  Returns (futures, tokens, stamps, threads)."""
    streams = [submit_stream(p) for p in prompts]
    toks = [[] for _ in prompts]
    stamps = [[] for _ in prompts]

    def drain(i, ch):
        for t in ch:
            toks[i].append(t)
            stamps[i].append(time.perf_counter())

    threads = [threading.Thread(target=drain, args=(i, ch), daemon=True)
               for i, (ch, _) in enumerate(streams)]
    for th in threads:
        th.start()
    return [f for _, f in streams], toks, stamps, threads


def _finish_streams(tag, futs, toks, threads, max_new, vocab):
    """Wait for every request; each must return max_new + 1 tokens in the
    vocab, streamed exactly as returned."""
    results = [f.get(timeout=900) for f in futs]
    for th in threads:
        th.join(timeout=60)
    for i, (res, streamed) in enumerate(zip(results, toks)):
        check(len(res) == max_new + 1, f"localities {tag}: request {i} has {len(res)} tokens")
        check(all(0 <= t < vocab for t in res),
              f"localities {tag}: request {i} has a token outside the vocab")
        check(streamed == res, f"localities {tag}: request {i} streamed {len(streamed)} "
              f"tokens unlike its result")
    return results


def _relay_total(name):
    from repro_torch.core import counters

    return sum(v for _, v in counters.query(f"/serve{{relay}}/tokens/{name}"))


def _loc_traced(net, router, prompts, cfg, L):
    """(e): a traced run over every engine of the fleet, its merged trace
    (clock-corrected), each request's critical path, the SLOW shares by the
    locality that served the request, decode-step p50 by locality, and one
    ``/metrics`` sweep held against ``query_counters``."""
    from repro_torch import net as tnet
    from repro_torch.net.httpd import http_get
    from repro_torch.obs import critical_path as cpm
    from repro_torch.obs import export
    from repro_torch.obs.metrics import MetricsExporter, parse_prometheus_text

    export.enable_fleet(net)
    export.clear_fleet(net)

    def run():
        t0 = time.perf_counter()
        futs, toks, _st, threads = _stream_all(router.submit_stream, prompts)
        res = _finish_streams("(e)", futs, toks, threads, LOC_MAX_NEW, cfg.vocab_size)
        return res, time.perf_counter() - t0

    try:
        (results, wall), launches, _after, deltas = _loc_window(net, L, "(e)", run)
        t0 = time.perf_counter()
        tr = export.merged_trace(net)
    finally:
        export.disable_fleet(net)
    check(not tr.get("lossy"), f"localities (e): rings wrapped: {tr.get('ring_drops')}")
    idx = cpm.TraceIndex(tr)
    tags = cpm.request_ids(idx)
    check(len(tags) == len(prompts), f"localities (e): {len(tags)} requests traced")
    home = {e["args"]["req"]: e["pid"] for e in tr["traceEvents"]
            if e["ph"] == "b" and e["name"] == "request"}
    by_loc, remote_latency, clamped = {}, [], []
    for tag in tags:
        cp = cpm.critical_path(idx, tag)
        check(cp is not None, f"localities (e): no critical path for {tag}")
        ivs = cp.intervals
        check(bool(ivs) and ivs[0].t0 == cp.t0 and ivs[-1].t1 == cp.t1
              and all(b.t0 == a.t1 for a, b in zip(ivs, ivs[1:])),
              f"localities (e): {tag}'s path leaves a gap in [{cp.t0}, {cp.t1}]")
        check(cp.clamped_us < 0.01 * cp.total_us,
              f"localities (e): {tag} clamps {cp.clamped_us:.1f} of {cp.total_us:.1f} µs")
        clamped.append(cp.clamped_us / cp.total_us)
        loc = home[tag]
        by_loc.setdefault(loc, []).append(_slow_shares(ivs, cp.t1))
        if loc != net.locality:
            check(len(cp.localities()) >= 2 and cp.by_class["L"] > 0,
                  f"localities (e): remote request {tag} has no latency segment")
            remote_latency.append(cp.by_class["L"] / cp.total_us)
    check(bool(remote_latency), "localities (e): no request was served remotely")
    steps = {}
    for e in tr["traceEvents"]:
        if e["ph"] == "X" and e["name"] == "decode_step":
            steps.setdefault(e["pid"], []).append(e["dur"] / 1e6)
    analysis_s = time.perf_counter() - t0

    with MetricsExporter(net=net, port=0) as ex:
        status, body = http_get(ex.url, timeout=120.0)
    check(status == 200, f"localities (e): /metrics answered {status}")
    fams = parse_prometheus_text(body, strict=True)
    scraped = {}
    for fam, what in (("repro_serve_tokens_generated_total", "tokens/generated"),
                      ("repro_serve_requests_completed_total", "requests/completed")):
        for _n, labels, v in fams.get(fam, {}).get("samples", []):
            scraped[(int(labels["locality"]), labels["engine"], what)] = v
    queried = {}
    for lid in net.live_ids():
        for name, v in tnet.query_counters(lid, "/serve{engine#*}/*"):
            eng, what = name[len("/serve{engine#"):].split("}/", 1)
            if what in ("tokens/generated", "requests/completed"):
                queried[(lid, eng, what)] = v
    check(scraped == queried and len(queried) >= 2 * len(net.live_ids()),
          f"localities (e): /metrics {scraped} != query_counters {queried}")
    ups = {labels["locality"]: v for _n, labels, v in fams["repro_up"]["samples"]}
    check(all(ups.get(str(lid)) == 1.0 for lid in net.live_ids()),
          f"localities (e): repro_up {ups}")

    def p50(rows):
        return {k: statistics.median(r[k] for r in rows) for k in rows[0]}

    return {"requests": len(tags), "wall_s": wall, "events": len(tr["traceEvents"]),
            "launches": launches, "engine_deltas": deltas,
            "slow_share_p50_by_locality": {loc: p50(rows) for loc, rows in sorted(by_loc.items())},
            "requests_by_locality": {loc: len(rows) for loc, rows in sorted(by_loc.items())},
            "latency_share_of_remote_requests": remote_latency,
            "max_clamped_fraction": max(clamped),
            "decode_step_p50_s_by_locality": {loc: statistics.median(v)
                                              for loc, v in sorted(steps.items())},
            "metrics": {"series": len(queried), "families": len(fams)},
            "analysis_s": analysis_s}


def phase_serve_localities(torch, np, card):
    """Phase 10, serving across localities: full starcoder2_3b in bf16 on
    every locality (seed 0, max_batch 8, cache_len 1024, pages of 16), each
    locality its own process with its own CUDA context on the one card.
    (a) ``Router.over_localities`` over two localities, 12 streamed greedy
    requests; (b) ``grow_engine`` adds locality 2, two unmigrated runs of
    12 requests straight to engine#1 give the reference tokens, then the
    same 12 again with ``migrate_engine`` moving engine#1 to locality 2
    mid-generation; (c) during the first of those runs one active slot's
    KV goes from locality 1 to locality 2 and back, bit-equal; (d) the
    migrated greedy tokens against the unmigrated ones; (e) a traced run
    over the three engines, its merged trace, critical paths and one
    ``/metrics`` sweep.  Every window checks exact launches at every
    locality.  Returns the phase's launches, summed over the localities."""
    import repro_torch.core as core
    from repro_torch import net as tnet
    from repro_torch.configs import get_config
    from repro_torch.core import agas, counters
    from repro_torch.fleet import grow_engine, migrate_engine
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.router import Router

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("starcoder2_3b")
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(SEED + 10)

    def prompts(n):
        return [rng.integers(1, V, size=k).tolist() for k in rng.integers(16, 513, size=n)]

    out = {"card": card}
    paths = []
    core.init(pools=LOC_POOLS)
    try:
        with tnet.running(2, pools=LOC_POOLS, worker_pools=LOC_POOLS) as net:
            t0 = time.perf_counter()
            scfg = ServeConfig(max_batch=8, cache_len=1024, page_size=16,
                               max_new_tokens=LOC_MAX_NEW, seed=SEED)
            router = Router.over_localities(net, "starcoder2_3b", scfg, smoke=False)
            eng0 = router.engines[0]
            gid0 = agas.default().register(eng0, name=ENGINE_PREFIX + "engine#0")
            try:
                for e in router.engines:  # cuBLAS handles, allocator: outside the runs
                    check(len(e.submit([1] * 16, max_new=2).get(timeout=600)) == 3,
                          f"localities: warm-up of {e.name if hasattr(e, 'name') else 'engine#0'}")
                out["setup_s"] = time.perf_counter() - t0

                # (a) two localities serve through the router
                pa = prompts(LOC_REQS)
                tok0 = counters.get_value("/serve{engine#0}/tokens/generated")
                tok1 = dict(tnet.query_counters(1, "/serve{engine#1}/tokens/generated"))

                def run_a():
                    t = time.perf_counter()
                    futs, toks, _s, threads = _stream_all(router.submit_stream, pa)
                    _finish_streams("(a)", futs, toks, threads, LOC_MAX_NEW, V)
                    return time.perf_counter() - t

                wall, la, after, da = _loc_window(net, L, "(a)", run_a)
                paths.append(la)
                gen0 = counters.get_value("/serve{engine#0}/tokens/generated") - tok0
                gen1 = (dict(tnet.query_counters(1, "/serve{engine#1}/tokens/generated"))
                        ["/serve{engine#1}/tokens/generated"]
                        - tok1["/serve{engine#1}/tokens/generated"])
                check(gen0 > 0 and gen1 > 0,
                      f"localities (a): tokens by locality {gen0}, {gen1}: both must serve")
                out["a"] = {
                    "requests": len(pa), "wall_s": wall, "launches": la,
                    "tokens_per_s": (gen0 + gen1) / wall,
                    "tokens_per_s_by_engine": {"engine#0": gen0 / wall, "engine#1": gen1 / wall},
                    "engine_deltas": da,
                    "decode_step_mean_s": {lid: {n: e["step_s"] / e["steps"]
                                                 for n, e in d.items() if e["steps"]}
                                           for lid, d in da.items()},
                    "peak_bytes_by_locality": {lid: s["peak_bytes"] for lid, s in after.items()},
                    "prompt_lengths": [len(p) for p in pa]}

                # (b) 1: a third locality joins under tier batch
                t0 = time.perf_counter()
                e2 = grow_engine(net, router, tier="batch")
                check(e2.locality == 2 and router.tier_of(e2.name) == "batch",
                      f"localities (b): grew {e2.name} at locality#{e2.locality}")
                check(len(e2.submit([1] * 16, max_new=2).get(timeout=600)) == 3,
                      "localities: warm-up of engine#2")
                out["grow_s"] = time.perf_counter() - t0
                e1 = router.engine("engine#1")
                pb = prompts(LOC_REQS)

                # (d) 1: the same requests twice without migration; (c) during the first
                kv = {}

                def run_base(first):
                    def run():
                        futs, toks, _s, threads = _stream_all(e1.submit_stream, pb)
                        if first:
                            deadline = time.monotonic() + 300
                            while sum(len(t) > 0 for t in toks) < scfg.max_batch:
                                check(time.monotonic() < deadline,
                                      "localities (c): the slots never filled")
                                time.sleep(0.001)
                            t = time.perf_counter()
                            snap = tnet.run_on(1, _kv_take, "engine#1").get(timeout=300)
                            back = tnet.run_on(2, _kv_roundtrip, "engine#2",
                                               snap).get(timeout=300)
                            kv["seconds"] = time.perf_counter() - t
                            kv["snap"], kv["back"] = snap, back
                        return _finish_streams("(d)", futs, toks, threads, LOC_MAX_NEW, V)
                    return run

                base1, lb1, _a, _d = _loc_window(net, L, "(d) 1", run_base(True))
                base2, lb2, _a, _d = _loc_window(net, L, "(d) 2", run_base(False))
                paths += [lb1, lb2]
                snap, back = kv.pop("snap"), kv.pop("back")
                check(snap["n_pages"] > 0 and snap["n_pages"] == back["n_pages"]
                      and snap["pos"] == back["pos"] and set(snap["pages"]) == set(back["pages"]),
                      "localities (c): the round trip changed the slot's shape")
                for k, a in snap["pages"].items():
                    b = back["pages"][k]
                    check(a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
                          and torch.equal(a.view(torch.int16), b.view(torch.int16)),
                          f"localities (c): pool {k} is not bit-equal after the round trip")
                kv.update(pages=snap["n_pages"], pos=snap["pos"],
                          bytes=sum(a.numel() * a.element_size() for a in snap["pages"].values()))
                out["c"] = kv
                deterministic = base1 == base2

                # (b) 2–3: the same requests, engine#1 moved to locality 2 mid-generation
                dups0 = _relay_total("duplicates")
                tnet.run_on(1, _loc_hold, "engine#1").get(timeout=60)
                mig = {}

                def run_b():
                    futs, toks, stamps, threads = _stream_all(e1.submit_stream, pb)
                    deadline = time.monotonic() + 300
                    while sum(len(t) >= LOC_MIGRATE_AFTER for t in toks) < scfg.max_batch:
                        check(time.monotonic() < deadline,
                              "localities (b): the active streams never reached "
                              f"{LOC_MIGRATE_AFTER} tokens")
                        time.sleep(0.001)
                    t = time.perf_counter()
                    mig["moved"] = migrate_engine(net, router, "engine#1", 2)
                    mig["migrate_s"] = time.perf_counter() - t
                    res = _finish_streams("(b)", futs, toks, threads, LOC_MAX_NEW, V)
                    gaps = [max(b - a for a, b in zip(s, s[1:])) for s in stamps if len(s) > 1]
                    mig["max_token_gap_s"] = max(gaps)
                    return res

                migrated, lm, after_b, dm = _loc_window(net, L, "(b)", run_b)
                paths.append(lm)
                moved = mig["moved"]
                check(e1.locality == 2, f"localities (b): engine#1 at locality#{e1.locality}")
                check(_relay_total("duplicates") == dups0,
                      "localities (b): the relay saw duplicate tokens across the cutover")
                mig_in = dict(tnet.query_counters(2, "/serve{engine#1}/requests/migrated_in"))
                mig_out = dict(tnet.query_counters(1, "/serve{engine#1}/requests/migrated_out"))
                check(mig_in["/serve{engine#1}/requests/migrated_in"] == moved
                      == mig_out["/serve{engine#1}/requests/migrated_out"],
                      f"localities (b): moved {moved}, in {mig_in}, out {mig_out}")
                active = moved - dm[2]["engine#1"]["prefills"]
                check(active == scfg.max_batch,
                      f"localities (b): {active} active requests moved, not {scfg.max_batch}")
                fm = counters.default().snapshot_stats("/fleet{migrate}/*")

                # (d) 2–3: greedy tokens across the cutover
                agree = sum(a == b for a, b in zip(migrated, base1))
                if deterministic:
                    check(migrated == base1, f"localities (d): {agree} of {len(pb)} migrated "
                          f"requests give the unmigrated tokens")

                # the engine serves at its new home
                def run_after():
                    return e1.submit(pb[0]).get(timeout=600)

                again, lafter, _a, dafter = _loc_window(net, L, "(b) after", run_after)
                paths.append(lafter)
                check(dafter[2]["engine#1"]["prefills"] == 1 and len(again) == LOC_MAX_NEW + 1,
                      "localities (b): engine#1 did not serve at locality#2")
                if deterministic:
                    check(again == base1[0], "localities (b): engine#1's tokens changed "
                          "at its new home")
                out["b"] = {"requests": len(pb), "moved": moved, "active_moved": active,
                            "migrate_s": mig["migrate_s"],
                            "cutover_s": fm["/fleet{migrate}/cutover"]["mean"],
                            "kv_bytes": fm["/fleet{migrate}/kv_bytes"]["value"],
                            "max_token_gap_s": mig["max_token_gap_s"], "launches": lm,
                            "engine_deltas": dm,
                            "peak_bytes_by_locality": {lid: s["peak_bytes"]
                                                       for lid, s in after_b.items()},
                            "prompt_lengths": [len(p) for p in pb]}
                out["d"] = {"rerun_bit_equal": deterministic, "agree": agree,
                            "requests": len(pb), "gate": deterministic}

                # (e) a traced run over the three engines
                out["e"] = _loc_traced(net, router, prompts(LOC_TRACED_REQS), cfg, L)
                paths.append(out["e"]["launches"])
            finally:
                agas.default().unregister(gid0)
                eng0.close()
    finally:
        core.finalize()
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k: sum(p.get(k, 0) for p in paths) for k in paths[0]}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    REPORT["localities"] = out
    a, b, c, d, e = out["a"], out["b"], out["c"], out["d"], out["e"]
    gib = 2 ** 30
    log(f"[localities] {card}: setup {out['setup_s']:.1f} s; (a) 2 localities, {a['requests']} "
        f"requests in {a['wall_s']:.2f} s = {a['tokens_per_s']:.1f} tokens/s "
        f"({ {k: round(v, 1) for k, v in a['tokens_per_s_by_engine'].items()} }); decode step "
        f"mean ms { {lid: {n: round(v * 1e3, 2) for n, v in m.items()} for lid, m in a['decode_step_mean_s'].items()} }; "
        f"peak GiB { {lid: round(v / gib, 2) for lid, v in a['peak_bytes_by_locality'].items()} }")
    log(f"[localities] (b) grow {out['grow_s']:.1f} s; migrated {b['moved']} requests "
        f"({b['active_moved']} active) mid-generation: migrate_engine {b['migrate_s']:.2f} s, "
        f"cutover {b['cutover_s'] * 1e3:.1f} ms, {b['kv_bytes'] / 1e6:.2f} MB of KV, longest "
        f"token gap {b['max_token_gap_s'] * 1e3:.1f} ms; peak GiB "
        f"{ {lid: round(v / gib, 2) for lid, v in b['peak_bytes_by_locality'].items()} }")
    log(f"[localities] (c) one slot's KV ({c['pages']} pages, {c['bytes'] / 1e6:.2f} MB, pos "
        f"{c['pos']}) 1 → 2 → back bit-equal in {c['seconds'] * 1e3:.1f} ms; (d) rerun "
        f"bit-equal: {d['rerun_bit_equal']}, migrated requests agreeing with the unmigrated "
        f"run: {d['agree']} of {d['requests']}")
    shares = {loc: " ".join(f"{k}={v:.4f}" for k, v in s.items())
              for loc, s in e["slow_share_p50_by_locality"].items()}
    log(f"[localities] (e) {e['requests']} traced requests {e['requests_by_locality']} by "
        f"locality, {e['events']} events; p50 SLOW share by locality {shares}; decode step "
        f"p50 ms { {k: round(v * 1e3, 2) for k, v in e['decode_step_p50_s_by_locality'].items()} }; "
        f"max clamped {e['max_clamped_fraction']:.2e}; /metrics {e['metrics']['series']} "
        f"series equal to query_counters; phase {out['seconds']:.1f} s; launches {launches}")
    return launches


# ----------------------------------------------------------------- phase 11
# The data half of the multi-locality runtime on the card.  (a)
# Partitioned vectors over 2 localities (the root and one spawned worker,
# each its own CUDA context): a block vector of DATA_N fp32 elements
# filled in place by ``_pv_values`` (a multiplicative hash of the global
# index and the seed, so every owner makes its own elements and the root
# its one-tensor copy), each segmented algorithm held against ``vec`` on
# that one CUDA tensor (sums and scans within RUNTIME_SUM_RTOL of the
# magnitudes added, the rest exact); cyclic and explicit layouts (one
# empty and one single-element segment) and ``sort`` at DATA_SMALL_N; the
# wire bytes of the segmented reduce against ``to_array`` + a local sum;
# ``move_segment`` there and back; the reduce body's device GB/s at each
# owner.  (b) ``launch.train.main`` in process: full starcoder2_3b fed
# from locality 0's segments of a DATA_ROWS-row sharded dataset, with the
# four observability flags.  (c) A partitioned checkpoint after a
# ``move_segment``, and a checkpoint by GID of a state at locality 1
# restored onto a grown locality 2.
DATA_N = 2 ** 27
DATA_SMALL_N = 2 ** 16
DATA_POOLS = {"default": 4, "io": 1}
DATA_ROWS, DATA_BATCH, DATA_SEQ, DATA_STEPS = 16384, 2, 512, 3
DATA_NAME = "/chip_smoke/data"
DATA_REPS = 5                      # timed calls of the segmented reduce


def _pv_values(idx, seed):
    """``fill_with`` generator: a float32 in [-1, 1) for each global index,
    a multiplicative hash of (index, seed)."""
    import numpy as np

    h = (idx.astype(np.uint64) + np.uint64(seed)) * np.uint64(2654435761) % np.uint64(2 ** 32)
    return (h.astype(np.float64) / 2 ** 31 - 1.0).astype(np.float32)


def _pv_values_on_card(torch, n, seed):
    """``_pv_values`` of the global indices 0..n-1 as one CUDA tensor, made
    on the card (the hash fits int64 for n ≤ 2³²; the same IEEE steps, so
    the same elements)."""
    idx = torch.arange(n, dtype=torch.int64, device="cuda")
    h = (idx + seed) * 2654435761 % 2 ** 32
    return (h.double() / 2 ** 31 - 1.0).float()


def _pv_aff(x):
    return 3 * x + 1


def _pv_sq(x):
    return x * x


def _pv_positive(x):
    return x > 0


def _pv_kind(rt, key):
    """At a segment's owner: what the segment is there (its module and
    device)."""
    from repro_torch.core import agas

    obj = agas.default().resolve(agas.GID(*key))
    return type(obj).__module__.split(".")[0], getattr(obj, "device", None) and obj.device.type


def _pv_time_reduce(rt, key, reps):
    """At a segment's owner: the device time of the segmented reduce's
    work on that segment — the body's one ``torch.sum``, timed as phase 9
    times ``vec`` (``_time_ms``: L2 flushed, a spin kernel covering the
    host's enqueue) — and the wall time of the whole body
    (``segmented._seg_reduce``: the hop to the compute pool, the sum, the
    partial's copy home), median of ``reps``; and the segment's bytes."""
    import operator

    import torch

    from repro_torch.container import segmented
    from repro_torch.core import agas

    seg = agas.default().resolve(agas.GID(*key))
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    ms = _time_ms(torch, lambda: torch.sum(seg, dim=0, dtype=seg.dtype), flush, reps=reps)
    wall = []
    for _ in range(reps):
        t0 = time.perf_counter()
        segmented._seg_reduce(seg, operator.add)
        wall.append(time.perf_counter() - t0)
    return {"ms": ms, "wall_ms": statistics.median(wall) * 1e3,
            "bytes": seg.numel() * seg.element_size()}


def _pv_gid_state(rt, name):
    """At locality 1: phase 8's 2-layer training state (fp32 masters and
    AdamW moments) with its bf16 compute params, made on this locality's
    card and registered under ``name``; returns its GID key and, per leaf,
    the sum of its bit patterns."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import agas
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    model = Model(replace(get_config("starcoder2_3b"), num_layers=2))
    params = model.init(SEED)
    state = {"params": params, "opt": adamw.init(params),
             "compute": model.compute_params(params)}
    gid = agas.default().register(state, name=name)
    return [gid.locality, gid.seq], _bit_sums(torch, ckpt._flatten(state))


def _pv_gid_drop(rt, name):
    """At locality 1: unregister the state, and give its memory back."""
    import torch

    from repro_torch.core import agas

    a = agas.default()
    a.unregister(a.gid_of(name))
    gc.collect()
    torch.cuda.empty_cache()
    return True


def _bit_sums(torch, flat):
    """{leaf: (dtype, shape, the int64 sum of its bit patterns)}: taken where
    a state is made and where it arrives, equal if every leaf came through
    bit for bit (bf16 as its 16-bit patterns)."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return {k: (str(t.dtype), tuple(t.shape),
                int(t.contiguous().view(view[t.element_size()]).sum(dtype=torch.int64)))
            for k, t in flat.items()}


def _pv_wire():
    """Bytes every locality has sent over the parcelport so far."""
    from repro_torch import net as tnet

    sweep = tnet.query_counters(None, "/net{*}/bytes/sent")
    return float(sum(v for pairs in sweep.values() for _k, v in pairs))


def _pv_held(torch, what, got, want, scale=None, dtype=None):
    """A segmented result against ``vec``'s on one tensor, both on the
    card: exact, or within RUNTIME_SUM_RTOL of ``scale`` (the magnitudes
    a sum or scan adds).  The dtypes agree, unless ``dtype`` names the
    segmented result's own.  Returns the error."""
    got = torch.as_tensor(got).to("cuda")
    want = torch.as_tensor(want).to("cuda")
    check(got.shape == want.shape and got.dtype == (dtype or want.dtype),
          f"data: {what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    if scale is None:
        check(torch.equal(got, want), f"data: {what} differs from vec")
        return 0.0
    err = ((got.double() - want.double()).abs() / scale).max().item()
    check(err <= RUNTIME_SUM_RTOL, f"data: {what} off by {err:.3g} of the magnitudes it "
                                   f"adds (limit {RUNTIME_SUM_RTOL})")
    return err


def _data_algorithms(torch, np, pv, x, tag):
    """Every segmented algorithm on ``pv`` against ``vec`` on ``x`` (the
    same elements in one CUDA tensor).  Returns the worst sum error."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.executor import par, vec

    mag = x.abs().double()
    errs = {}
    errs["reduce"] = _pv_held(torch, f"{tag} reduce", alg.reduce(par, pv),
                              alg.reduce(vec, x), mag.sum())
    errs["transform_reduce"] = _pv_held(torch, f"{tag} transform_reduce",
                                        alg.transform_reduce(par, pv, _pv_sq),
                                        alg.transform_reduce(vec, x, _pv_sq), (mag * mag).sum())
    check(alg.count_if(par, pv, _pv_positive) == alg.count_if(vec, x, _pv_positive),
          f"data: {tag} count_if differs from vec")
    for name in ("min_element", "max_element"):
        _pv_held(torch, f"{tag} {name}", getattr(alg, name)(par, pv), getattr(alg, name)(vec, x))
    t = alg.transform(par, pv, _pv_aff)
    _pv_held(torch, f"{tag} transform", t.to_array(), alg.transform(vec, x, _pv_aff))
    t.free()
    scan = torch.cumsum(mag, 0)
    s = alg.inclusive_scan(par, pv)
    errs["inclusive_scan"] = _pv_held(torch, f"{tag} inclusive_scan", s.to_array(),
                                      alg.inclusive_scan(vec, x), scan)
    s.free()
    # numpy promotes the int init beside fp32 segments as the reference's
    # numpy segments do (float64 on numpy 2), vec as jnp does (float32)
    s = alg.exclusive_scan(par, pv, init=7)
    errs["exclusive_scan"] = _pv_held(torch, f"{tag} exclusive_scan", s.to_array(),
                                      alg.exclusive_scan(vec, x, init=7),
                                      7 + torch.cat([scan.new_zeros(1), scan[:-1]]),
                                      dtype=s.dtype)
    s.free()
    return errs


def _data_vectors(torch, np, net):
    """Phase 11(a): see the block comment above."""
    from repro_torch import net as tnet
    from repro_torch.container import PartitionedVector, distribution
    from repro_torch.core import algorithms as alg
    from repro_torch.core.executor import par, vec

    out = {"N": DATA_N, "small_N": DATA_SMALL_N}
    t0 = time.perf_counter()
    pv = PartitionedVector.create(f"{DATA_NAME}/block", DATA_N, dtype=np.float32)
    pv.fill_with(_pv_values, SEED)
    out["create_fill_s"] = time.perf_counter() - t0
    kinds = [tnet.run_on(o, _pv_kind, list(k)).get(timeout=60)
             for o, k in zip(pv.owners(), pv.segment_keys)]
    check(pv.owners() == [0, 1] and kinds == [("torch", "cuda")] * 2,
          f"data (a): owners {pv.owners()}, segments {kinds}")
    x = _pv_values_on_card(torch, DATA_N, SEED)
    t0 = time.perf_counter()
    out["sum_err"] = _data_algorithms(torch, np, pv, x, "block")
    out["algorithms_s"] = time.perf_counter() - t0

    # the claim: work went to the data
    nbytes = DATA_N * 4
    b0 = _pv_wire()
    total = alg.reduce(par, pv)
    b1 = _pv_wire()
    fetched = pv.to_array()
    local_sum = fetched.sum()
    b2 = _pv_wire()
    del fetched
    out["wire"] = {"element_bytes": nbytes, "segmented_reduce": b1 - b0,
                   "fetch_all_and_sum": b2 - b1, "ratio": (b2 - b1) / (b1 - b0)}
    check(b1 - b0 < 0.01 * nbytes and b2 - b1 > 0.9 * nbytes / 2,
          f"data (a): the segmented reduce moved {b1 - b0:.0f} bytes, fetch-all "
          f"{b2 - b1:.0f}, of {nbytes} element bytes")
    check(abs(float(total) - local_sum.item()) <= RUNTIME_SUM_RTOL * x.abs().double().sum().item(),
          f"data (a): segmented sum {total} vs fetched sum {local_sum.item()}")

    # device GB/s of the reduce body at each owner, the whole call's wall
    out["reduce_body"] = {o: tnet.run_on(o, _pv_time_reduce, list(k), DATA_REPS).get(timeout=300)
                          for o, k in zip(pv.owners(), pv.segment_keys)}
    for r in out["reduce_body"].values():
        r["GB_per_s"] = r["bytes"] / r["ms"] / 1e6
    wall = []
    for _ in range(DATA_REPS):
        t0 = time.perf_counter()
        alg.reduce(par, pv)
        wall.append(time.perf_counter() - t0)
    out["reduce_wall_ms"] = statistics.median(wall) * 1e3
    out["reduce_wall_GB_per_s"] = nbytes / statistics.median(wall) / 1e9
    stream = REPORT.get("stream", {})
    out["triad_GB_per_s"] = stream.get("float32", {}).get("GB_per_s")

    # a segment there and back: the GID, the bytes and the card kept
    seg0 = dict(pv.local_segments())[0].clone()
    gid = pv.segment_gid(0)
    t0 = time.perf_counter()
    pv.move_segment(0, 1)
    out["move_there_s"] = time.perf_counter() - t0
    there = tnet.run_on(1, _pv_kind, list(pv.segment_keys[0])).get(timeout=60)
    t0 = time.perf_counter()
    pv.move_segment(0, 0)
    out["move_back_s"] = time.perf_counter() - t0
    back = dict(pv.local_segments()).get(0)
    check(pv.owner_of(0) == 0 and pv.segment_gid(0) == gid and there == ("torch", "cuda")
          and back is not None and back.device.type == "cuda" and torch.equal(back, seg0),
          f"data (a): move_segment there and back: at 1 {there}, GID {pv.segment_gid(0)} "
          f"(was {gid}), back on {None if back is None else back.device}")
    out["move_bytes"] = seg0.numel() * seg0.element_size()
    del seg0, back
    check(alg.fill(par, pv, 3.0) is pv and alg.min_element(par, pv) == 3.0
          and alg.max_element(par, pv) == 3.0, "data (a): fill")
    pv.free()
    del x

    # cyclic and explicit layouts (an empty and a single-element segment), sort
    n = DATA_SMALL_N
    xs = _pv_values_on_card(torch, n, SEED + 1)
    out["small"] = {}
    for tag, layout in (("cyclic", "cyclic"),
                        ("explicit", distribution.explicit([0, 1, n - 1], [1, 0, 1]))):
        small = PartitionedVector.create(f"{DATA_NAME}/{tag}", n, dtype=np.float32,
                                         distribution=layout)
        small.fill_with(_pv_values, SEED + 1)
        out["small"][tag] = _data_algorithms(torch, np, small, xs, tag)
        check(alg.sort(par, small) is small, f"data: {tag} sort")
        _pv_held(torch, f"{tag} sort", small.to_array(), alg.sort(vec, xs))
        small.free()
    return out


def _data_train(torch, np, card):
    """Phase 11(b): full starcoder2_3b trained by ``launch.train.main`` from
    locality 0's segments of a sharded dataset, with ``--trace``,
    ``--print-counters``, ``--metrics-port`` and ``--timeline``; a thread
    runs ``obs.top --once`` against the exporter while the run lasts."""
    import socket

    from repro_torch.configs import get_config
    from repro_torch.core import counters
    from repro_torch.data.pipeline import synth_token_rows
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.net.httpd import http_get
    from repro_torch.obs import top, trace

    cfg = get_config("starcoder2_3b")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace_path, tl_path = out_dir / "phase11_trace.json", out_dir / "phase11_timeline.jsonl"
    with socket.socket() as s:  # a free port, so the URL is known before the run
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}/metrics"
    seen = {}
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            try:
                status, _body = http_get(url, timeout=5)
            except OSError:  # not up yet
                status = None
            if status == 200:
                seen["rc"] = top.main(["--once", "--metrics", url])
                return
            time.sleep(0.2)

    watcher = threading.Thread(target=watch, name="phase11-top", daemon=True)
    watcher.start()
    timer = counters.default().timer("/train{loop#0}/step/duration", percentiles=True)
    timer.reset()  # this run's steps only
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L, B, S, steps = cfg.num_layers, DATA_BATCH, DATA_SEQ, DATA_STEPS
    ops.reset_launch_counts()  # ← the sharded training path starts here
    t0 = time.perf_counter()
    try:
        rep = launch_train.main([
            "--arch", "starcoder2_3b", "--localities", "2",
            "--sharded-rows", str(DATA_ROWS), "--batch", str(B), "--seq", str(S),
            "--steps", str(steps), "--log-every", "1", "--trace", str(trace_path),
            "--print-counters", "/train*", "--metrics-port", str(port),
            "--timeline", str(tl_path)])
    finally:
        stop.set()
        watcher.join(timeout=60)
        trace.disable()
        trace.clear()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()  # ← and ends here
    peak = torch.cuda.max_memory_allocated()
    _check_launches("data (b)", launches, {"flash_attention": L * steps})
    sharded, hist = rep["sharded"], rep["history"]
    rows_bytes = DATA_ROWS * (S + 1) * 4
    check(sharded["local_rows"] == DATA_ROWS // 2 and sharded["segments"] == 2,
          f"data (b): {sharded}")
    check(sharded["wire_bytes"] < 0.01 * rows_bytes,
          f"data (b): the dataset's creation moved {sharded['wire_bytes']:.0f} bytes of "
          f"{rows_bytes}")
    check(len(hist) == steps and all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                                     for h in hist), f"data (b): {hist}")
    feeder = rep["feeder"]
    for step in range(steps):  # the feeder's batch of each step, rebuilt
        got = feeder._build(step)["tokens"]
        rng = np.random.default_rng(feeder.dcfg.seed * 9_176_081 + step)
        pick = rng.integers(0, DATA_ROWS // 2, size=B)
        want = synth_token_rows(feeder.global_rows[pick], cfg, feeder.dcfg)
        check(got.device.type == "cuda" and got.dtype == torch.int32
              and torch.equal(got.cpu(), torch.from_numpy(want)),
              f"data (b): step {step}'s batch is not the rows the feeder picked")
    del rep, feeder
    pids = {e.get("pid") for e in json.loads(trace_path.read_text())["traceEvents"]}
    check({0, 1} <= pids, f"data (b): the merged trace holds localities {pids}")
    records = len(tl_path.read_text().splitlines())
    check(records >= 2, f"data (b): timeline of {records} records")
    check(seen.get("rc") == 0, f"data (b): obs.top --once against {url}: {seen}")
    st = timer.stats()
    p50 = timer.quantile(0.5)
    train8 = REPORT.get("train", {})
    return launches, {
        "card": card, "rows": DATA_ROWS, "local_rows": sharded["local_rows"],
        "dataset_wire_bytes": sharded["wire_bytes"], "dataset_bytes": rows_bytes,
        "batch": B, "seq": S, "steps": steps, "history": hist, "wall_s": wall,
        "step_stats": st, "step_p50_s": p50, "tokens_per_s": B * S / p50,
        "peak_bytes": peak, "launches": launches, "trace_pids": sorted(pids),
        "timeline_records": records, "top_rc": seen.get("rc"),
        "phase8b_step_p50_s": train8.get("step_p50_s"),
        "phase8b_tokens_per_s": train8.get("tokens_per_s")}


def _data_checkpoints(torch, np, net):
    """Phase 11(c): a partitioned checkpoint after a ``move_segment``, and a
    checkpoint by GID of a state at locality 1 restored onto a grown
    locality 2 (files under ``TMPDIR``)."""
    import tempfile

    from repro_torch import net as tnet
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.container.partitioned_vector import host_tensor
    from repro_torch.core import agas
    from repro_torch.data.pipeline import DataConfig, ShardedTokenDataset

    out = {}
    cfg = get_config("starcoder2_3b")
    ds = ShardedTokenDataset.create(f"{DATA_NAME}/rows", cfg,
                                    DataConfig(batch_size=DATA_BATCH, seq_len=DATA_SEQ),
                                    rows=DATA_ROWS)
    rows = ds.pv.to_array()
    ds.pv.move_segment(0, 1)  # owners [1, 1]: not those of its creation
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        saved = ckpt.save_partitioned(d, 1, ds.pv)
        out["pvec_save_s"] = time.perf_counter() - t0
        writers = [s["locality"] for s in json.loads(
            (saved / "partitioned.json").read_text())["shards"]]
        ds.pv.free()
        t0 = time.perf_counter()
        step, back = ckpt.restore_partitioned(d)
        out["pvec_restore_s"] = time.perf_counter() - t0
        kinds = [tnet.run_on(o, _pv_kind, list(k)).get(timeout=60)
                 for o, k in zip(back.owners(), back.segment_keys)]
        check(step == 1 and writers == [1, 1] and back.owners() == [1, 1]
              and kinds == [("torch", "cuda")] * 2 and torch.equal(back.to_array(), rows),
              f"data (c): writers {writers}, restored at {back.owners()} as {kinds}")
        back.free()
    out["pvec_bytes"] = rows.numel() * rows.element_size()

    name = f"{DATA_NAME}/gid-state"
    t0 = time.perf_counter()
    key, sums = tnet.run_on(1, _pv_gid_state, name).get(timeout=600)
    out["gid_build_s"] = time.perf_counter() - t0
    out["gid_bytes"] = sum(int(np.prod(shape)) * {"torch.bfloat16": 2, "torch.int32": 4}
                           .get(dt, 4) for dt, shape, _ in sums.values())
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save_gid(d, 8, agas.GID(*key))
        out["gid_save_s"] = time.perf_counter() - t0
        tnet.run_on(1, _pv_gid_drop, name).get(timeout=300)
        t0 = time.perf_counter()
        lid = net.spawn_locality(pools=DATA_POOLS, timeout=120)
        out["grow_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, gid = ckpt.restore_gid(d, locality=lid)
        out["gid_restore_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fetched = ckpt._flatten(tnet.fetch(gid, timeout=600))
        out["gid_fetch_s"] = time.perf_counter() - t0
    fetched = {k: host_tensor(v) for k, v in fetched.items()}  # numpy off the wire
    check(lid == 2 and step == 8 and gid.locality == 2 and tnet.owner_of(name) == 2,
          f"data (c): restore_gid gave step {step}, GID {gid} at locality {lid}")
    check(_bit_sums(torch, fetched) == sums,
          "data (c): the state fetched from locality 2 is not the one made at locality 1 "
          "(a leaf's dtype, shape or sum of bit patterns differs)")
    out["gid_leaves"] = len(sums)
    out["gid_bf16_leaves"] = sum(dt == "torch.bfloat16" for dt, _s, _b in sums.values())
    del fetched
    return out


def phase_data(torch, np, card):
    """Phase 11, the data half of the multi-locality runtime on the card:
    (b) full starcoder2_3b trained from locality 0's shards by the
    launcher (which brings up its own two localities), then over two
    localities of the phase's own (a) partitioned vectors and segmented
    algorithms and (c) partitioned and by-GID checkpoints.  Returns the
    launches of (b), the phase's one kernel path."""
    import repro_torch.core as core
    from repro_torch import net as tnet

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card}
    t0 = time.perf_counter()
    launches, out["b"] = _data_train(torch, np, card)  # brings up its own localities
    out["b"]["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    core.init(pools=DATA_POOLS)
    try:
        with tnet.running(2, pools=DATA_POOLS, worker_pools=DATA_POOLS) as net:
            t0 = time.perf_counter()
            out["a"] = _data_vectors(torch, np, net)
            out["a"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["c"] = _data_checkpoints(torch, np, net)
            out["c"]["seconds"] = time.perf_counter() - t0
    finally:
        core.finalize()
    out["seconds"] = time.perf_counter() - t_phase
    REPORT["data"] = out
    a, b, c = out["a"], out["b"], out["c"]
    w = a["wire"]
    body = {o: f"{r['GB_per_s']:.1f} GB/s ({r['ms']:.4f} ms; body wall {r['wall_ms']:.3f} ms)"
            for o, r in a["reduce_body"].items()}
    log(f"[data] {card}: (a) {a['N']} fp32 elements over localities 0, 1, created and "
        f"filled in place in {a['create_fill_s']:.2f} s; every algorithm against vec, worst "
        f"sum error {max(a['sum_err'].values()):.3g} of the magnitudes added; segmented "
        f"reduce moved {w['segmented_reduce']:.0f} wire bytes, to_array + sum "
        f"{w['fetch_all_and_sum']:.0f} ({w['ratio']:.0f}x); reduce body's device time by "
        f"owner {body}, the whole call {a['reduce_wall_ms']:.2f} ms wall "
        f"({a['reduce_wall_GB_per_s']:.1f} GB/s), triad {a['triad_GB_per_s']}; a "
        f"{a['move_bytes'] / 1e6:.1f} MB segment 0 → 1 in {a['move_there_s']:.2f} s, back "
        f"in {a['move_back_s']:.2f} s, bit-equal on cuda; cyclic and explicit at "
        f"{a['small_N']} and sort exact; {a['seconds']:.1f} s")
    log(f"[data] (b) starcoder2_3b {b['steps']} steps of B={b['batch']}, S={b['seq']} from "
        f"{b['local_rows']} local rows of {b['rows']} (creation moved "
        f"{b['dataset_wire_bytes']:.0f} of {b['dataset_bytes']} bytes): losses "
        f"{[round(h['loss'], 4) for h in b['history']]}; step p50 "
        f"{b['step_p50_s'] * 1e3:.1f} ms, {b['tokens_per_s']:.0f} tokens/s (phase 8b: "
        f"{(b['phase8b_step_p50_s'] or 0) * 1e3:.1f} ms, {b['phase8b_tokens_per_s'] or 0:.0f}); "
        f"peak {b['peak_bytes'] / 2**30:.2f} GiB; launches {b['launches']} "
        f"({b['launches']['flash_attention'] // b['steps']} flash a step); trace localities "
        f"{b['trace_pids']}; timeline {b['timeline_records']} records; top --once rc "
        f"{b['top_rc']}; {b['seconds']:.1f} s")
    log(f"[data] (c) partitioned {c['pvec_bytes'] / 1e6:.1f} MB: save {c['pvec_save_s']:.2f} s "
        f"by owners [1, 1], restore {c['pvec_restore_s']:.2f} s at [1, 1], bit-equal; by GID "
        f"{c['gid_bytes'] / 1e9:.2f} GB ({c['gid_leaves']} leaves, {c['gid_bf16_leaves']} "
        f"bf16): built at 1 in {c['gid_build_s']:.1f} s, save {c['gid_save_s']:.1f} s, grow "
        f"{c['grow_s']:.1f} s, restore at 2 {c['gid_restore_s']:.1f} s, fetch "
        f"{c['gid_fetch_s']:.1f} s, bit-equal; {c['seconds']:.1f} s; phase {out['seconds']:.1f} s")
    return launches


# --------------------------------------------------------------------- main
# the timing row the kernels line reports: flash at S=512 (starcoder2_3b's
# prefill), the SSD and the RG-LRU as the models call them (fp32 dt and
# the final state; fp32 a and b), the rest their first row
MAIN_ROW = {"flash_attention": 1, "ssd_scan": 1, "rglru_scan": 1}


# ----------------------------------------------------------------- phase 12
# The device plane on the card: a one-rank NCCL process group (NCCL puts
# no two ranks on one card; multi-rank meshes are held on gloo by the CPU
# tests), made by ``launch.mesh`` after phase 11's localities are gone and
# destroyed at the end.  (a) parity: phase 8a's fp32 2-layer state, one
# futurized step's loss and every gradient on a ("data", "model") 1×1
# mesh of DTensors against the same step without a mesh (phase 8a's
# limits), 2 flash launches a step either way.  (b) full starcoder2_3b
# (30 layers) under ``get_plan("futurized", compress_pod_grads=True)``:
# ``Trainer(mesh=...)`` on the 1×1 mesh at phase 8b's shape, MESH_STEPS
# steps; ``elastic_restart`` onto a ("pod", "data", "model") 1×1×1 mesh
# and MESH_STEPS steps more through the pod-manual branch (every gradient
# all-reduced as bf16 over the pod group, counted); losses within
# TRAIN_BF16_LOSS_TOL of phase 8b's at the same seed and batches, the GID
# kept and its generation bumped once, the restart counter at 1, exactly
# 30 flash launches a step; step p50, tokens/s, kernels a step and the
# device-busy share beside phase 8b's, the peak and the restart's seconds.
# (c) phase 8's 2-layer checkpoint restored onto the 1×1 mesh with
# ``shardings=``: every leaf bit-equal to a plain restore and on its
# requested placements.  (d) ``MeshExecutor`` over phase 9's 2²⁷ fp32
# elements: transform, reduce, transform_reduce and count_if under
# ``mesh_policy`` against ``vec`` on the same tensor (exact, sums within
# RUNTIME_SUM_RTOL), each timed (``_time_ms``), GB/s beside the triad.
MESH_STEPS = 2
MESH_ALGOS = ("transform", "reduce", "transform_reduce", "count_if")


def _mesh_parity(torch, mesh):
    """Phase 12(a): see the block comment above."""
    from repro_torch.configs.starcoder2_3b import full_config
    from repro_torch.core import migration
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, S = TRAIN_PARITY
    cfg = replace(full_config(), num_layers=layers, dtype="float32")
    model = Model(cfg)
    params = model.init(SEED)
    batch = {k: v.cuda() for k, v in
             synth_batch(cfg, DataConfig(batch_size=B, seq_len=S, seed=SEED), 0).items()}
    ops.reset_launch_counts()
    loss_p, grads_p = step_mod.value_and_grad(model.loss, params, batch)
    torch.cuda.synchronize()
    _check_launches("mesh parity (no mesh)", ops.launch_counts(), {"flash_attention": layers})
    p_sh, _ = step_mod.train_state_shardings(model, mesh)
    dparams = migration.migrate_tree(params, p_sh, mesh)
    dbatch = step_mod.place_batch(model, mesh, batch)
    ops.reset_launch_counts()  # ← the mesh step
    loss_m, grads_m = step_mod.value_and_grad(model.loss, dparams, dbatch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()  # ← and its end
    _check_launches("mesh parity", launches, {"flash_attention": layers})
    loss_err = abs(loss_m.full_tensor().item() - loss_p.item())
    check(loss_err <= TRAIN_LOSS_TOL, f"mesh parity: loss err {loss_err}")
    worst, worst_rel = None, 0.0
    for k, g in grads_p.items():
        gm = grads_m[k]
        check(list(gm.placements) == list(p_sh[k]),
              f"mesh parity: {k} grad on {gm.placements}, its param on {p_sh[k]}")
        err = (gm.full_tensor() - g).abs().max().item()
        scale = g.abs().max().item()
        check(scale > 0 and err <= TRAIN_GRAD_RTOL * scale,
              f"mesh parity: {k} grad err {err} > {TRAIN_GRAD_RTOL} × {scale}")
        if err / scale >= worst_rel:
            worst, worst_rel = k, err / scale
    out = {"layers": layers, "batch": B, "seq": S, "loss": loss_p.item(),
           "loss_err": loss_err, "loss_tol": TRAIN_LOSS_TOL, "worst_grad": worst,
           "worst_grad_rel_err": worst_rel, "grad_rtol": TRAIN_GRAD_RTOL,
           "launches": launches}
    log(f"[mesh parity] {layers} layers fp32 on a (data, model) 1×1 mesh: loss "
        f"{loss_p.item():.6f} (err {loss_err:.3g}, tol {TRAIN_LOSS_TOL}); worst grad "
        f"{worst} {worst_rel:.3g} of its max (rtol {TRAIN_GRAD_RTOL}); launches {launches}")
    del params, dparams, grads_p, grads_m
    return out


def _mesh_train(torch, card, mesh, pod_mesh):
    """Phase 12(b): see the block comment above."""
    import torch.distributed as dist

    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.core import agas, counters
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.dist.plan import get_plan
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("starcoder2_3b")
    B, S, _ = TRAIN_RUN
    L = cfg.num_layers
    dcfg = DataConfig(batch_size=B, seq_len=S, seed=SEED)
    model = Model(cfg, plan=get_plan("futurized", compress_pod_grads=True))
    check(not step_mod.takes_pod_manual(model, mesh) and
          step_mod.takes_pod_manual(model, pod_mesh),
          "mesh train: the pod-manual branch rule")
    bf16_reduces = [0]
    all_reduce = dist.all_reduce

    def counted(t, *a, **kw):  # the pod-manual branch's wire, seen from outside
        if t.dtype == torch.bfloat16:
            bf16_reduces[0] += 1
        return all_reduce(t, *a, **kw)

    core.init(pools={"default": 4, "io": 1})
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(model, adamw.AdamWConfig(**TRAIN_OPT), dcfg,
                     TrainConfig(steps=MESH_STEPS, log_every=1), rng_seed=SEED, mesh=mesh)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        hist, step_s = [], []
        ops.reset_launch_counts()  # ← the mesh training path starts here
        for _ in range(MESH_STEPS):
            t0 = time.perf_counter()
            hist += tr.fit(1)
            step_s.append(time.perf_counter() - t0)
        gen0 = agas.default().record(tr.gid).generation
        t0 = time.perf_counter()
        tr.elastic_restart(pod_mesh)
        torch.cuda.synchronize()
        restart_s = time.perf_counter() - t0
        rec = agas.default().record(tr.gid)
        check(rec.generation == gen0 + 1 and rec.placement is pod_mesh,
              f"mesh train: the restart's rebind (generation {gen0} → {rec.generation})")
        dist.all_reduce = counted
        try:
            for _ in range(MESH_STEPS):
                t0 = time.perf_counter()
                hist += tr.fit(1)
                step_s.append(time.perf_counter() - t0)
        finally:
            dist.all_reduce = all_reduce
        launches = ops.launch_counts()  # ← and ends here
        peak = torch.cuda.max_memory_allocated()
        _check_launches("mesh train", launches, {"flash_attention": 2 * MESH_STEPS * L})
        n_params = len(tr.params)
        check(bf16_reduces[0] >= MESH_STEPS * n_params,
              f"mesh train: {bf16_reduces[0]} bf16 all-reduces in {MESH_STEPS} pod-manual "
              f"steps of {n_params} grads")
        restarts = counters.default().counter(
            "/train{loop#0}/elastic_restarts/cumulative").get_value()
        check(restarts == 1, f"mesh train: {restarts} elastic restarts counted")
        ref = [h["loss"] for h in REPORT["train"]["history"]]
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses) and all(
            abs(a - b) <= TRAIN_BF16_LOSS_TOL for a, b in zip(losses, ref)),
              f"mesh train: losses {losses} vs phase 8b's {ref}")
        prof = _device_profile(torch, lambda: tr.fit(1), 1)
        p50 = statistics.median(step_s)
        b8 = REPORT["train"]
        out = {"card": card, "arch": cfg.name, "layers": L, "batch": B, "seq": S,
               "plan": "futurized+compress_pod_grads", "history": hist, "step_s": step_s,
               "step_p50_s": p50, "tokens_per_s": B * S / p50, "setup_s": setup_s,
               "restart_s": restart_s, "max_memory_allocated_bytes": peak,
               "launches": launches, "bf16_all_reduces": bf16_reduces[0],
               "phase_8b_losses": ref, "loss_tol": TRAIN_BF16_LOSS_TOL,
               "profile_one_step": prof,
               "phase_8b": {"step_p50_s": b8["step_p50_s"], "tokens_per_s": b8["tokens_per_s"],
                            "kernels_per_step": b8["profile_one_step"].get("kernels_per_call"),
                            "busy_share": b8["profile_one_step"].get("busy_share"),
                            "max_memory_allocated_bytes": b8["max_memory_allocated_bytes"]}}
        busy = ("device time not measured (the profiler saw none)"
                if prof["device_ms"] is None else
                f"{prof['kernels_per_call']:.0f} kernels, device busy "
                f"{100 * prof['busy_share']:.1f}%")
        log(f"[mesh train] {card}: {cfg.name} {L} layers, B={B}, S={S}, 1×1 then "
            f"(pod) 1×1×1 mesh: losses {[round(x, 4) for x in losses]} (phase 8b "
            f"{[round(x, 4) for x in ref]}); step p50 {p50 * 1e3:.1f} ms "
            f"({[round(t * 1e3, 1) for t in step_s]}), {B * S / p50:.0f} tokens/s (phase 8b "
            f"{b8['tokens_per_s']:.0f}); one step {busy}; restart {restart_s:.2f} s; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; {bf16_reduces[0]} bf16 "
            f"all-reduces; launches {launches}")
        tr.close()
        del tr
        return out, launches
    finally:
        core.finalize()
        gc.collect()
        torch.cuda.empty_cache()


def _mesh_restore(torch, mesh):
    """Phase 12(c): see the block comment above."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_mod

    d = CHECKPOINT_DIR.pop()
    try:
        model = Model(replace(get_config("starcoder2_3b"), num_layers=2))
        p_sh, o_sh = step_mod.train_state_shardings(model, mesh)
        sh = {"params": p_sh, "opt": o_sh}
        t0 = time.perf_counter()
        step, placed = ckpt.restore(d.name, shardings=sh, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        step_p, plain = ckpt.restore(d.name)
        check(step == step_p == 2, f"mesh restore: step {step} vs {step_p}")

        def leaves(tree, shard, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, shard[k], f"{prefix}{k}/")
                else:
                    yield f"{prefix}{k}", v, shard[k]

        want = dict((k, v) for k, v, _ in leaves(plain, sh))
        n = nbytes = 0
        for k, v, pl in leaves(placed, sh):
            check(list(v.placements) == list(pl) and v.device_mesh is mesh,
                  f"mesh restore: {k} on {v.placements}, asked {pl}")
            full = v.full_tensor()
            check(full.device.type == "cuda" and full.dtype == want[k].dtype and
                  torch.equal(full.cpu(), want[k]), f"mesh restore: {k} differs")
            n += 1
            nbytes += full.numel() * full.element_size()
        out = {"leaves": n, "bytes": nbytes, "seconds": secs, "step": step}
        log(f"[mesh restore] phase 8's 2-layer checkpoint onto the 1×1 mesh: {n} leaves, "
            f"{nbytes / 1e9:.2f} GB bit-equal on their placements, {secs:.1f} s")
        return out
    finally:
        d.cleanup()


def _mesh_executor(torch, np, mesh):
    """Phase 12(d): see the block comment above."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.executor import MeshExecutor, mesh_policy, vec

    rng = np.random.default_rng(SEED + 9)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, size=STREAM_N).astype(np.float32))
    gpu = x.cuda()
    mag = x.abs().double()
    policy = mesh_policy(mesh, "data")
    check(isinstance(policy.executor, MeshExecutor) and policy.kind == "mesh",
          "mesh executor: mesh_policy")
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device="cuda")
    runtime = REPORT["runtime"]["algorithms"]["card"]
    out = {"N": STREAM_N, "sum_rtol": RUNTIME_SUM_RTOL, "algorithms": {},
           "triad_GB_per_s": REPORT.get("stream", {}).get("float32", {}).get("GB_per_s")}
    for name, call, units, kind in _runtime_algos():
        if name not in MESH_ALGOS:
            continue
        got = call(alg, policy, gpu)
        want = call(alg, vec, gpu)
        if name == "transform":
            check(type(got).__name__ == "DTensor" and got.to_local().is_cuda,
                  "mesh executor: transform did not come back a DTensor on the card")
            got = got.full_tensor()
        err = _held(torch, got, want, kind, mag, name, "mesh vs vec")
        del got, want
        ms = _time_ms(torch, lambda: call(alg, policy, gpu), flush, reps=RUNTIME_REPS)
        nbytes = units * STREAM_N * x.element_size()
        vec_ms = runtime.get(f"{name} float32", {}).get("ms")
        out["algorithms"][name] = {"ms": ms, "bytes": nbytes, "GB_per_s": nbytes / ms / 1e6,
                                   "vec_ms": vec_ms, "err": err}
    log(f"[mesh executor] 2²⁷ fp32 on the 1-rank mesh, GB/s (vec ms): "
        f"{ {k: (round(v['GB_per_s'], 1), v['vec_ms'] and round(v['vec_ms'], 3)) for k, v in out['algorithms'].items()} }"
        f" beside the triad's {out['triad_GB_per_s']}")
    del gpu
    return out


def phase_mesh(torch, np, card):
    """Phase 12, the device plane: see the block comment above.  Returns
    the launches of (b)'s training path."""
    from repro_torch.launch import mesh as mesh_mod

    mesh_mod.init_process_group(0, 1, "cuda")
    try:
        mesh = mesh_mod.make_mesh_shape((1, 1), ("data", "model"))
        pod_mesh = mesh_mod.make_mesh_shape((1, 1, 1), ("pod", "data", "model"))
        seconds = {}
        t0 = time.perf_counter()
        parity = _mesh_parity(torch, mesh)
        seconds["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train, launches = _mesh_train(torch, card, mesh, pod_mesh)
        seconds["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore = _mesh_restore(torch, mesh)
        seconds["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        execs = _mesh_executor(torch, np, mesh)
        seconds["d"] = time.perf_counter() - t0
        REPORT["mesh"] = {"card": card, "parity": parity, "train": train,
                          "restore": restore, "executor": execs, "seconds": seconds}
        log(f"[mesh] seconds {({k: round(v, 1) for k, v in seconds.items()})}")
        return launches
    finally:
        mesh_mod.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 13
# The dry run on the card (``launch/dryrun.py``): the kernels are torch
# ops, so a step traces on fake CUDA tensors (``FakeTensorMode``) with each
# op's fake implementation, on a ``fake`` process group, and nothing
# launches.  (a) full starcoder2_3b at phase 12(b)'s shape on a fake
# ("pod", "data", "model") 1×1×1 mesh under phase 12(b)'s plan: exactly 30
# flash-op calls a step and as many bf16 all-reduces a step as phase 12(b)
# counted; the predicted peak (MemTracker) beside phase 12(b)'s and 8b's
# measured peaks, the roofline's compute and memory terms beside 8b's
# step.  (b) one paged decode step at phase 5's engine shape (B=8, 1024
# tokens a slot, pages of 16), traced, against one real step of the same
# shapes: the decode-kernel op calls equal the real step's launch counts.
# (c) ``launch/dryrun.py``'s CLI for starcoder2_3b train_4k on the
# 256-rank production mesh, the card's route, in a process of its own
# started before phase 12 (it runs on the host beside phases 12 and
# 13(a, b, d); the record lands in ``chiprun_out/dryrun_torch``): its trace
# time, predicted peak and roofline.  (d) real bf16 steps
# on a one-rank NCCL mesh against the same steps without one: a full
# mamba2_780m training step at 1,024 tokens (exact SSD launches, the loss
# within DRY_LOSS_TOL), and full recurrentgemma_2b prefill + 8 decode
# steps (exact RG-LRU, flash and dense-decode launches, equal greedy
# tokens).
DRY_LOSS_TOL = 2e-2
DRY_POD_TIMEOUT = 300  # s: 13(c)'s trace, from the end of (a, b, d)
DRY_MAMBA = (2, 512)            # (B, S) of (d)'s training step: 1,024 tokens
DRY_GRIFFIN = (2, 256, 8)       # (B, prompt, decode steps) of (d)'s serving


def _dry_train_trace(torch, card):
    """Phase 13(a): see the block comment above."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.dist.plan import get_plan
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model

    B, S, _ = TRAIN_RUN
    cfg = get_config("starcoder2_3b")
    model = Model(cfg, plan=get_plan("futurized", compress_pod_grads=True))
    cell = ShapeCell("phase_12b", S, B, "train")
    t0 = time.perf_counter()
    m = dryrun.measure_cell(model, cell, (1, 1, 1), ("pod", "data", "model"), model.device)
    secs = time.perf_counter() - t0
    rec = dryrun.cell_record("starcoder2_3b", cell, "1x1x1", "futurized+compress_pod_grads",
                             1, model, m)
    flash = rec["kernel_calls"].get("flash_attention", 0)
    bf16 = dryrun.bf16_all_reduces(m["trace"])
    mesh12 = REPORT["mesh"]["train"]
    want_bf16 = mesh12["bf16_all_reduces"] // MESH_STEPS
    check(flash == cfg.num_layers and rec["kernel_calls"] == {"flash_attention": flash},
          f"dry train: kernel op calls {rec['kernel_calls']}, want {cfg.num_layers} flash")
    check(bf16 == want_bf16, f"dry train: {bf16} bf16 all-reduces a step traced, phase 12(b) "
                             f"counted {want_bf16}")
    roof = roofline.analyze(rec)
    b8 = REPORT["train"]
    out = {"card": card, "arch": cfg.name, "batch": B, "seq": S, "mesh": "1x1x1",
           "trace_s": secs, "kernel_calls": rec["kernel_calls"], "bf16_all_reduces": bf16,
           "predicted_peak_bytes": rec["memory"]["peak_size_in_bytes"],
           "argument_bytes": rec["memory"]["argument_size_in_bytes"],
           "phase_12b_peak_bytes": mesh12["max_memory_allocated_bytes"],
           "phase_8b_peak_bytes": b8["max_memory_allocated_bytes"],
           "flops": rec["hlo_flops_per_device"], "hbm_traffic": rec["hbm_traffic_per_device"],
           "compute_s": roof.compute_s, "memory_s": roof.memory_s,
           "collective_s": roof.collective_s, "bottleneck": roof.bottleneck,
           "phase_8b_step_p50_s": b8["step_p50_s"], "comm_counts": rec["comm_counts"]}
    log(f"[dry train] {card}: {cfg.name} B={B}, S={S} traced on fake CUDA tensors on a fake "
        f"1×1×1 pod mesh in {secs:.1f} s: {flash} flash-op calls, {bf16} bf16 all-reduces a "
        f"step (phase 12(b): {want_bf16}); predicted peak "
        f"{out['predicted_peak_bytes'] / 2**30:.2f} GiB (arguments "
        f"{out['argument_bytes'] / 2**30:.2f}) beside phase 12(b)'s measured "
        f"{out['phase_12b_peak_bytes'] / 2**30:.2f} GiB and 8b's "
        f"{out['phase_8b_peak_bytes'] / 2**30:.2f} GiB; roofline compute "
        f"{roof.compute_s * 1e3:.1f} ms, memory {roof.memory_s * 1e3:.1f} ms "
        f"({roof.bottleneck}-bound) beside 8b's measured step "
        f"{b8['step_p50_s'] * 1e3:.1f} ms")
    return out


def _dry_decode_trace(torch, card):
    """Phase 13(b): see the block comment above."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.dist import hlo_analysis as H
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    B, T, page = 8, 1024, 16
    maxp = T // page
    model = Model(get_config("starcoder2_3b"))
    params = model.init_compute(SEED)
    specs = model.paged_cache_specs(B * maxp + 1, page, B, maxp)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype, device="cuda") for k, s in specs.items()}
    cache["page_table"] = (1 + torch.arange(B * maxp, dtype=torch.int32, device="cuda")
                           ).reshape(B, maxp)
    cache["pos"] = torch.tensor([16 + 120 * b for b in range(B)], dtype=torch.int32,
                                device="cuda")
    token = torch.zeros(B, 1, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        ops.reset_launch_counts()
        model.decode_paged(params, cache, token)
        torch.cuda.synchronize()
        real = {k: v for k, v in ops.launch_counts().items() if v}
        with FakeTensorMode(allow_non_fake_inputs=True) as fake:
            fp = {k: fake.from_tensor(v) for k, v in params.items()}
            fc = {k: fake.from_tensor(v) for k, v in cache.items()}
            t0 = time.perf_counter()
            _out, an, _trace = H.profile(model.decode_paged, fp, fc, fake.from_tensor(token))
            secs = time.perf_counter() - t0
    check(ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), **real},
          "dry decode: the trace launched a kernel")
    check(an.kernel_calls == real, f"dry decode: op calls {an.kernel_calls} traced, "
                                   f"{real} launched by one real step")
    out = {"batch": B, "cache_len": T, "page": page, "trace_s": secs,
           "kernel_calls": an.kernel_calls, "launches": real, "flops": an.dot_flops,
           "hbm_traffic": an.memory_traffic}
    log(f"[dry decode] {card}: one paged decode step at phase 5's engine shape traced in "
        f"{secs:.2f} s: op calls {an.kernel_calls} = one real step's launches {real}; "
        f"{an.dot_flops / 1e9:.2f} GFLOP, {an.memory_traffic / 1e9:.2f} GB of traffic predicted")
    del params, cache
    return out


DRY_POD = {}  # 13(c)'s process, started before phase 12


def start_dry_pod_cell():
    """Start phase 13(c)'s trace, ``launch.dryrun``'s CLI in a process of
    its own on the card's route (the host's cores are otherwise idle
    through phase 12's single-threaded dispatch): it runs beside phases 12
    and 13(a, b, d), and 13(c) joins it."""
    out = ROOT / "chiprun_out" / "dryrun_torch"
    out.mkdir(parents=True, exist_ok=True)
    log_f = open(out / "starcoder2_3b__train_4k__pod.log", "w")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    DRY_POD.update(t0=time.perf_counter(), out=out, log=log_f, proc=subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "starcoder2_3b",
         "--shape", "train_4k", "--mesh", "pod", "--out", str(out), "--force"],
        cwd=ROOT, env=env, stdout=log_f, stderr=subprocess.STDOUT))


def stop_dry_pod_cell():
    """Stop 13(c)'s process if it still runs (a failed phase before it)."""
    proc = DRY_POD.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    if "log" in DRY_POD:
        DRY_POD["log"].close()


def _dry_pod_cell(torch, card):
    """Phase 13(c): see the block comment above."""
    from repro_torch.analysis import roofline

    proc = DRY_POD["proc"]
    try:
        rc = proc.wait(timeout=DRY_POD_TIMEOUT)
    finally:
        stop_dry_pod_cell()
    secs = time.perf_counter() - DRY_POD["t0"]
    check(rc == 0, f"dry pod cell: the trace exited {rc}; see "
                   f"{DRY_POD['out'] / 'starcoder2_3b__train_4k__pod.log'}")
    rec = json.loads((DRY_POD["out"] / "starcoder2_3b__train_4k__pod__futurized.json"
                      ).read_text())
    roof = roofline.analyze(rec)
    check(rec["kernel_calls"] == {"flash_attention": 30} and rec["device"] == "cuda",
          f"dry pod cell: kernel op calls {rec['kernel_calls']} on {rec['device']}")
    out = {"seconds": secs, "trace_s": rec["compile_s"], "record": rec,
           "roofline": {k: getattr(roof, k) for k in ("compute_s", "memory_s", "collective_s",
                                                      "bottleneck", "useful_ratio",
                                                      "roofline_fraction")}}
    log(f"[dry pod] {card}: starcoder2_3b train_4k on the fake 256-rank pod mesh, the card's "
        f"route, traced in {rec['compile_s']:.1f} s ({secs:.1f} s from its start before phase "
        f"12 to its end): predicted peak "
        f"{rec['memory']['peak_size_in_bytes'] / 2**30:.1f} GiB a rank, "
        f"{rec['collectives']['count']} collectives, roofline compute "
        f"{roof.compute_s:.3f} s, memory {roof.memory_s:.3f} s, collective "
        f"{roof.collective_s:.3f} s ({roof.bottleneck}-bound)")
    return out


def _dry_mesh_steps(torch, card):
    """Phase 13(d): see the block comment above.  Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import migration
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.hybrid import _pattern
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    mesh_mod.init_process_group(0, 1, "cuda")
    total = dict.fromkeys(ops.KERNELS, 0)
    try:
        mesh = mesh_mod.make_mesh_shape((1, 1), ("data", "model"))
        cfg = get_config("mamba2_780m")
        model = Model(cfg)
        B, S = DRY_MAMBA
        batch = {k: v.cuda() for k, v in
                 synth_batch(cfg, DataConfig(batch_size=B, seq_len=S, seed=SEED), 0).items()}
        losses = {}
        for on_mesh in (False, True):
            params = model.init(SEED)
            opt = adamw.init(params)
            if on_mesh:
                p_sh, o_sh = step_mod.train_state_shardings(model, mesh)
                placed = migration.migrate_tree({"params": params, "opt": opt},
                                                {"params": p_sh, "opt": o_sh}, mesh)
                params, opt = placed["params"], placed["opt"]
            step = step_mod.make_train_step(model, adamw.AdamWConfig(**TRAIN_OPT),
                                            mesh if on_mesh else None)
            ops.reset_launch_counts()  # ← (d)'s training path, each side
            _p, _o, met = step(params, opt, batch)
            loss = met["loss"]
            losses[on_mesh] = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                                    else loss)
            launches = ops.launch_counts()  # ← and its end
            _check_launches(f"dry mesh {cfg.name} (mesh {on_mesh})", launches,
                            {"ssd_scan": cfg.num_layers})
            total = {k: total[k] + launches[k] for k in total}
            del params, opt, _p, _o
            gc.collect()
            torch.cuda.empty_cache()
        err = abs(losses[True] - losses[False])
        check(math.isfinite(losses[True]) and err <= DRY_LOSS_TOL,
              f"dry mesh {cfg.name}: loss {losses[True]} on the mesh, {losses[False]} without")

        gcfg = get_config("recurrentgemma_2b")
        gmodel = Model(gcfg)
        Bg, P, steps = DRY_GRIFFIN
        prompt = synth_batch(gcfg, DataConfig(batch_size=Bg, seq_len=P, seed=SEED), 0)
        prompt = {"tokens": prompt["tokens"][:, :P].cuda()}
        decode = step_mod.make_decode_step(gmodel)
        attn_layers = _pattern(gcfg)[0]  # one a (rec, rec, attn) group
        rec_layers = gcfg.num_layers - attn_layers
        tokens = {}
        for on_mesh in (False, True):
            params = gmodel.init_compute(SEED)
            inputs = prompt
            if on_mesh:  # "unembed" is no param: made from the table at each step
                params.pop("unembed")
                p_sh = step_mod.train_state_shardings(gmodel, mesh)[0]
                params = migration.migrate_tree(params, p_sh, mesh)
                inputs = step_mod.place_batch(gmodel, mesh, prompt)
            ops.reset_launch_counts()  # ← (d)'s serving path, each side
            with torch.no_grad():
                logits, cache = gmodel.prefill(params, inputs)
                logits = gmodel.plan.constrain(logits, ("batch", None))
                tok = logits.argmax(-1).to(torch.int32)[:, None]
                seq = [tok.full_tensor() if hasattr(tok, "full_tensor") else tok]
                for _ in range(steps):
                    tok, cache = decode(params, cache, tok)
                    seq.append(tok.full_tensor() if hasattr(tok, "full_tensor") else tok)
            torch.cuda.synchronize()
            launches = ops.launch_counts()  # ← and its end
            _check_launches(f"dry mesh {gcfg.name} (mesh {on_mesh})", launches,
                            {"rglru_scan": rec_layers, "flash_attention": attn_layers,
                             "decode_attention": attn_layers * steps})
            total = {k: total[k] + launches[k] for k in total}
            tokens[on_mesh] = torch.cat(seq, 1).cpu()
            del params, cache
            gc.collect()
            torch.cuda.empty_cache()
        check(torch.equal(tokens[True], tokens[False]),
              f"dry mesh {gcfg.name}: greedy tokens on the mesh differ from without")
        out = {"mamba_loss": losses, "mamba_loss_err": err, "loss_tol": DRY_LOSS_TOL,
               "griffin_tokens": tokens[True].tolist(), "launches": total}
        log(f"[dry mesh] {card}: {cfg.name} B={B}, S={S} one bf16 step on a 1×1 NCCL mesh: "
            f"loss {losses[True]:.5f} (without {losses[False]:.5f}, err {err:.3g}, tol "
            f"{DRY_LOSS_TOL}); {gcfg.name} prefill of {Bg}×{P} + {steps} decode steps on the "
            f"mesh: greedy tokens equal; launches {total}")
        return out, total
    finally:
        mesh_mod.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def phase_dryrun(torch, np, card):
    """Phase 13, the dry run on the card: see the block comment above.
    Returns the launches of (d)'s paths."""
    seconds = {}
    try:
        t0 = time.perf_counter()
        train = _dry_train_trace(torch, card)
        seconds["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        decode = _dry_decode_trace(torch, card)
        seconds["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        steps, launches = _dry_mesh_steps(torch, card)
        seconds["d"] = time.perf_counter() - t0
    except BaseException:
        stop_dry_pod_cell()
        raise
    t0 = time.perf_counter()
    pod = _dry_pod_cell(torch, card)
    seconds["c, waiting"] = time.perf_counter() - t0
    REPORT["dryrun"] = {"card": card, "train": train, "decode": decode, "pod": pod,
                        "mesh_steps": steps, "seconds": seconds}
    log(f"[dryrun] seconds {({k: round(v, 1) for k, v in seconds.items()})}")
    return launches


# ----------------------------------------------------------------- phase 14
# The reference's last entry points, ported as examples/*_torch.py, on the
# card.  The tiled Cholesky at the paper's scale for one card: N = 16,384
# in tiles of 1,024 (16 a side: 16 potrf, 120 trsm, 120 syrk, 560 gemm), fp32
# with TF32 off, against one torch.linalg.cholesky call on the same matrix,
# X·Xᵀ + N·I with X standard normal from seed 0 (bench_cholesky.py's).
CHOLESKY = (16384, 1024)
CHOLESKY_RTOL = 1e-5          # max|L − L_lib| / max|L_lib|
CHOLESKY_REPS = 3             # timed calls of each, after one warm-up


def _example(name):
    """``examples/<name>.py`` as a module (examples/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _examples_quickstart(torch):
    """``quickstart_torch.main`` on the card: its values as the reference's."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _example("quickstart_torch").main([])
    lines = buf.getvalue().splitlines()
    for want in ("future chain: 42", "dataflow DAG: 42", "task graph: 10",
                 "par reduce: 499500", "reduce on the io pool: 499500",
                 "par_task sort is a Future: [1, 2, 3]", "vec transform_reduce: 332833500",
                 "parcel result: 32.0"):
        check(want in lines, f"quickstart: no line {want!r} in {lines}")
    log(f"[examples] quickstart_torch on cuda: {len(lines)} lines, every value as the "
        f"reference's")
    return lines


def _examples_serve_lm(torch):
    """``serve_lm_torch.main`` (one process, two replicas of the qwen25_3b
    smoke config) on the card: 10 streamed requests of 13 tokens, token ids
    in the vocab, both engines serving (their token counters, which earlier
    phases' engines of the same names also moved, read before and after),
    exactly 2 flash launches a request (2 layers, one prefill each) and
    paged decodes in pairs, nothing else."""
    import repro_torch.core as core
    from repro_torch.kernels import ops

    names = [f"/serve{{engine#{i}}}/tokens/generated" for i in range(2)]
    before = [dict(core.counters.query(n)).get(n, 0.0) for n in names]
    ops.reset_launch_counts()  # ← the example's path starts here
    t0 = time.perf_counter()
    report = _example("serve_lm_torch").main([])
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()  # ← and ends here
    served = [core.counters.get_value(n) - b for n, b in zip(names, before)]
    reqs = report["requests"]
    check(len(reqs) == 10 and all(len(o) == 13 and all(0 <= t < 512 for t in o)
                                  for _, _, o in reqs), f"serve_lm: requests {reqs}")
    check(all(v > 0 for v in served) and sum(served) == 130,
          f"serve_lm: tokens by engine {served}, not 130 over both")
    decodes = launches["paged_decode_attention"]
    check(decodes > 0 and decodes % 2 == 0, f"serve_lm: launches {launches}")
    _check_launches("serve_lm", launches, {"flash_attention": 20,
                                           "paged_decode_attention": decodes})
    log(f"[examples] serve_lm_torch on cuda: 10 requests in {report['seconds']:.2f} s "
        f"({wall:.2f} s with setup); tokens by engine {served}; launches {launches}")
    return {"seconds": report["seconds"], "wall_s": wall, "launches": launches,
            "tokens_by_engine": served}


def _examples_cholesky(torch, np, card):
    """The dataflow tiled Cholesky against ``torch.linalg.cholesky``:
    max|L − L_lib| / max|L_lib| ≤ CHOLESKY_RTOL and exactly the DAG's 816
    tasks executed by the default pool, each call; the median host time of
    CHOLESKY_REPS calls of each, ending in a synchronize, and one dataflow
    call's device-busy share under torch.profiler (reported)."""
    import repro_torch.core as core

    mod = _example("tiled_cholesky_torch")
    N, tile = CHOLESKY
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((N, N))
                         .astype(np.float32)).cuda()
    A = X @ X.T + N * torch.eye(N, device="cuda")
    del X
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    want_tasks = mod.tile_tasks(N // tile)
    executed = "/scheduler{default}/tasks/executed"

    def timed(fn):
        times, out = [], None
        for _ in range(CHOLESKY_REPS + 1):  # the first a warm-up
            del out
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return out, times

    core.init(num_workers=4)
    try:
        tasks = []

        def dataflow_call():
            before = core.counters.get_value(executed)
            L = mod.tiled_cholesky(A, tile, "cuda")
            tasks.append(int(core.counters.get_value(executed) - before))
            return L

        L_lib, lib_s = timed(lambda: torch.linalg.cholesky(A))
        L, flow_s = timed(dataflow_call)
        prof = _device_profile(torch, dataflow_call, 1)
    finally:
        core.finalize()
    err = ((L - L_lib).abs().max() / L_lib.abs().max()).item()
    check(err <= CHOLESKY_RTOL,
          f"tiled cholesky: max|L − L_lib| / max|L_lib| = {err} (tol {CHOLESKY_RTOL})")
    check(want_tasks == 816 and tasks == [816] * (CHOLESKY_REPS + 3),
          f"tiled cholesky: tasks executed {tasks}, not {want_tasks} each")
    lib, flow = statistics.median(lib_s[1:]), statistics.median(flow_s[1:])
    gflop = N ** 3 / 3 / 1e9
    out = {"card": card, "N": N, "tile": tile, "dtype": "float32", "tf32": False,
           "tasks": tasks, "rel_err": err, "rtol": CHOLESKY_RTOL,
           "library_s": lib_s, "dataflow_s": flow_s, "library_p50_s": lib,
           "dataflow_p50_s": flow, "ratio": flow / lib,
           "library_gflops": gflop / lib, "dataflow_gflops": gflop / flow,
           "build_matrix_s": build_s, "profile_dataflow": prof}
    log(f"[cholesky] {card}: N={N}, tile {tile} ({N // tile}² tiles), fp32, TF32 off: "
        f"dataflow {flow * 1e3:.1f} ms ({gflop / flow:.0f} GFLOP/s, {want_tasks} tasks) vs "
        f"torch.linalg.cholesky {lib * 1e3:.1f} ms ({gflop / lib:.0f} GFLOP/s), ratio "
        f"{flow / lib:.3f}; max|L − L_lib| / max|L_lib| {err:.3g} (tol {CHOLESKY_RTOL}); "
        f"times (warm-up first) {[round(t * 1e3, 1) for t in flow_s]} / "
        f"{[round(t * 1e3, 1) for t in lib_s]} ms")
    busy = ("device time not measured (the profiler saw none)" if prof["device_ms"] is None
            else f"device busy {prof['device_ms']:.1f} ms ({100 * prof['busy_share']:.1f}%), "
                 f"{prof['kernels_per_call']:.0f} kernels, kinds "
                 f"{ {g: round(t, 1) for g, t in prof['groups_ms'].items()} }")
    log(f"[cholesky] one dataflow call: wall {prof['wall_ms']:.1f} ms, {busy}")
    del A, L, L_lib
    torch.cuda.empty_cache()
    return out


def phase_examples(torch, np, card):
    """Phase 14: ``quickstart_torch`` and ``serve_lm_torch`` (one process)
    on the card, then ``tiled_cholesky`` at CHOLESKY against the library
    call.  Returns the serve_lm path's launches."""
    out = {"quickstart": _examples_quickstart(torch)}
    out["serve_lm"] = _examples_serve_lm(torch)
    out["cholesky"] = _examples_cholesky(torch, np, card)
    REPORT["examples"] = out
    return out["serve_lm"]["launches"]


def main() -> int:
    # the caching allocator grows segments in place instead of keeping
    # freed blocks of fixed-size segments apart: phase 8c's 16,384-token
    # step of granite_moe_3b_a800m (3.3 B params, ~69 GiB live at its
    # peak) otherwise finds its reserved memory split too finely for its
    # 3.75 GiB stacked expert gradients.  Set before CUDA starts.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    seconds = REPORT.setdefault("phase_seconds", {})

    def timed(name, fn, *args):
        """Run a phase; its wall seconds go into the report."""
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    card = phase_device(torch)
    timed("2", phase_build)
    timings = timed("3", phase_kernels, torch, np)
    timed("4", phase_parity, torch, np)
    timed("4b", phase_parity_families, torch, np)
    timed("4c", phase_parity_moe, torch, np)
    timed("4d", phase_parity_encdec_vlm, torch, np)
    timed("4e", phase_parity_dense, torch, np)
    # each path's launches (counts set to 0 just before it, read just
    # after), summed over the paths
    paths = [timed("5-6", phase_serve, torch, np, card),
             timed("5c", phase_serve_moe, torch, np, card),
             timed("5b", phase_serve_families, torch, np, card),
             timed("5d", phase_serve_encdec_vlm, torch, np, card),
             timed("5e", phase_serve_dense, torch, np, card),
             timed("7", phase_ops, torch, np, card, timings)]
    timed("8a", phase_train_parity, torch, np)
    paths.append(timed("8b", phase_train, torch, np, card))
    timed("8 checkpoint", phase_train_checkpoint, torch, np)
    paths.append(timed("8c", phase_train_families, torch, np, card))
    paths.append(timed("8d", phase_train_families, torch, np, card, TRAIN_ENCDEC_VLM,
                       "train_encdec_vlm"))
    paths.append(timed("9", phase_runtime, torch, np, card))
    paths.append(timed("10", phase_serve_localities, torch, np, card))
    paths.append(timed("11", phase_data, torch, np, card))
    start_dry_pod_cell()  # 13(c), beside phases 12 and 13
    try:
        paths.append(timed("12", phase_mesh, torch, np, card))
    except BaseException:
        stop_dry_pod_cell()
        raise
    paths.append(timed("13", phase_dryrun, torch, np, card))
    paths.append(timed("14", phase_examples, torch, np, card))
    log(f"[time] {card}: phase seconds "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }, {sum(seconds.values()):.1f} in all")
    launches = {k: sum(p.get(k, 0) for p in paths) for k in paths[0]}

    kernels = []
    csrc, ref = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
    for name, source, replaces in (
            ("flash_attention", "flash_attention.cu", "flash_attention.py:90"),
            ("paged_decode_attention", "paged_decode_attention.cu",
             "decode_attention.py:156"),
            ("decode_attention", "decode_attention.cu", "decode_attention.py:85"),
            ("ssd_scan", "ssd_scan.cu", "ssd_scan.py:69"),
            ("rglru_scan", "rglru_scan.cu", "rglru_scan.py:43"),
            ("stream_triad", "stream.cu", "stream.py:24")):
        main_shape = timings[name][MAIN_ROW.get(name, 0)]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": ref + replaces,
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
