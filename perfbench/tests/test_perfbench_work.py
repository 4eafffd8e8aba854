"""The benchmark's work formulas against counts by hand at small shapes."""

import pytest

from perfbench import work

DENSE = {"d_model": 8, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "head_dim": 2,
         "d_ff": 16, "vocab_size": 10, "glu": False}
MOE = {"d_model": 8, "num_layers": 3, "num_heads": 2, "num_kv_heads": 2, "head_dim": 4,
       "d_ff": 4, "vocab_size": 10, "glu": True, "n_experts": 6, "top_k": 2,
       "n_shared_experts": 1, "first_dense": 1, "dense_d_ff": 12}
PEAKS = {"bf16_flops": 1e12, "hbm_bytes": 1e9}


def test_dense_prefill_by_hand():
    # a token: q 8x8, k and v 8x4 each, o 8x8, MLP 8x16 and 16x8, two layers
    per_token = 2 * (64 + 2 * 32 + 64 + 128 + 128) * 2
    assert work.linear_flops_per_token(DENSE) == per_token
    n = 5  # 15 causal pairs, 4·Dh·H = 32 a pair a layer
    assert work.prefill_flops(DENSE, n) == n * per_token + 2 * 15 * 32 + 2 * 8 * 10


def test_moe_counts_activated_experts():
    attn = 2 * (8 * 8 + 2 * 8 * 8 + 8 * 8)
    dense_layer = attn + 2 * 8 * 12 * 3
    moe_layer = attn + 2 * 8 * 6 + 2 * 2 * 3 * 8 * 4 + 2 * 3 * 8 * 4
    assert work.linear_flops_per_token(MOE) == dense_layer + 2 * moe_layer


def test_train_step_is_three_forwards_with_logits_everywhere():
    fwd = 4 * work.linear_flops_per_token(DENSE) + work.attention_flops(DENSE, 10) \
        + work.unembed_flops(DENSE, 4)
    assert work.train_step_flops(DENSE, rows=3, seq=4) == 3 * 3 * fwd


def test_flash_forward_bound():
    flops, nbytes = work.flash_fwd(B=1, S=4, H=2, KV=1, Dh=8)
    assert flops == 4 * 8 * 2 * 10
    assert nbytes == 2 * 4 * 8 * (2 * 2 + 2 * 1)
    assert work.flash_fwd(1, 4, 2, 1, 8, causal=False)[0] == 4 * 8 * 2 * 16
    assert work.bound_s(flops, nbytes, PEAKS) == pytest.approx(max(flops / 1e12, nbytes / 1e9))


def test_attention_backward_is_five_products():
    flops, nbytes = work.attn_bwd(B=2, S=3, H=2, KV=1, Dh=4)
    assert flops == 10 * 4 * 2 * 2 * 6
    assert nbytes == 2 * 2 * 3 * 4 * ((4 + 2) + (2 + 2))


def test_paged_decode_reads_live_rows_once():
    flops, nbytes = work.paged_decode([5, 17, 1], H=4, KV=2, Dh=8, page=16)
    live = 23
    assert flops == 4 * 8 * 4 * live
    assert nbytes == 2 * (2 * 2 * 8 * live + 2 * 4 * 8 * 3) + 4 * (1 + 2 + 1)


def _flash_record(prefills):
    """A Record of prefills [(span start, end, worker, prompt_len, bucket,
    profiler thread, call times)] in a profiled stretch of 0–10 s: each
    call launches 1 ms of device time."""
    from perfbench import harness, profiling

    s = 1_000_000_000
    prof = profiling.Profile(t0_ns=0, t1_ns=10 * s, offset_ns=0)
    spans, corr = [], 0
    for start, end, worker, n, bucket, th, at in prefills:
        spans.append(("prefill", start, end, {"prompt_len": n, "thread": worker}))
        for t in at:
            corr += 1
            prof.host.append(("repro_torch::flash_attention", int(t * s), int(t * s) + 1000, th,
                              corr, [[1, bucket, 4, 8], [1, bucket, 2, 8]]))
            prof.device.append(("flash_kernel", int(t * s) + 2000, int(t * s) + 2000 + 10 ** 6,
                                corr))
    shape = {"num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "causal": True}
    return harness.Record(shape=shape, peaks={"bf16_flops": 1e12, "hbm_bytes": 1e9},
                          window=(0.0, 10.0), spans=spans, profile=prof)


def _flash_bound(n):
    return work.bound_s(*work.flash_fwd(1, n, 4, 2, 8, True),
                        {"bf16_flops": 1e12, "hbm_bytes": 1e9})


def _flash_reader():
    from perfbench import harness

    return harness.load_module(harness.ROOT / "layer_metrics"
                               / "flash_fwd_roofline.longprompt.py", "t_flash")


def test_flash_roofline_counts_valid_tokens_not_the_bucket():
    """Prefills of 1,100 and 3,000 tokens run in the 2,048 and 4,096
    buckets, overlapping on two workers (a call of the second falls in
    both spans); prefills that the stretch cuts at either end count with
    the calls that it holds."""
    rec = _flash_record([(1.0, 2.0, 101, 1100, 2048, 7, (1.1, 1.5, 1.9)),
                         (1.8, 2.5, 102, 3000, 4096, 8, (1.85, 2.1, 2.3)),
                         (9.5, 10.5, 101, 2000, 2048, 7, (9.6,)),
                         (-0.5, 0.3, 102, 1500, 2048, 8, (0.2,))])
    b = _flash_bound
    want = (3 * b(1100) + 3 * b(3000) + b(2000) + b(1500)) / 8e-3 * 100
    assert _flash_reader().read(rec) == pytest.approx(want)
    assert want < (3 * b(2048) + 3 * b(4096) + 2 * b(2048)) / 8e-3 * 100


def test_flash_roofline_tells_nested_prefills_apart():
    """A short prefill runs wholly inside a long one's span: its thread's
    calls all fall in both spans, and it is the worker left over."""
    rec = _flash_record([(1.0, 3.0, 101, 3900, 4096, 7, (1.2, 2.8)),
                         (1.5, 2.0, 102, 1030, 2048, 8, (1.6, 1.9))])
    want = (2 * _flash_bound(3900) + 2 * _flash_bound(1030)) / 4e-3 * 100
    assert _flash_reader().read(rec) == pytest.approx(want)
