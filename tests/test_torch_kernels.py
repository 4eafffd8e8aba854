"""The port's attention kernels (their plain versions, as a CPU tensor runs
them) against the reference's Pallas kernels in interpret mode and its
pure-jnp oracles, over the sweeps of ``test_kernels.py``; the flash
backward (``flash_attention_bwd``) against autograd through the plain
version and ``jax.vjp`` of the reference's oracle ``ref.mha``; and the
decode kernels' split-KV arithmetic (the split chooser, and the exact
combine of per-split partials written out in plain PyTorch) against the
same reference kernels.

Inputs are drawn with numpy from a seed and handed to both packages; bf16
inputs are rounded from the same fp32 draws on both sides (both round to
nearest even, so the bf16 values are identical).  Tolerances are
``test_kernels.py::_tol`` × 4: 2e-5·4 in fp32 (two fp32 softmax orders)
and 2e-2·4 in bf16 (outputs rounded to bf16 on each side).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention_fwd as r_flash_fwd
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (BLOCKS_PER_SM, CHUNK, DENSE_TILE,
                                                  decode_attention_plain, decode_splits,
                                                  split_ranges, tiles_per_split)
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels.flash_attention import (BK, HEAD_DIM_STEPS, STEP_COST, WG_ROWS,
                                                 _mask, consumer_tiles, flash_attention_bwd,
                                                 flash_attention_plain, flash_grid,
                                                 flash_mode, flash_modes, kv_tiles,
                                                 makespan, ring_stages, ring_tiles,
                                                 tile_masked, work_item)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (2e-2 if name == "bfloat16" else 2e-5) * 4


def _pair(x: np.ndarray, name: str):
    jd, td = DTYPES[name]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(port: torch.Tensor, want, atol: float):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("B,S,H,KV,Dh", [
    (1, 128, 4, 4, 64),   # MHA
    (2, 256, 4, 2, 64),   # GQA
    (1, 384, 8, 1, 32),   # MQA, odd seq multiples
    (2, 200, 4, 2, 64),   # the reference pads; the port masks the edge
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(B, S, H, KV, Dh, dtype, causal):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.standard_normal((B, S, H, Dh), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, KV, Dh), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, KV, Dh), np.float32), dtype)
    o = ops.flash_attention(qt, kt, vt, causal=causal)
    assert o.shape == (B, S, H, Dh) and o.dtype == qt.dtype
    _close(o, rops.flash_attention(qj, kj, vj, causal=causal), _tol(dtype))
    _close(flash_attention_plain(qt, kt, vt, causal=causal),
           rref.mha(qj, kj, vj, causal=causal), _tol(dtype))


def test_flash_attention_window():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 256, 4, 64), np.float32)
    k = rng.standard_normal((2, 256, 2, 64), np.float32)
    v = rng.standard_normal((2, 256, 2, 64), np.float32)
    o = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=64)
    # 1e-4, as test_kernels.py's window test: fp32 softmax in another order
    _close(o, rops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                   window=64), 1e-4)
    _close(o, rref.mha(*map(jnp.asarray, (q, k, v)), causal=True, window=64), 1e-4)


def _reference_flash(q, k, v, dtype, **masks):
    """The reference's TPU kernel in interpret mode on (B, S, heads, Dh)
    numpy inputs: rows (B·H, S, Dh) with K/V heads repeated per group."""
    B, S, H, Dh = q.shape

    def rows(x):
        x = np.repeat(x, H // x.shape[2], axis=2)
        return _pair(x.transpose(0, 2, 1, 3).reshape(B * H, S, Dh), dtype)[0]

    want = r_flash_fwd(rows(q), rows(k), rows(v), interpret=True, **masks)
    return np.asarray(want, np.float32).reshape(B, H, S, Dh).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("S,valid_len", [(256, 200), (256, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_valid_len_matches_reference(S, valid_len, dtype, causal):
    """K positions at or past ``valid_len`` are masked, as in the reference's
    TPU kernel called with ``valid_len`` directly (its wrapper only uses it
    for padding).  The reference takes (B·H, S, Dh) with K/V repeated per
    GQA group; every row keeps key 0, so no row is fully masked."""
    B, H, KV, Dh = 1, 4, 2, 64
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, S, H, Dh), np.float32)
    k = rng.standard_normal((B, S, KV, Dh), np.float32)
    v = rng.standard_normal((B, S, KV, Dh), np.float32)
    qt, kt, vt = (_pair(x, dtype)[1] for x in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, causal=causal, valid_len=valid_len)
    want = _reference_flash(q, k, v, dtype, causal=causal, valid_len=valid_len)
    _close(o, want, _tol(dtype))
    # the mask is live: attending to all S keys moves some output by more
    # than twice the loosest tolerance
    full = ops.flash_attention(qt, kt, vt, causal=causal)
    assert (full.float() - o.float()).abs().max().item() > 2 * _tol("bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_row_without_keys_gives_zeros(dtype, causal):
    """A window and ``valid_len`` together leave the rows at or past
    valid_len + window − 1 with no unmasked key.  The port gives zeros
    there (its kernel bodies do too: ``chip_smoke.py`` phase 3 holds them
    against this plain version), and the reference's output on every other
    row; the reference's own value in such a row depends on its tiling."""
    B, S, H, KV, Dh, window, valid_len = 1, 256, 4, 2, 64, 64, 100
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, S, H, Dh), np.float32)
    k = rng.standard_normal((B, S, KV, Dh), np.float32)
    v = rng.standard_normal((B, S, KV, Dh), np.float32)
    qt, kt, vt = (_pair(x, dtype)[1] for x in (q, k, v))
    masks = {"causal": causal, "window": window, "valid_len": valid_len}
    o = ops.flash_attention(qt, kt, vt, **masks)
    empty = ~_mask(S, causal, window, valid_len, torch.device("cpu")).any(-1)
    assert int(empty.sum()) == S - (valid_len + window - 1)
    assert (o[:, empty] == 0).all()
    keep = (~empty).numpy()
    _close(o[:, ~empty], _reference_flash(q, k, v, dtype, **masks)[:, keep], _tol(dtype))


# ------------------------------------------------- flash tile plan
def _walk(B, S, H, KV, Dh, causal, window, valid_len, sms):
    """The bf16 flash body's decisions on a card of ``sms`` SMs, as
    ``flash_attention.py`` writes them out and the kernel mirrors: per
    block, its work item, and per consumer warpgroup its positions, its K
    tiles and which of them take the elementwise mask.  ``sms`` is an int
    (the plan :func:`flash_grid` picks) or a :class:`FlashPlan` to walk."""
    plan = sms if isinstance(sms, tuple) else flash_grid(B, S, H, KV, Dh, sms, causal,
                                                         window)
    vl = valid_len or S
    for i in range(plan.blocks):
        b, kv, h0, p0 = work_item(i, B, H, KV, plan, causal)
        wgs = [(first, count, w0, w1,
                {t: tile_masked(S, first, count, t, causal, window, vl)
                 for t in range(w0, w1)})
               for first, count, w0, w1 in consumer_tiles(S, p0, plan, causal, window, vl)]
        yield plan, (b, kv, h0, p0), wgs


# Plans the tile tests walk: what flash_grid picks on 1 SM (the grid always
# covers the card: two consumers, shared) and on 132; and modes forced:
# split, and three consumers (head_dim 64 only; else two; head_dim 256 has
# one consumer, and three never split)
SMS = [1, 132, "split", "3shared"]


def _plan(B, S, H, KV, Dh, causal, window, sms):
    forced = {"split": (True, 2), "3shared": (False, 3)}
    if sms in forced:
        return flash_mode(B, S, H, KV, Dh, *forced[sms])
    return flash_grid(B, S, H, KV, Dh, sms, causal, window)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("H,KV,Dh", [(24, 2, 128), (4, 4, 64), (4, 1, 32), (10, 1, 256)])
@pytest.mark.parametrize("vl_kind", ["S", "S-1", "150"])
@pytest.mark.parametrize("window", [0, 1, 64, 128, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 16, 100, 130, 200, 512, 1000])
def test_flash_tile_plan_covers_the_mask(S, causal, window, vl_kind, H, KV, Dh, sms):
    """Against ``_mask``: every unmasked (q, k) pair lies in a tile that a
    consumer warpgroup holding its row walks; a walked tile left without
    the elementwise mask is wholly unmasked; the blocks' rows cover every
    (b, head, position) exactly once; split consumers cut the block's tiles
    in order, none walked twice, each its own ring entries; rows pack
    ``group`` heads of one KV group; and the order is heavy first (no
    block of a whole position tile walks more K tiles than one before it,
    give or take the one tile a window's edge can add), except for a
    causal window with ``valid_len`` < S (see ``work_item``)."""
    B = 2
    valid_len = {"S": 0, "S-1": S - 1, "150": min(150, S)}[vl_kind]
    vl = valid_len or S
    ok = _mask(S, causal, window, valid_len, torch.device("cpu")).expand(S, S).numpy()
    G = H // KV
    covered = np.zeros((B, H, S), np.int64)
    walked = np.zeros((S, -(-S // BK)), bool)  # [position, K tile]
    work = []
    for plan, (b, kv, h0, p0), wgs in _walk(B, S, H, KV, Dh, causal, window, valid_len,
                                            _plan(B, S, H, KV, Dh, causal, window, sms)):
        assert G % plan.group == 0 and len(wgs) == plan.consumers
        assert plan.positions * plan.group == WG_ROWS * (1 if plan.split else plan.consumers)
        assert kv * G <= h0 and h0 + plan.group <= (kv + 1) * G
        assert 0 <= p0 < S and p0 % plan.positions == 0
        spans = [(w0, w1) for _, _, w0, w1, _ in wgs if w0 < w1]
        t0, t1 = (min(a for a, _ in spans), max(e for _, e in spans)) if spans else (0, 0)
        ring = ring_tiles(t0, t1, plan)
        if plan.split:
            assert (t0, t1) == kv_tiles(S, p0, plan.positions, causal, window, vl) or not spans
            cuts = [(w0, w1) for _, _, w0, w1, _ in wgs]
            assert all(w0 <= w1 for w0, w1 in cuts)
            assert sum(w1 - w0 for w0, w1 in cuts) == t1 - t0
            assert all(c[1] == d[0] or d[0] == d[1] for c, d in zip(cuts, cuts[1:]))
            # consumer w's j-th tile is ring entry j·consumers + w, and no
            # entry is another's
            n = plan.consumers
            assert ring_stages(Dh) % n == 0  # entries e and e + stages are one consumer's
            assert sorted(j * n + w for w, (w0, w1) in enumerate(cuts)
                          for j in range(w1 - w0)) == list(range(len(ring)))
            assert all(ring[j * n + w] == w0 + j for w, (w0, w1) in enumerate(cuts)
                       for j in range(w1 - w0))
        else:
            assert ring == list(range(t0, t1))
        for w, (first, count, w0, w1, masked) in enumerate(wgs):
            rows = slice(first, min(first + count, S))
            if not plan.split or w == 0:
                covered[b, h0:h0 + plan.group, rows] += 1
            assert w1 <= walked.shape[1]
            for t, m in masked.items():
                walked[rows, t] = True
                if not m:
                    k0, k1 = t * BK, (t + 1) * BK
                    assert k1 <= vl and ok[rows, k0:k1].all(), (first, t)
        if p0 + plan.positions <= S:  # a ragged last position tile may walk fewer
            work.append(t1 - t0)
    assert (covered == 1).all()
    q, k = np.nonzero(ok)
    assert walked[q, k // BK].all()
    if not (causal and window and vl < S):
        # a window's edges fall anywhere in a tile: one tile of jitter
        later = np.maximum.accumulate(np.asarray(work[::-1] or [0]))[::-1]
        assert all(w >= m - (1 if window else 0) for w, m in zip(work, later))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("S,causal,H,KV,Dh,vl_kind", [
    (1500, False, 12, 12, 64, "S"),     # whisper_small's encoder: 1500 frames
    (1500, False, 12, 12, 64, "S-1"),
    (2048, False, 12, 12, 64, "S"),     # its encoder's training microbatch
    (64, True, 12, 12, 64, "S"),        # its decoder's prefill
    (512, True, 16, 8, 128, "S"),       # internvl2_2b's prefill (G = 2)
    (512, True, 16, 8, 128, "150"),     # a bucketed one
])
def test_flash_tile_plan_covers_the_new_families(S, causal, H, KV, Dh, vl_kind, sms):
    """``test_flash_tile_plan_covers_the_mask`` at the shapes the enc-dec
    and VLM families give the flash kernel: non-causal at S off the tile
    with one head per group, and two heads per group at head_dim 128."""
    test_flash_tile_plan_covers_the_mask(S, causal, 0, vl_kind, H, KV, Dh, sms)


def _tile_walk(q, k, v, causal, window, valid_len, sms):
    """The bf16 flash body's arithmetic in plain PyTorch (fp32): each
    consumer warpgroup walks its K tiles in order with an online softmax,
    masking only the tiles ``tile_masked`` marks (with −inf; a row max of
    −inf is taken as 0); split consumers' (m, l, O) are merged; O is
    divided by max(l, 1e-20)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    scale = 1.0 / Dh ** 0.5
    inf = float("inf")
    o = torch.zeros(B, S, H, Dh)
    ok = _mask(S, causal, window, valid_len, torch.device("cpu")).expand(S, S)  # [q, k]

    def merge(a, b):
        m, l, acc = a
        m1, l1, acc1 = b
        m_new = torch.maximum(m, m1)
        m_use = torch.where(m_new == -inf, 0.0, m_new)
        w0, w1 = torch.exp((m - m_use) * scale), torch.exp((m1 - m_use) * scale)
        return m_new, l * w0 + l1 * w1, acc * w0[..., None] + acc1 * w1[..., None]

    for plan, (b, kv, h0, p0), wgs in _walk(B, S, H, KV, Dh, causal, window, valid_len,
                                            _plan(B, S, H, KV, Dh, causal, window, sms)):
        states = []
        for w, (first, count, w0, w1, masked) in enumerate(wgs):
            if first >= S:
                continue
            pos = torch.arange(first, min(first + count, S))
            qs = q[b, pos, h0:h0 + plan.group].float()           # (P, g, Dh)
            m = torch.full(qs.shape[:2], -inf)
            l = torch.zeros(qs.shape[:2])
            acc = torch.zeros(qs.shape)
            for t in range(w0, w1):
                keys = torch.arange(t * BK, min((t + 1) * BK, S))
                s = torch.einsum("pgd,kd->pgk", qs, k[b, keys, kv].float())
                if masked[t]:
                    s = s.masked_fill(~ok[pos][:, keys][:, None, :], -inf)
                m_new = torch.maximum(m, s.amax(-1))
                m_use = torch.where(m_new == -inf, 0.0, m_new)
                alpha = torch.exp((m - m_use) * scale)
                p = torch.exp((s - m_use[..., None]) * scale)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("pgk,kd->pgd", p,
                                                             v[b, keys, kv].float())
                m = m_new
            states.append((w, pos, (m, l, acc)))
        if plan.split:  # one set of rows: merge the consumers' states
            _, pos, st = states[0]
            for _, _, st1 in states[1:]:
                st = merge(st, st1)
            states = [(0, pos, st)]
        for _, pos, (_, l, acc) in states:
            o[b, pos, h0:h0 + plan.group] = acc / l.clamp_min(1e-20)[..., None]
    return o


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,S,H,KV,Dh,causal,window,valid_len", [
    (1, 200, 24, 2, 32, True, 0, 0),     # 4 heads × 16 positions per block
    (2, 130, 4, 1, 16, False, 0, 70),    # valid_len across a tile edge
    (1, 300, 10, 1, 16, True, 65, 0),    # 2 heads per block, window off a tile
    (2, 260, 4, 4, 16, True, 0, 0),      # MHA: 1 head × 64 positions
    (1, 200, 10, 1, 256, True, 0, 90),   # head_dim 256: one warpgroup per block
    (1, 190, 2, 2, 64, False, 0, 0),     # whisper's encoder: MHA, non-causal, off the tile
    (1, 200, 4, 2, 128, True, 0, 150),   # internvl2_2b: G = 2 at head_dim 128, bucketed
    (1, 300, 2, 2, 64, True, 64, 100),   # rows with no unmasked key: zeros
])
def test_flash_tile_walk_matches_reference(B, S, H, KV, Dh, causal, window, valid_len,
                                           sms):
    """The tile walk (edge tiles masked, interior tiles not; two or three
    consumers sharing K/V tiles, or two cutting them and merging) gives the reference's Pallas
    kernel's output (interpret mode, K/V repeated per GQA group), fp32,
    at 4 × test_kernels.py's tolerance; rows with no unmasked key give
    zeros, as the plain version does (the reference's value there
    depends on its tiling)."""
    q, k, v, want = _walk_case(B, S, H, KV, Dh, causal, window, valid_len)
    o = _tile_walk(*map(torch.from_numpy, (q, k, v)), causal, window, valid_len, sms)
    _close(o, want, _tol("float32"))


@functools.lru_cache(maxsize=None)
def _walk_case(B, S, H, KV, Dh, causal, window, valid_len):
    """A tile-walk case's seeded inputs and the reference's output (one
    interpret-mode run, shared by the case's plans), zeros in the rows
    with no unmasked key."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, H, Dh), np.float32)
    k = rng.standard_normal((B, S, KV, Dh), np.float32)
    v = rng.standard_normal((B, S, KV, Dh), np.float32)
    Sp = -(-S // 128) * 128  # the reference takes whole 128-row blocks

    def rows(x):  # (B, S, heads, Dh) → (B·H, Sp, Dh), K/V heads repeated, zero-padded
        x = np.repeat(x, H // x.shape[2], axis=2).transpose(0, 2, 1, 3)
        x = np.pad(x, ((0, 0), (0, 0), (0, Sp - S), (0, 0)))
        return jnp.asarray(x.reshape(B * H, Sp, Dh))

    want = r_flash_fwd(rows(q), rows(k), rows(v), causal=causal, window=window,
                       valid_len=valid_len or S, interpret=True)
    want = np.array(want, np.float32).reshape(B, H, Sp, Dh)[:, :, :S].transpose(0, 2, 1, 3)
    empty = ~_mask(S, causal, window, valid_len, torch.device("cpu")).any(-1).numpy()
    want[:, empty] = 0.0
    return q, k, v, want


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("B,S,H,KV,Dh,causal,window", [
    (1, 1500, 12, 12, 64, False, 0),    # whisper_small's encoder
    (1, 2048, 12, 12, 64, False, 0),    # its training microbatch
    (1, 2048, 12, 12, 64, True, 0),
    (1, 64, 12, 12, 64, True, 0),       # its decoder's prefill
    (1, 512, 24, 2, 128, True, 0),      # starcoder2_3b's prefill
    (4, 2048, 24, 2, 128, True, 0),
    (1, 1000, 48, 1, 128, True, 0),     # granite_34b's (G = 48)
    (1, 2048, 10, 1, 256, True, 2048),  # recurrentgemma_2b's local attention
    (1, 256, 16, 2, 128, True, 0),      # qwen25_3b's prefill
    (2, 300, 4, 2, 64, False, 100),     # a non-causal window: unequal blocks
])
def test_flash_grid_picks_the_least_makespan(B, S, H, KV, Dh, causal, window, sms):
    """``makespan`` is the greedy list schedule of every mode's blocks, as
    simulated here from the blocks the kernel walks in its order (each the
    steps of its busiest consumer and a cost for each warpgroup of rows in
    range, an SM's first block paying the start and each later one the
    refill), its shortcuts for one round and for equal blocks included;
    ``flash_grid`` picks one of ``flash_modes``.  At whisper's
    encoder on 132 SMs it does not pick the 144-block shared grid, whose
    second wave holds 12 blocks, but 96 blocks of three consumers."""
    plan = flash_grid(B, S, H, KV, Dh, sms, causal, window)
    modes = flash_modes(B, S, H, KV, Dh)
    assert plan in modes and len(set(modes)) == len(modes)
    for m in modes:
        step = STEP_COST[m.consumers] * HEAD_DIM_STEPS[Dh]
        free = [tflash.BLOCK_STEPS - tflash.REFILL_STEPS] * min(sms, m.blocks)
        for _, _, wgs in _walk(B, S, H, KV, Dh, causal, window, 0, m):
            sm = free.index(min(free))
            rows = 1 if m.split else sum(first < S for first, *_ in wgs)
            free[sm] += (max(w1 - w0 for _, _, w0, w1, _ in wgs) * step + tflash.REFILL_STEPS
                         + tflash.ROW_STEPS * rows * HEAD_DIM_STEPS[Dh])
        assert makespan(m, S, Dh, causal, window, sms) == pytest.approx(max(free), abs=1e-9)
    if (B, S, H, KV, Dh, causal, sms) == (1, 1500, 12, 12, 64, False, 132):
        assert flash_mode(B, S, H, KV, Dh, False).blocks == 144
        assert plan.mode == "3shared" and plan.blocks == 96


def _paged_inputs(B, H, KV, Dh, page, maxp, seed=8):
    """Shuffled per-request page lists over a pool with spare pages; page 0
    is reserved, as in the serving cache."""
    rng = np.random.default_rng(seed)
    T = page * maxp
    q = rng.standard_normal((B, H, Dh), np.float32)
    k = rng.standard_normal((B, T, KV, Dh), np.float32)
    v = rng.standard_normal((B, T, KV, Dh), np.float32)
    P = B * maxp + 3
    perm = (1 + rng.permutation(P - 1)[: B * maxp].reshape(B, maxp)).astype(np.int32)
    k_pages = np.zeros((P, page, KV, Dh), np.float32)
    v_pages = np.zeros((P, page, KV, Dh), np.float32)
    for b in range(B):
        for j in range(maxp):
            k_pages[perm[b, j]] = k[b, j * page:(j + 1) * page]
            v_pages[perm[b, j]] = v[b, j * page:(j + 1) * page]
    lens = rng.integers(1, T + 1, size=B).astype(np.int32)
    return q, k, v, k_pages, v_pages, perm, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Dh,page,maxp", [
    (3, 4, 2, 64, 32, 8),   # GQA
    (2, 8, 8, 32, 16, 4),   # MHA, small pages
    (1, 8, 1, 64, 64, 4),   # MQA
])
def test_paged_decode_attention_matches_reference(B, H, KV, Dh, page, maxp, dtype):
    q, k, v, kp, vp, perm, lens = _paged_inputs(B, H, KV, Dh, page, maxp)
    qj, qt = _pair(q, dtype)
    kpj, kpt = _pair(kp, dtype)
    vpj, vpt = _pair(vp, dtype)
    kj, kt = _pair(k, dtype)
    vj, vt = _pair(v, dtype)
    o = ops.paged_decode_attention(qt, kpt, vpt, torch.from_numpy(perm),
                                   torch.from_numpy(lens))
    assert o.shape == (B, H, Dh) and o.dtype == qt.dtype
    _close(o, rops.paged_decode_attention(qj, kpj, vpj, jnp.asarray(perm),
                                          jnp.asarray(lens)), _tol(dtype))
    _close(o, rref.decode_mha(qj, kj, vj, length=jnp.asarray(lens)), _tol(dtype))
    # the paged plain version is the dense one on the gathered pages
    _close(decode_attention_plain(qt, kt, vt, torch.from_numpy(lens)),
           rref.decode_mha(qj, kj, vj, length=jnp.asarray(lens)), _tol(dtype))


def test_gather_paged_kv_matches_reference():
    rng = np.random.default_rng(10)
    P, page, KV, Dh = 10, 16, 2, 32
    kp = rng.standard_normal((P, page, KV, Dh), np.float32)
    vp = rng.standard_normal((P, page, KV, Dh), np.float32)
    pt = np.asarray([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    kg, vg = ops.gather_paged_kv(torch.from_numpy(kp), torch.from_numpy(vp),
                                 torch.from_numpy(pt))
    rk, rv = rops.gather_paged_kv(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt))
    assert kg.shape == (2, 4 * page, KV, Dh)
    np.testing.assert_array_equal(kg.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(vg.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(kg[0, :page].numpy(), kp[1])


def test_cpu_wrappers_count_no_launches():
    """Plain-version calls are not kernel launches."""
    ops.reset_launch_counts()
    x = torch.zeros(1, 16, 2, 16)
    ops.flash_attention(x, x, x)
    ops.decode_attention(x[:, 0], x, x, 3)
    ops.ssd_scan(x, x[..., 0], torch.zeros(2), x, x)
    ops.rglru_scan(x[0], x[0])
    ops.stream_triad(x[0, 0, 0], x[0, 0, 0])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert set(ops.KERNELS) == {"flash_attention", "paged_decode_attention",
                                "decode_attention", "ssd_scan", "rglru_scan",
                                "stream_triad"}


# ----------------------------------------------------- split-KV decode
@pytest.mark.parametrize("B,KV,extent,sm,tile,group", [
    (8, 2, 64, 132, 16, 12),      # serving: paged, page 16, maxp 64
    (8, 2, 16, 132, 64, 12),      # starcoder2_3b's dense cache, T = 1024
    (8, 2, 1024, 132, 16, 12),    # 16,384-token context, paged
    (4, 1, 32, 132, 64, 10),      # recurrentgemma_2b's local attention
    (1, 8, 4, 132, 16, 1),        # a 4-page table: one split
    (300, 2, 64, 132, 16, 12),    # more blocks than the card holds: one split
    (1, 1, 1000, 132, 24, 128),   # pages of 24 tokens, 8 m-tiles
    (2, 2, 7, 16, 32, 4),         # a small card, an extent that splits unevenly
    (8, 12, 24, 132, 64, 1),      # whisper_small's cross-attention, T = 1500
    (8, 12, 8, 132, 64, 1),       # its self-attention's 512-slot cache
    (8, 8, 64, 132, 16, 2),       # internvl2_2b, paged, page 16, maxp 64
])
def test_decode_splits_cover_whole_tiles(B, KV, extent, sm, tile, group):
    splits = decode_splits(B, KV, extent, sm, tile, group)
    ranges = split_ranges(extent, splits)
    assert splits >= 1 and len(ranges) == splits
    # contiguous, in order, whole tiles, none empty, covering the extent
    assert ranges[0][0] == 0 and ranges[-1][1] == extent
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))
    # the cut the launchers pass: what the C entry points accept
    tps = tiles_per_split(extent, splits)
    assert splits * tps >= extent > (splits - 1) * tps
    # one chunk of tokens at least, where the extent allows
    if splits > 1:
        assert (ranges[0][1] - ranges[0][0]) * tile >= CHUNK
        assert splits * B * KV * -(-group // 16) <= BLOCKS_PER_SM * sm
    else:
        assert extent * tile < 2 * CHUNK or B * KV * -(-group // 16) * 2 > BLOCKS_PER_SM * sm


def _split_combine(q, k, v, lens, tile, splits):
    """The kernels' split-KV arithmetic in plain PyTorch: each split's fp32
    (m, l, acc) over its tokens below the length (m = −1e30, l = 0, acc = 0
    where it has none), combined by log-sum-exp in split order."""
    B, H, Dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Dh)
    parts = []
    for t0, t1 in split_ranges(-(-T // tile), splits):
        lo, hi = t0 * tile, min(t1 * tile, T)
        s = torch.einsum("bkgd,btkd->bkgt", qf, k[:, lo:hi].float()) / Dh ** 0.5
        valid = (torch.arange(lo, hi)[None, :] < lens[:, None].long())[:, None, None, :]
        s = s.masked_fill(~valid, -1e30)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]) * valid
        parts.append((m, p.sum(dim=-1), torch.einsum("bkgt,btkd->bkgd", p,
                                                      v[:, lo:hi].float())))
    big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = sum(torch.exp(m - big) * l for m, l, _ in parts)
    acc = sum(torch.exp(m - big)[..., None] * a for m, _, a in parts)
    return (acc / l.clamp_min(1e-20)[..., None]).reshape(B, H, Dh).to(q.dtype)


# lengths on the split edges of 32, 64 and 128 tokens and ±1, a row of
# length 0, rows shorter than one split (the other splits empty), a full row
SPLIT_LENS = [0, 5, 31, 32, 33, 63, 64, 65, 127, 128, 129, 256]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_split_combine_matches_reference_dense(splits, dtype):
    B, T, H, KV, Dh = len(SPLIT_LENS), 256, 4, 2, 32
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng.standard_normal((B, H, Dh), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, T, KV, Dh), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, T, KV, Dh), np.float32), dtype)
    lens = np.asarray(SPLIT_LENS, np.int32)
    o = _split_combine(qt, kt, vt, torch.from_numpy(lens), DENSE_TILE, splits)
    want = rops.decode_attention(qj, kj, vj, jnp.asarray(lens))
    assert not np.asarray(o[0].float()).any()   # length 0: zeros
    _close(o, want, _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 4, 8])
def test_split_combine_matches_reference_paged(splits, dtype):
    B, H, KV, Dh, page, maxp = len(SPLIT_LENS), 8, 2, 32, 16, 16
    q, k, v, kp, vp, perm, _ = _paged_inputs(B, H, KV, Dh, page, maxp, seed=12)
    lens = np.asarray(SPLIT_LENS, np.int32)
    qj, qt = _pair(q, dtype)
    kpj, kpt = _pair(kp, dtype)
    vpj, vpt = _pair(vp, dtype)
    kg, vg = ops.gather_paged_kv(kpt, vpt, torch.from_numpy(perm))
    o = _split_combine(qt, kg, vg, torch.from_numpy(lens), page, splits)
    want = rops.paged_decode_attention(qj, kpj, vpj, jnp.asarray(perm), jnp.asarray(lens))
    assert not np.asarray(o[0].float()).any()
    _close(o, want, _tol(dtype))


# ------------------------------------------------- flash backward (training)
# B, S, H, KV, Dh, causal, window: GQA groups 1, 2 and 4, Dh 16 and 128,
# ragged S, windows, and no mask
BWD_CASES = [(2, 64, 4, 4, 16, True, 0), (1, 100, 4, 2, 16, True, 0),
             (2, 80, 8, 2, 16, True, 24), (1, 96, 4, 1, 128, True, 0),
             (1, 64, 4, 2, 128, True, 17), (2, 48, 8, 2, 16, False, 0)]


def _bwd_inputs(B, S, H, KV, Dh, dtype, seed=21):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s, np.float32), dtype)
            for s in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh), (B, S, H, Dh))]


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_autograd_and_reference(case, dtype):
    B, S, H, KV, Dh, causal, window = case
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _bwd_inputs(B, S, H, KV, Dh, dtype)
    got = flash_attention_bwd(qt, kt, vt, dot, causal, window)
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    want = torch.autograd.grad(
        flash_attention_plain(*leaves, causal=causal, window=window), leaves, dot)
    ref_grads = jax.jit(lambda a, b, c, d: jax.vjp(
        lambda a, b, c: rref.mha(a, b, c, causal=causal, window=window), a, b, c)[1](d))
    for g, w, r, x in zip(got, want, ref_grads(qj, kj, vj, doj), (qt, kt, vt)):
        assert g.shape == x.shape and g.dtype == x.dtype
        _close(g, w.float().numpy(), _tol(dtype))
        _close(g, r, _tol(dtype))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0), (False, 24)])
def test_flash_attention_bwd_query_blocks_match_one_block(monkeypatch, causal, window):
    """Walked in query blocks (each against the keys its mask reaches), the
    backward gives what one block gives."""
    B, S, H, KV, Dh = 2, 100, 4, 2, 16
    args = [t for _, t in _bwd_inputs(B, S, H, KV, Dh, "float32", seed=5)]
    whole = flash_attention_bwd(*args, causal, window)
    monkeypatch.setattr(tflash, "SCORE_BYTES", 4 * B * H * S * 16)  # 16 rows a block
    blocks = flash_attention_bwd(*args, causal, window)
    for a, b in zip(blocks, whole):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_flash_attention_trainable_is_the_forward_with_the_backward():
    B, S, H, KV, Dh = 1, 64, 4, 2, 16
    q, k, v, do = [t for _, t in _bwd_inputs(B, S, H, KV, Dh, "float32", seed=9)]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention_trainable(*leaves, True, 8)
    torch.testing.assert_close(o.detach(), ops.flash_attention(q, k, v, window=8),
                               atol=0, rtol=0)
    got = torch.autograd.grad(o, leaves, do)
    for a, b in zip(got, flash_attention_bwd(q, k, v, do, True, 8)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with torch.inference_mode():  # serving: nothing recorded
        assert not ops.flash_attention_trainable(q, k, v).requires_grad
