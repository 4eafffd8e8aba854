"""Flash attention forward: the Hopper kernel's launcher, its tile plan and
its plain PyTorch version; and its backward as PyTorch math
(:func:`flash_attention_bwd`), which ``ops.flash_attention_trainable``
pairs with the kernel forward for training.

The kernel (``csrc/flash_attention.cu``) replaces the reference's TPU
kernel ``repro/kernels/flash_attention.py::flash_attention_fwd``.  Unlike
the TPU kernel it takes the public layouts directly — q (B, S, H, Dh), k/v
(B, S, KV, Dh) — routes each q head to its KV head (kv = h // G) in its
indexing, and masks the ragged sequence edge itself, so nothing is
repeated per GQA group and nothing is padded.

Both functions compute softmax(q·kᵀ/√Dh + mask)·v with fp32 math and the
TPU kernel's masks: K positions at or past ``valid_len`` (0 means S),
causal (kpos ≤ qpos) and sliding window (kpos > qpos − window); the output
is acc / max(l, 1e-20) in q's dtype.  A row with no unmasked key at all
(only a window and ``valid_len`` together make one) gives zeros in the
plain version and in both kernel bodies; the TPU kernel gives the mean of
v over the tiles it walked there, which depends on its tiling.

The bf16 body packs ``group`` q heads of one KV group into the 64 rows of
a consumer warpgroup, row r = (position p0 + r // group, head h0 + r %
group), so each K/V tile it reads serves all of them.  A block is one
work item, one position tile of one head group; its consumers (two; one
at head_dim 256; two or three at head_dim 64) either hold consecutive
rows and share its K/V tiles (shared), or, two of them, hold the same
rows, cut its K tiles between them and merge their softmax states
(split).  :func:`flash_grid` picks the mode whose predicted makespan is
least (:func:`makespan`).  What the kernel decides per block is written
out here (:func:`flash_grid`, :func:`work_item`, :func:`kv_tiles`,
:func:`tile_masked`, :func:`split_tiles`, :func:`ring_tiles`,
:func:`consumer_tiles`) and mirrored line for line in the CUDA source; the
CPU tests hold it against :func:`_mask`.
"""

from __future__ import annotations

import functools
import heapq
import math
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import sm_count

NEG_INF = -1e30
BK = 64               # csrc: K/V positions per tile
WG_ROWS = 64          # csrc: rows of one consumer warpgroup (one wgmma M)
GROUPS = (8, 4, 2, 1)  # heads packed per tile, largest first

# The makespan model's costs, in K-tile steps of one consumer (64 rows ×
# 64 keys) at head_dim 64, fit to ``chip_pair.py --modes`` (every mode
# forced at starcoder2_3b's, whisper_small's, granite_moe_3b_a800m's,
# granite_34b's, qwen25_3b's, starcoder2_15b's and internvl2_2b's shapes,
# NVIDIA H100 80GB HBM3, 700 W): a block's start and end on an SM's first
# block (launch, the first tiles' arrival, the epilogue) and on each later
# one; each warpgroup of rows in range, for its Q and its output, in
# steps at its head dim (any value from 0.5 to 3 picks the same modes
# there); a step's time with three consumers on the SM against two; and a
# step's time by head dim (a step at 64 took 0.74 µs, at 128 1.33 µs, on
# that card).
BLOCK_STEPS = 4.0
REFILL_STEPS = 6.0
ROW_STEPS = 1.0
STEP_COST = {1: 1.0, 2: 1.0, 3: 1.6}
HEAD_DIM_STEPS = {16: 0.4, 32: 0.6, 64: 1.0, 128: 1.8, 256: 3.4}


def ring_stages(Dh: int) -> int:
    """K/V tiles the block's ring holds (csrc ``Cfg::STAGES``)."""
    return 3 if Dh == 256 else 4


def consumer_counts(Dh: int) -> Tuple[int, ...]:
    """Consumer warpgroups a block may have (csrc ``Cfg::CONSUMERS``): two;
    at head_dim 256 one, since its 64×256 fp32 output needs more
    registers than a thread of a 384-thread block has; at head_dim 64 also
    three, whose 64×64 outputs fit the 128 registers a thread of a
    512-thread block enters with, so a K/V tile serves 192 rows.  Only two
    split: split consumers need a ring of a multiple of their count (each
    stage's entries one consumer's: see :func:`ring_tiles`), and three run
    shared."""
    return (1,) if Dh == 256 else (2, 3) if Dh == 64 else (2,)


class FlashPlan(NamedTuple):
    """The bf16 body's launch.  A consumer warpgroup holds 64 rows:
    ``group`` q heads of one KV group at 64 / group consecutive positions,
    so each K/V tile it reads serves ``group`` heads.  Shared
    (``split`` False): the block's ``consumers`` warpgroups hold
    consecutive rows and read the same K/V tiles, ``positions`` =
    64·consumers / group.  Split: two of them hold the same 64 rows and
    cut the block's K tiles between them, ``positions`` = 64 / group.
    ``ptiles`` position tiles cover S; ``blocks`` = ptiles × B × KV ×
    heads per group is the grid, one block an item."""
    group: int
    consumers: int
    split: bool
    positions: int
    ptiles: int
    blocks: int

    @property
    def mode(self) -> str:
        """E.g. ``2shared``, ``2split``, ``3shared``: consumers, and how
        they hold a block's rows."""
        return f"{self.consumers}{'split' if self.split else 'shared'}"


def flash_mode(B: int, S: int, H: int, KV: int, Dh: int, split: bool,
               consumers: int = 2) -> FlashPlan:
    """The plan of one mode: ``split`` or shared, with ``consumers``
    consumer warpgroups (where the head dim allows them; else the first it
    does).  ``group`` is the largest of 8, 4, 2, 1 that divides the q
    heads per KV head; only two consumers split."""
    G = H // KV
    group = next(g for g in GROUPS if G % g == 0)
    counts = consumer_counts(Dh)
    n = consumers if consumers in counts else counts[0]
    split = split and n == 2
    positions = (WG_ROWS if split else WG_ROWS * n) // group
    ptiles = -(-S // positions)
    return FlashPlan(group, n, split, positions, ptiles, ptiles * B * KV * (G // group))


def flash_modes(B: int, S: int, H: int, KV: int, Dh: int) -> List[FlashPlan]:
    """Every mode :func:`flash_grid` weighs, in its order of preference on
    a tie: two consumers before three, shared before split (a K/V tile
    read serves all the block's rows)."""
    return [flash_mode(B, S, H, KV, Dh, split, n) for n in consumer_counts(Dh)
            for split in ((False, True) if n == 2 else (False,))]


def block_steps(S: int, Dh: int, plan: FlashPlan, causal: bool,
                window: int) -> List[float]:
    """Each block's steps, in the order the kernel issues them: its
    busiest consumer's K tiles (``valid_len`` taken as S), each scaled by
    the head dim and the consumer count, and :data:`ROW_STEPS` for each
    warpgroup of its rows that lies in range (split consumers hold one)."""
    step = STEP_COST[plan.consumers] * HEAD_DIM_STEPS[Dh]
    per = plan.blocks // plan.ptiles
    out = []
    for p in (range(plan.ptiles - 1, -1, -1) if causal else range(plan.ptiles)):
        wgs = consumer_tiles(S, p * plan.positions, plan, causal, window, S)
        rows = 1 if plan.split else sum(first < S for first, _, _, _ in wgs)
        out += [max(t1 - t0 for _, _, t0, t1 in wgs) * step
                + ROW_STEPS * rows * HEAD_DIM_STEPS[Dh]] * per
    return out


def makespan(plan: FlashPlan, S: int, Dh: int, causal: bool, window: int, sms: int) -> float:
    """The predicted time of the last SM to finish, in K-tile steps.

    Blocks start in issue order on whichever SM frees first, the greedy
    list schedule (one block fits an SM), an SM's first block paying
    :data:`BLOCK_STEPS` besides its steps and each later one
    :data:`REFILL_STEPS`.  Where the blocks fit the card at once, or are
    equal, the schedule reduces to ⌈blocks / sms⌉ rounds of the costliest
    block."""
    costs = block_steps(S, Dh, plan, causal, window)
    if plan.blocks <= sms or len(set(costs)) == 1:
        return BLOCK_STEPS - REFILL_STEPS + -(-plan.blocks // sms) * (max(costs) + REFILL_STEPS)
    free = [BLOCK_STEPS - REFILL_STEPS] * min(sms, plan.blocks)
    for c in costs:
        heapq.heapreplace(free, free[0] + c + REFILL_STEPS)
    return max(free)


def flash_grid(B: int, S: int, H: int, KV: int, Dh: int, sms: int, causal: bool = True,
               window: int = 0) -> FlashPlan:
    """The launch of the bf16 body on a card of ``sms`` SMs, from static
    shapes only: the mode of :func:`flash_modes` whose :func:`makespan`
    is least, the first of them on a tie."""
    return min(flash_modes(B, S, H, KV, Dh),
               key=lambda p: makespan(p, S, Dh, causal, window, sms))


@functools.lru_cache(maxsize=None)
def flash_plan(B: int, S: int, H: int, KV: int, Dh: int, causal: bool, window: int,
               device_index: int) -> FlashPlan:
    """:func:`flash_grid` on CUDA device ``device_index``, memoized per
    static shape: a call does no plan arithmetic and no device query."""
    return flash_grid(B, S, H, KV, Dh, sm_count(device_index), causal, window)


def work_item(i: int, B: int, H: int, KV: int, plan: FlashPlan,
              causal: bool) -> Tuple[int, int, int, int]:
    """Block ``i`` → (b, kv head, first q head, first position).

    Blocks start in order of index, so the order is heavy first: under a
    causal mask a later position walks more K tiles, so position tiles run
    from the last to the first; without one a window's lower edge only
    shortens the walk of later positions, so they run from the first.  (A
    causal window with ``valid_len`` < S is the one case where neither
    order is heaviest first: positions past ``valid_len`` walk fewer
    tiles.)"""
    heads = H // KV // plan.group
    per = B * KV * heads
    ptile = plan.ptiles - 1 - i // per if causal else i // per
    r = i % per
    hg, r = r % heads, r // heads
    kv, b = r % KV, r // KV
    return b, kv, kv * (H // KV) + hg * plan.group, ptile * plan.positions


def kv_tiles(S: int, first: int, count: int, causal: bool, window: int,
             valid_len: int) -> Tuple[int, int]:
    """K tiles [t0, t1) that positions [first, first + count) ∩ [0, S) walk
    (``valid_len`` already resolved: 0 → S); (0, 0) when none."""
    last = min(first + count, S) - 1
    if first >= S:
        return 0, 0
    end = min(valid_len, last + 1) if causal else valid_len
    begin = max(0, first - window + 1) if window > 0 else 0
    if begin >= end:
        return 0, 0
    return begin // BK, -(-end // BK)


def tile_masked(S: int, first: int, count: int, t: int, causal: bool, window: int,
                valid_len: int) -> bool:
    """Whether K tile ``t`` needs the elementwise mask for positions
    [first, first + count) ∩ [0, S): False only where every (position, key)
    pair of the tile is unmasked."""
    last = min(first + count, S) - 1
    k0, k1 = t * BK, t * BK + BK - 1
    inside = k1 < valid_len and (not causal or k1 <= first) and \
        (window == 0 or k0 > last - window)
    return not inside


def split_tiles(t0: int, t1: int, n: int) -> List[Tuple[int, int]]:
    """The cut of a block's K tiles [t0, t1) between its ``n`` consumers:
    consumer w walks [t0 + w·a, min(t0 + (w+1)·a, t1)) with a = ⌈(t1 − t0)
    / n⌉ (empty where that starts past t1).  The producer loads them in
    turns (:func:`ring_tiles`), so all walk at once."""
    a = -(-(t1 - t0) // n)
    return [(t0 + w * a, max(t0 + w * a, min(t0 + (w + 1) * a, t1))) for w in range(n)]


def ring_tiles(t0: int, t1: int, plan: FlashPlan) -> List[int]:
    """The K tile of each ring entry of a block whose range is [t0, t1),
    in the order the producer loads them: in order when shared, every
    consumer waiting for every entry; split, entry j is tile j // n of
    consumer j % n (n consumers), so with a ring of a multiple of n
    stages each stage's entries are one consumer's, and a consumer's
    parity wait on a stage never sees a phase two back."""
    n = plan.consumers
    if not plan.split:
        return list(range(t0, t1))
    a = -(-(t1 - t0) // n)
    return [t0 + (j % n) * a + j // n for j in range(t1 - t0)]


def consumer_tiles(S: int, p0: int, plan: FlashPlan, causal: bool, window: int,
                   valid_len: int) -> List[Tuple[int, int, int, int]]:
    """Per consumer of the block at position ``p0``: (first position,
    positions, t0, t1), the K tiles [t0, t1) it walks; ``valid_len``
    resolved (0 → S)."""
    n = plan.consumers
    if plan.split:
        t0, t1 = kv_tiles(S, p0, plan.positions, causal, window, valid_len)
        return [(p0, plan.positions, a, b) for a, b in split_tiles(t0, t1, n)]
    wpos = plan.positions // n
    return [(p0 + w * wpos, wpos,
             *kv_tiles(S, p0 + w * wpos, wpos, causal, window, valid_len))
            for w in range(n)]


def _band(q0: int, q1: int, t0: int, t1: int, causal: bool, window: int,
          device: torch.device) -> torch.Tensor:
    """The causal and window mask of positions [q0, q1) × keys [t0, t1)."""
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(t0, t1, device=device)[None, :]
    ok = torch.ones(q1 - q0, t1 - t0, dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def _mask(S: int, causal: bool, window: int, valid_len: int,
          device: torch.device) -> torch.Tensor:
    kpos = torch.arange(S, device=device)[None, :]
    return _band(0, S, 0, S, causal, window, device) & (kpos < (valid_len or S))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          valid_len: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same masks, same −1e30, same
    final division; zeros in a row with no unmasked key).
    q: (B,S,H,Dh), k/v: (B,S,KV,Dh) → (B,S,H,Dh)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    ok = _mask(S, causal, window, valid_len, q.device)
    qf = q.float().reshape(B, S, KV, G, Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * (1.0 / math.sqrt(Dh))
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).clamp_min(1e-20)  # (B,KV,G,S)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, v.float()) / l[..., None]
    o = o.masked_fill(~ok.any(dim=-1)[:, None], 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


# fp32 scores of one query block of flash_attention_bwd, in bytes: past
# it the backward walks the queries in blocks
SCORE_BYTES = 1 << 30


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of the flash forward (``valid_len`` 0) wrt q, k and v.

    PyTorch math on either device, as the reference's backward is jnp
    math: ``repro/kernels/ops.py::flash_attention_trainable`` runs the TPU
    kernel forward and differentiates its oracle ``ref.mha`` by recompute;
    there is no TPU backward kernel to port.  P is recomputed in fp32 with
    the kernel's masks and −1e30 (every row keeps its own position, so no
    row is empty), then

        dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ⊙ (dP − rowsum(dO ⊙ O)),
        dQ = dS·K·scale,  dK = dSᵀ·Q·scale,

    with rowsum(dO ⊙ O) taken as rowsum(P ⊙ dP), which is the same sum
    for the fp32 O = P·V and needs no saved output: dS is softmax's own
    backward, one fused op.  dK and dV sum over each KV head's G q heads.
    Queries are walked in blocks whose fp32 scores stay under
    :data:`SCORE_BYTES`, each against only the keys its mask can reach.
    q, do: (B,S,H,Dh), k/v: (B,S,KV,Dh) → (dq, dk, dv) in the inputs'
    dtypes."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(Dh)
    qf = q.float().reshape(B, S, KV, G, Dh)
    dof = do.float().reshape(B, S, KV, G, Dh)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    rows = max(1, SCORE_BYTES // (4 * B * H * S))
    for q0 in range(0, S, rows):
        q1 = min(q0 + rows, S)
        t0 = max(0, q0 - window + 1) if window > 0 else 0
        t1 = q1 if causal else S
        ok = _band(q0, q1, t0, t1, causal, window, q.device)
        qb, dob, kb, vb = qf[:, q0:q1], dof[:, q0:q1], kf[:, t0:t1], vf[:, t0:t1]
        s = torch.einsum("bqkgd,btkd->bkgqt", qb, kb) * scale
        p = torch.softmax(s.masked_fill_(~ok, NEG_INF), dim=-1)
        dv[:, t0:t1] += torch.einsum("bkgqt,bqkgd->btkd", p, dob)
        dp = torch.einsum("bqkgd,btkd->bkgqt", dob, vb)
        ds = torch._softmax_backward_data(dp, p, -1, torch.float32)
        dq[:, q0:q1] = torch.einsum("bkgqt,btkd->bqkgd", ds, kb) * scale
        dk[:, t0:t1] += torch.einsum("bkgqt,bqkgd->btkd", ds, qb) * scale
    return dq.reshape(B, S, H, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int, valid_len: int) -> None:
    """Raise on anything the kernel does not take."""
    what = "flash_attention_fwd"
    _build.check_tensors(what, q, (("q", q), ("k", k), ("v", v)), q.dtype)
    if q.dim() != 4 or k.dim() != 4 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: q, k and v must be 16-byte aligned 4-d tensors, "
                         f"got shapes {tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, Dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != Dh:
        raise ValueError(f"{what}: k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"{what}: {H} q heads not a multiple of {k.shape[2]} kv heads")
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {Dh} not in {_build.HEAD_DIMS}")
    if not 0 <= valid_len <= S or window < 0:
        raise ValueError(f"{what}: bad valid_len={valid_len} or window={window}")
    if q.dtype == torch.float32 and B * H > 65535:  # the fp32 grid's y extent
        raise ValueError(f"{what}: float32 takes B·H ≤ 65535, got {B * H}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        valid_len: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.
    q: (B,S,H,Dh), k/v: (B,S,KV,Dh), contiguous, on one CUDA device."""
    check_inputs(q, k, v, window, valid_len)
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    plan = flash_plan(B, S, H, KV, Dh, causal, window, q.get_device())
    o = torch.empty_like(q)
    _build.launch("repro_flash_attention_fwd", "flash_attention_fwd", q,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, S, H, KV, Dh, int(causal), window, valid_len or S,
                  plan.group, plan.consumers, int(plan.split), _build.DTYPES[q.dtype])
    return o
