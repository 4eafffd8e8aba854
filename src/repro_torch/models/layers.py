"""Shared model primitives: norms, RoPE, GQA attention (prefill, dense and
paged decode, the enc-dec decoder's cross-attention), MLPs, embeddings,
sinusoidal positions, cross-entropy, the bf16 cotangent boundary and
remat — ported from the reference's ``models/layers.py``.

Compute dtype is ``cfg.dtype``; norms, RoPE, softmax and logits work in
fp32, as in the reference.  The reference casts each fp32 param to the
compute dtype at every use (``p[...].astype(dt)``); here ``.to(dt)`` does
the same and is free when the caller already holds a compute-dtype copy
(see :func:`repro_torch.models.transformer.compute_params`).

Attention always goes through :mod:`repro_torch.kernels.ops`: the Hopper
kernels on CUDA tensors, their plain versions on CPU tensors; prefill and
training attention through ``ops.flash_attention_trainable``, whose
backward is PyTorch math.

On a mesh the tensors are DTensors and the reference's constraints
(``plan.constrain``) redistribute them at the same training and prefill
places: the embedding and q/k/v batch-sharded with heads and sequence
replicated, the logits vocab-sharded.  A kernel reads raw
pointers, so it sees each rank's local shard through ``local_map``
(:func:`local_flash`); with q/k/v sharded on the batch alone that is
exact.  Without a mesh every constraint is the identity.  Of a plan the
layers also read ``bf16_boundaries`` and ``remat_policy`` (a plan of
``None`` sets neither, and constrains nothing).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan
from repro_torch.kernels import ops

NEG = -1e30

Params = Dict[str, torch.Tensor]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def constrain(plan: Optional[ShardingPlan], x: torch.Tensor, axes) -> torch.Tensor:
    """``plan.constrain(x, axes)``; the identity without a plan."""
    return x if plan is None else plan.constrain(x, axes)


# ------------------------------------------------------------------- norms
def norm(cfg: ModelConfig, x: torch.Tensor, scale: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    else:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ------------------------------------------------------- bf16 grad boundary
class _Bf16Cotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(torch.bfloat16).to(ct.dtype)


def bf16_cotangent(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; backward casts the cotangent to bf16 (and back).

    Placed after the fp32 score region of attention so the dq/dk/dv
    cotangents — the per-layer dx all-reduces once the model axis is
    sharded — ride at half width."""
    return _Bf16Cotangent.apply(x)


# -------------------------------------------------------------------- rope
def rope_tables(cfg: ModelConfig, positions: torch.Tensor,
                head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int → cos/sin tables (..., head_dim/2) fp32."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                   device=positions.device), expo)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2). NeoX rotate-half."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:  # (S, half) → broadcast over batch & heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _rope_single(cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """RoPE for one position per batch row. x: (B, h, Dh), pos: (B,)."""
    cos, sin = rope_tables(cfg, pos, x.shape[-1])  # (B, half)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# -------------------------------------------------------------- activations
def act_fn(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


# --------------------------------------------------------------------- mlp
def mlp(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain 2-layer MLP. Weights: w_in/w_gate/w_out."""
    dt = cdtype(cfg)
    h = x @ p[f"{prefix}w_in"].to(dt)
    if cfg.glu:
        h = act_fn(cfg, x @ p[f"{prefix}w_gate"].to(dt)) * h
    else:
        h = act_fn(cfg, h)
    return h @ p[f"{prefix}w_out"].to(dt)


# --------------------------------------------------------------- attention
def _proj(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
          name: str) -> torch.Tensor:
    dt = cdtype(cfg)
    y = x @ p[f"{prefix}w{name}"].to(dt)
    if cfg.qkv_bias:
        y = y + p[f"{prefix}b{name}"].to(dt)
    return y


def attention(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
              positions: torch.Tensor, causal: bool = True, window: int = 0,
              return_kv: bool = False, plan: Optional[ShardingPlan] = None):
    """Self-attention over full sequences (train / prefill path), through
    the flash kernel as ``ops.flash_attention_trainable`` (outside grad mode
    it records nothing).  With ``plan.bf16_boundaries`` the cotangents of
    q, k and v pass a bf16 boundary.  With ``return_kv=True`` also returns
    the (post-RoPE) K/V used — the prefill path collects them into the
    cache in the same pass."""
    dt = cdtype(cfg)
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _proj(cfg, x, p, prefix, "q").reshape(B, S, H, Dh)
    k = _proj(cfg, x, p, prefix, "k").reshape(B, S, KV, Dh)
    v = _proj(cfg, x, p, prefix, "v").reshape(B, S, KV, Dh)
    if cfg.rope:
        cos, sin = rope_tables(cfg, positions, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if getattr(plan, "bf16_boundaries", False):
        q, k, v = bf16_cotangent(q), bf16_cotangent(k), bf16_cotangent(v)
    q = constrain(plan, q.reshape(B, S, KV, H // KV, Dh),
                  ("batch", "seq", None, None, None)).reshape(B, S, H, Dh)
    k = constrain(plan, k, ("batch", "seq", None, None))
    v = constrain(plan, v, ("batch", "seq", None, None))
    o = local_flash(q, k, v, causal, window)
    out = o.reshape(B, S, H * Dh) @ p[f"{prefix}wo"].to(dt)
    if return_kv:
        return out, (k, v)
    return out


def local_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int) -> torch.Tensor:
    """``ops.flash_attention_trainable`` — on DTensors through ``local_map``:
    each rank runs the kernel (and its backward) on its local q/k/v, and
    the output carries q's placements.  That is exact only while q, k and
    v are sharded on the batch dim alone, so any other placement raises."""
    if not isinstance(q, DTensor):
        return ops.flash_attention_trainable(q, k, v, causal, window)
    for t in (q, k, v):
        if not isinstance(t, DTensor) or t.device_mesh != q.device_mesh or any(
                isinstance(pl, Partial) or (isinstance(pl, Shard) and pl.dim != 0)
                for pl in t.placements):
            raise ValueError(f"flash attention on a mesh needs q/k/v sharded on "
                             f"the batch alone; got {getattr(t, 'placements', t)}")
    if list(k.placements) != list(q.placements) or list(v.placements) != list(q.placements):
        raise ValueError("flash attention on a mesh needs q, k and v on the same "
                         "batch shards")
    pl = list(q.placements)  # a list: local_map reads a tuple as one per output
    fn = local_map(ops.flash_attention_trainable, out_placements=pl,
                   in_placements=(pl, pl, pl, None, None), device_mesh=q.device_mesh)
    return fn(q, k, v, causal, window)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The reference's unmasked ``_sdpa`` in plain PyTorch: q (B,Sq,KV,G,Dh),
    k/v (B,T,KV,Dh) → (B,Sq,KV,G,Dh).  fp32 scores (products of the
    compute dtype are exact in fp32), fp32 softmax, P cast to v's dtype
    for P·V.  The reference computes the enc-dec cross-attention so, in
    XLA and in no Pallas kernel; no kernel of the port replaces it."""
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale
    pr = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", pr.to(v.dtype), v)


# ------------------------------------------------------------- decode attn
def _decode_qkv(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
                pos: torch.Tensor):
    """One token's q (B, H, Dh) and k/v (B, KV, Dh), RoPE at ``pos``."""
    B = x.shape[0]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _proj(cfg, x, p, prefix, "q").reshape(B, H, Dh)
    k = _proj(cfg, x, p, prefix, "k").reshape(B, KV, Dh)
    v = _proj(cfg, x, p, prefix, "v").reshape(B, KV, Dh)
    if cfg.rope:
        q = _rope_single(cfg, q, pos)
        k = _rope_single(cfg, k, pos)
    return q, k, v


def decode_attention(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                     window: int = 0, cross: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a dense KV cache, per-slot positions.

    x: (B, 1, D); k_cache/v_cache: (B, T, KV, Dh); pos: (B,) int32, each
    slot's own index (continuous batching: slots advance independently).
    The new token's K/V (RoPE applied here, at write time) go to slot
    ``pos mod T`` of a windowed cache, a ring buffer, and to
    ``min(pos, T − 1)`` of a plain one; then ``ops.decode_attention``
    attends each row over its first ``lengths = min(pos + 1, T)`` slots.
    That is the reference's mask: before a ring wraps (pos < T) the valid
    slots are idx ≤ pos, the first pos + 1; once it has wrapped all T are
    valid.  Softmax does not depend on the order of the slots, and each
    key carries its own position's rotation, so the ring's order needs no
    unrolling.  The plain cache clamps likewise: past T the last slot is
    rewritten and all T are read, as in the reference.

    The reference returns new caches (JAX arrays are immutable); the port
    writes the token into the caches in place and returns the same
    tensors.  ``cross=True`` attends to a fixed encoder cache instead
    (the enc-dec decoder's cross-attention, weights ``{prefix}wq`` etc.):
    no cache write, RoPE on q only, and every row over all T positions.
    Returns (out (B,1,D), k_cache, v_cache).
    """
    B, T = x.shape[0], k_cache.shape[1]
    if cross:
        q = _proj(cfg, x, p, prefix, "q").reshape(B, cfg.num_heads, cfg.head_dim)
        if cfg.rope:
            q = _rope_single(cfg, q, pos)
        lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
        o = ops.decode_attention(q, k_cache, v_cache, lengths)
        return o.reshape(B, 1, -1) @ p[f"{prefix}wo"].to(cdtype(cfg)), k_cache, v_cache
    q, k, v = _decode_qkv(cfg, x, p, prefix, pos)
    pos_l = pos.long()
    slot = pos_l % T if window > 0 else pos_l.clamp_max(T - 1)
    rows = torch.arange(B, device=pos.device)
    k_cache[rows, slot] = k.to(k_cache.dtype)
    v_cache[rows, slot] = v.to(v_cache.dtype)
    lengths = (pos + 1).clamp_max(T).to(torch.int32)
    o = ops.decode_attention(q, k_cache, v_cache, lengths)
    return o.reshape(B, 1, -1) @ p[f"{prefix}wo"].to(cdtype(cfg)), k_cache, v_cache


# ------------------------------------------------------- paged decode attn
def paged_decode_attention(cfg: ModelConfig, x: torch.Tensor, p: Params,
                           prefix: str, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention against a *paged* KV cache.

    x: (B, 1, D); k_pages/v_pages: (P, page, KV, Dh) block pool shared by
    all requests; page_table: (B, maxp) int32 (0-padded past the fill —
    page 0 is the pool's scratch page); pos: (B,) int32 current fill per
    slot.  The new token's K/V are written into page
    ``page_table[b, pos // page]`` at offset ``pos % page``, then the paged
    kernel walks each row's page list with ``lengths = pos + 1``.

    The reference returns new pools (JAX arrays are immutable); the port
    writes the token into the pools in place and returns the same tensors.
    Pages are per request, so live slots write distinct places; idle slots
    all write the scratch page, which no live slot reads.
    Returns (out (B,1,D), k_pages, v_pages).
    """
    B, page = x.shape[0], k_pages.shape[1]
    q, k, v = _decode_qkv(cfg, x, p, prefix, pos)
    pos_l = pos.long()
    pidx = page_table.long()[torch.arange(B, device=pos.device), pos_l // page]
    off = pos_l % page
    k_pages[pidx, off] = k.to(k_pages.dtype)
    v_pages[pidx, off] = v.to(v_pages.dtype)
    lengths = pos + 1
    o = ops.paged_decode_attention(q, k_pages, v_pages, page_table, lengths)
    return o.reshape(B, 1, -1) @ p[f"{prefix}wo"].to(cdtype(cfg)), k_pages, v_pages


# --------------------------------------------------------------- embedding
def embed(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor,
          plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    """Token gather. The table has ``cfg.padded_vocab`` rows; tokens are
    always < vocab_size so padding is inert."""
    rows = table.index_select(0, tokens.reshape(-1).long())
    x = rows.to(cdtype(cfg)).reshape(*tokens.shape, table.shape[-1])
    return constrain(plan, x, ("batch", "seq", None))


def unembed_weight(cfg: ModelConfig, table: torch.Tensor, transpose: bool) -> torch.Tensor:
    """W_out as the (D, Vp) fp32 matrix :func:`unembed` multiplies by.  As in
    the reference, the table is cast to the compute dtype; it is held in
    fp32 so that the product accumulates into fp32 (products of
    compute-dtype values are exact in fp32).  A view when the table is
    already fp32."""
    w = table.to(cdtype(cfg)).float()
    return w.t() if transpose else w


def unembed(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor,
            plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    """x @ W_out → logits fp32, vocab-sharded on a mesh; ``w`` from
    :func:`unembed_weight`.  Padded vocab columns are masked to −1e30 so
    softmax/argmax semantics match the unpadded vocab."""
    logits = x.float() @ w
    Vp = logits.shape[-1]
    if Vp != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG
    return constrain(plan, logits, ("batch", "seq", "vocab"))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; logits fp32 (B,S,V), labels (B,S) int.  Vocab-sharded
    DTensor logits are gathered on the vocab dim first (DTensor cannot
    gather the gold logit across vocab shards)."""
    if isinstance(logits, DTensor):
        last = logits.ndim - 1
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
            for pl in logits.placements])
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


# ------------------------------------------------------------------- remat
# the products whose outputs the "dots" policy keeps (the reference's
# ``dots_with_no_batch_dims_saveable``); everything else is recomputed
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default]


def remat_wrap(plan: Optional[ShardingPlan], fn: Callable) -> Callable:
    """``fn`` under the plan's remat policy: ``none`` → ``fn`` itself;
    ``full`` → checkpointed, everything recomputed in the backward;
    ``dots`` → selectively checkpointed, the matmul outputs saved.  A
    kernel that writes its output outside the dispatcher (the flash
    forward) runs again in the backward under both."""
    policy = getattr(plan, "remat_policy", "none")
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = ({"context_fn": functools.partial(create_selective_checkpoint_contexts, _DOTS)}
          if policy == "dots" else {})

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


@functools.lru_cache(maxsize=8)
def _sinusoids(n: int, d: int) -> np.ndarray:
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    ang = np.arange(n)[:, None] * freqs[None, :]
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    out.flags.writeable = False
    return out


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (n, d) fp32 on ``device``: the
    reference's numpy (fp64, then cast), so bit-equal to it."""
    return torch.tensor(_sinusoids(n, d), device=device)
