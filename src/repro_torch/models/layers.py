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
(``plan.constrain``) redistribute them at the same training, prefill and
decode places: the embedding and q/k/v batch-sharded with heads and
sequence replicated, the logits vocab-sharded; a sublayer's output is
reduced into the residual stream's placement (:func:`residual`).  A
kernel reads raw pointers, so it sees each rank's local shards through
``local_map`` (:func:`on_shards`): batch and kv-head shards, along which
its rows are independent, so that is exact.  So do the few ops that
DTensor does not place on every torch release (the embedding lookup,
the loss's gold logit, cache padding).  Without a mesh every constraint
is the identity.  Of a plan the layers also read ``bf16_boundaries`` and
``remat_policy`` (a plan of ``None`` sets neither, and constrains
nothing).
"""

from __future__ import annotations

import functools
import math
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


def rows(plan: Optional[ShardingPlan], x: torch.Tensor) -> torch.Tensor:
    """``x`` sharded on its batch dim (dim 0) alone, every other dim
    replicated, in the forward and in the backward: where a model-sharded
    projection splits into parts or heads, or parts merge back (DTensor
    cannot split a dim its shards cut unevenly, and a gradient may arrive
    sharded where the forward was not)."""
    x = constrain(plan, x, ("batch",) + (None,) * (x.dim() - 1))
    if not isinstance(x, DTensor):
        return x
    pl = x.placements
    return DTensor.from_local(x.to_local(grad_placements=pl), x.device_mesh, pl,
                              run_check=False, shape=x.shape, stride=x.stride())


def whole(plan: Optional[ShardingPlan], x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated on every rank (a weight that a batch-sharded op
    reads whole, such as a depthwise conv's)."""
    return constrain(plan, x, (None,) * x.dim())


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
def mlp(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
        plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or plain 2-layer MLP. Weights: w_in/w_gate/w_out.
    On a mesh its output is reduced into the residual stream's placement
    (:func:`residual`)."""
    dt = cdtype(cfg)
    h = x @ p[f"{prefix}w_in"].to(dt)
    if cfg.glu:
        h = act_fn(cfg, x @ p[f"{prefix}w_gate"].to(dt)) * h
    else:
        h = act_fn(cfg, h)
    return residual(plan, h @ p[f"{prefix}w_out"].to(dt))


def residual(plan: Optional[ShardingPlan], y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output (B, S, D) in the residual stream's placement,
    ``("batch", "seq_sp", None)``: a model-sharded output projection
    leaves partial sums, which this reduces before the next norm reads
    them (DTensor would otherwise carry them through the residual add)."""
    return constrain(plan, y, ("batch", "seq_sp", None))


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
    # the reference's q/k/v constraints (batch-sharded, heads replicated),
    # moved ahead of the split into heads: a shard of the model axis need
    # not hold whole heads, and DTensor cannot split a dim cut unevenly
    q, k, v = (constrain(plan, _proj(cfg, x, p, prefix, n), ("batch", "seq", None))
               for n in "qkv")
    q, k, v = q.reshape(B, S, H, Dh), k.reshape(B, S, KV, Dh), v.reshape(B, S, KV, Dh)
    if cfg.rope:
        cos, sin = rope_tables(cfg, positions, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if getattr(plan, "bf16_boundaries", False):
        q, k, v = bf16_cotangent(q), bf16_cotangent(k), bf16_cotangent(v)
    # the output projection row-parallel: o's heads sharded as wo's rows
    o = constrain(plan, local_flash(q, k, v, causal, window), ("batch", "seq", "heads"))
    out = residual(plan, o @ p[f"{prefix}wo"].to(dt))
    if return_kv:
        return out, (k, v)
    return out


def local_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int) -> torch.Tensor:
    """``ops.flash_attention_trainable`` on q (B,S,H,Dh), k/v (B,S,KV,Dh),
    its output flattened to (B,S,H·Dh) — on DTensors through
    :func:`on_shards`: each rank runs the kernel (and its backward) on its
    batch shard, and the flattening happens there too, so its backward
    never splits a dim that the model axis shards."""
    def fn(q, k, v):
        B, S, H, Dh = q.shape
        return ops.flash_attention_trainable(q, k, v, causal, window).reshape(B, S, H * Dh)

    return on_shards(fn, (q, k, v), (BATCH, BATCH, BATCH), BATCH)


# the roles of a tensor's dims at a kernel boundary: (batch dim, head dim)
BATCH = (0, None)
ROWS_HEADS = (0, 1)   # (B, heads, Dh): one token's q, k, v or output
CACHE = (0, 2)        # (B, T, KV, Dh): a dense cache, one layer's slice
POOL = (None, 2)      # (P, page, KV, Dh): a block pool, every rank's own pages
SUM = "sum"           # an output that is each rank's partial sum
STACKED = (1, 3)      # (L, B, T, KV, Dh): a stack of layers' caches


def on_shards(fn: Callable, args: Tuple, roles: Tuple, out_roles,
              inplace: Tuple[int, ...] = ()):
    """``fn(*args)`` with a kernel inside, on plain tensors: each rank runs
    it on its own shards (``local_map``).  ``roles[i]`` is ``(batch dim,
    head dim)`` of ``args[i]`` (either may be None; None for a non-tensor
    argument), ``out_roles`` the same for the output (a list for a tuple
    of outputs; :data:`SUM` for a sum over the rank's rows, a partial sum
    across ranks).  A kernel's rows are independent along both, so a shard
    of either is exact.

    The first argument leads: each mesh dim that shards its batch dim
    shards every argument's batch dim, each mesh dim that shards its head
    dim shards every head dim, and every other mesh dim replicates (the
    arguments are redistributed to that; plain tensors are taken as
    replicated).  An argument without the dim a mesh dim shards is
    replicated over it, and its gradient there is a partial sum.  An
    argument in ``inplace`` is written by ``fn`` and must already have its
    placements, since a redistribution would copy it: a cache sharded
    along another dim (``kv_seq``) raises.  Without a DTensor argument it
    is ``fn(*args)``."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    lead, (lb, lh) = args[0], roles[0]
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    kinds = [None] * mesh.ndim  # per mesh dim: 0 batch, 1 heads, None neither
    if isinstance(lead, DTensor):
        for i, pl in enumerate(lead.placements):
            if isinstance(pl, Shard) and pl.dim in (lb, lh):
                kinds[i] = 0 if pl.dim == lb else 1

    def want(role, grad=False):
        if role is None:
            role = (None, None)
        return [Shard(role[k]) if k is not None and role[k] is not None
                else Partial() if k is not None and grad else Replicate()
                for k in kinds]

    placed, ins, grads = [], [], []
    for i, (a, r) in enumerate(zip(args, roles)):
        if not isinstance(a, torch.Tensor):
            placed.append(a)
            ins.append(None)
            grads.append(None)
            continue
        w = want(r)
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if list(a.placements) != w:
            if i in inplace:
                raise ValueError(f"a kernel writes this tensor in place on its shards, "
                                 f"which need placements {w}; got {list(a.placements)}")
            a = a.redistribute(mesh, w)
        placed.append(a)
        ins.append(w)
        grads.append(want(r, grad=True))
    def out(role):
        return ([Partial() if k is not None else Replicate() for k in kinds]
                if role is SUM else want(role))

    outs = (tuple(out(r) for r in out_roles) if isinstance(out_roles, list)
            else out(out_roles))
    return local_map(fn, out_placements=outs, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh)(*placed)


def pad_cache(t: torch.Tensor, T: int) -> torch.Tensor:
    """A stacked cache (L, B, S, KV, Dh) zero-filled to T positions, on
    each rank's shards (not every torch release places a DTensor ``pad``)."""
    pad = (0, 0, 0, 0, 0, T - t.shape[2])
    return on_shards(lambda t: F.pad(t, pad), (t,), (STACKED,), STACKED)


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
                pos: torch.Tensor, plan: Optional[ShardingPlan] = None):
    """One token's q (B, H, Dh) and k/v (B, KV, Dh), RoPE at ``pos``; on a
    mesh the projections are batch-sharded with heads replicated before
    they split into heads, as in :func:`attention`."""
    B = x.shape[0]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = (constrain(plan, _proj(cfg, x[:, 0], p, prefix, n), ("batch", None))
               for n in "qkv")
    q, k, v = q.reshape(B, H, Dh), k.reshape(B, KV, Dh), v.reshape(B, KV, Dh)
    if cfg.rope:
        q = _rope_single(cfg, q, pos)
        k = _rope_single(cfg, k, pos)
    return q, k, v


def _write_slot(k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, pos: torch.Tensor, window: int) -> torch.Tensor:
    """Write one token's K/V at each row's slot (``pos mod T`` in a ring,
    ``min(pos, T − 1)`` otherwise), in place; → the rows' lengths."""
    B, T = k_cache.shape[:2]
    pos_l = pos.long()
    slot = pos_l % T if window > 0 else pos_l.clamp_max(T - 1)
    rows = torch.arange(B, device=pos.device)
    k_cache[rows, slot] = k.to(k_cache.dtype)
    v_cache[rows, slot] = v.to(v_cache.dtype)
    return (pos + 1).clamp_max(T).to(torch.int32)


def decode_attention(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                     window: int = 0, cross: bool = False,
                     plan: Optional[ShardingPlan] = None
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

    On a mesh the write and the kernel run on each rank's shards
    (:func:`on_shards`): the cache leads, sharded on its batch and
    ``kv_heads`` dims (``cache_axes``); q and the new K/V follow it.  A
    cache sharded over its positions too (``kv_seq``) takes the write on
    the shard that holds the slot (:func:`_write_seq_shards`), and the
    kernel reads it gathered over the positions (a copy a layer: the
    kernel returns no log-sum-exp to combine partial softmaxes with).
    Returns (out (B,1,D), k_cache, v_cache).
    """
    B, T = x.shape[0], k_cache.shape[1]
    H, Dh = cfg.num_heads, cfg.head_dim
    if cross:
        q = constrain(plan, _proj(cfg, x[:, 0], p, prefix, "q"), ("batch", None))
        q = q.reshape(B, H, Dh)
        if cfg.rope:
            q = _rope_single(cfg, q, pos)

        def attend(kc, vc, q):
            lengths = torch.full((q.shape[0],), kc.shape[1], dtype=torch.int32,
                                 device=q.device)
            return ops.decode_attention(q, kc, vc, lengths).reshape(q.shape[0], 1, -1)

        o = on_shards(attend, (k_cache, v_cache, q), (CACHE, CACHE, ROWS_HEADS),
                      (0, 2))
        return residual(plan, o @ p[f"{prefix}wo"].to(cdtype(cfg))), k_cache, v_cache
    q, k, v = _decode_qkv(cfg, x, p, prefix, pos, plan)
    if _seq_dims(k_cache):
        _write_seq_shards(k_cache, v_cache, k, v, pos, window)

        def attend(kc, vc, q, pos):
            lengths = (pos + 1).clamp_max(kc.shape[1]).to(torch.int32)
            return ops.decode_attention(q, kc, vc, lengths).reshape(q.shape[0], 1, -1)

        o = on_shards(attend, (k_cache, v_cache, q, pos), (CACHE, CACHE, ROWS_HEADS, BATCH),
                      (0, 2))
        return residual(plan, o @ p[f"{prefix}wo"].to(cdtype(cfg))), k_cache, v_cache

    def write_attend(kc, vc, q, k, v, pos):
        lengths = _write_slot(kc, vc, k, v, pos, window)
        return ops.decode_attention(q, kc, vc, lengths).reshape(q.shape[0], 1, -1)

    o = on_shards(write_attend, (k_cache, v_cache, q, k, v, pos),
                  (CACHE, CACHE, ROWS_HEADS, ROWS_HEADS, ROWS_HEADS, BATCH), (0, 2),
                  inplace=(0, 1))
    return residual(plan, o @ p[f"{prefix}wo"].to(cdtype(cfg))), k_cache, v_cache


def _seq_dims(cache: torch.Tensor) -> list:
    """The mesh dims that shard a (B, T, KV, Dh) cache's positions
    (``kv_seq``), in mesh order; none for a plain tensor."""
    if not isinstance(cache, DTensor):
        return []
    return [i for i, pl in enumerate(cache.placements) if isinstance(pl, Shard) and pl.dim == 1]


def _write_seq_shards(k_cache: DTensor, v_cache: DTensor, k: torch.Tensor,
                      v: torch.Tensor, pos: torch.Tensor, window: int) -> None:
    """Write one token's K/V into a cache whose positions are sharded
    (``kv_seq``), in place: each rank holds the new rows of its batch and
    head shards and writes those whose slot falls in its own position
    range (the others write their slot's old value back, so nothing waits
    on the device for a mask)."""
    mesh, pl = k_cache.device_mesh, list(k_cache.placements)
    dims = _seq_dims(k_cache)
    T = k_cache.shape[1]
    shard = 0
    for i in dims:  # the rank's index along the positions, mesh order major
        shard = shard * mesh.size(i) + mesh.get_local_rank(i)
    Tl = T // math.prod(mesh.size(i) for i in dims)
    row_pl = [Replicate() if i in dims else Shard(1) if p == Shard(2) else p
              for i, p in enumerate(pl)]
    pos_pl = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    k, v = (t.redistribute(mesh, row_pl) if isinstance(t, DTensor)
            else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False).redistribute(mesh, row_pl)
            for t in (k, v))
    pos = pos if isinstance(pos, DTensor) else DTensor.from_local(
        pos, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pos = pos.redistribute(mesh, pos_pl)

    def write(kc, vc, k, v, pos):
        pos_l = pos.long()
        slot = (pos_l % T if window > 0 else pos_l.clamp_max(T - 1)) - shard * Tl
        mine = ((slot >= 0) & (slot < Tl))[:, None, None]
        rows, at = torch.arange(kc.shape[0], device=pos.device), slot.clamp(0, Tl - 1)
        kc[rows, at] = torch.where(mine, k.to(kc.dtype), kc[rows, at])
        vc[rows, at] = torch.where(mine, v.to(vc.dtype), vc[rows, at])
        return pos

    local_map(write, out_placements=pos_pl, in_placements=(pl, pl, row_pl, row_pl, pos_pl),
              device_mesh=mesh)(k_cache, v_cache, k, v, pos)


# ------------------------------------------------------- paged decode attn
def paged_decode_attention(cfg: ModelConfig, x: torch.Tensor, p: Params,
                           prefix: str, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, plan: Optional[ShardingPlan] = None
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
    all write the scratch page, which no live slot reads.  On a mesh the
    write and the kernel run on each rank's shards (:func:`on_shards`):
    q leads, batch-sharded, and each rank's pool (replicated over the
    batch, sharded like q's heads) holds the pages of its own rows.
    Returns (out (B,1,D), k_pages, v_pages).
    """
    q, k, v = _decode_qkv(cfg, x, p, prefix, pos, plan)

    def write_attend(q, kp, vp, k, v, pt, pos):
        B, page = q.shape[0], kp.shape[1]
        pos_l = pos.long()
        pidx = pt.long()[torch.arange(B, device=pos.device), pos_l // page]
        off = pos_l % page
        kp[pidx, off] = k.to(kp.dtype)
        vp[pidx, off] = v.to(vp.dtype)
        return ops.paged_decode_attention(q, kp, vp, pt, pos + 1).reshape(B, 1, -1)

    o = on_shards(write_attend, (q, k_pages, v_pages, k, v, page_table, pos),
                  (ROWS_HEADS, POOL, POOL, ROWS_HEADS, ROWS_HEADS, BATCH, BATCH), (0, 2),
                  inplace=(1, 2))
    return residual(plan, o @ p[f"{prefix}wo"].to(cdtype(cfg))), k_pages, v_pages


# --------------------------------------------------------------- embedding
def embed(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor,
          plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    """Token gather. The table has ``cfg.padded_vocab`` rows; tokens are
    always < vocab_size so padding is inert.  On a mesh the table is cast
    to the compute dtype (the cast commutes with the gather), gathered
    whole, and each rank looks up its own rows' tokens (:func:`on_shards`;
    the table's gradient a partial sum over the batch): DTensor's own
    lookups leave a masked partial sum, or a backward, that not every
    torch release can place."""
    if isinstance(table, DTensor):
        def lookup(tokens, table):
            rows = table.index_select(0, tokens.reshape(-1).long())
            return rows.reshape(*tokens.shape, table.shape[-1])

        x = on_shards(lookup, (tokens, table.to(cdtype(cfg))), (BATCH, None), BATCH)
    else:
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
    x = constrain(plan, x, ("batch", "seq", None))
    logits = x.float() @ constrain(plan, w, (None, "vocab"))  # the FSDP gather point
    Vp = logits.shape[-1]
    if Vp != cfg.vocab_size and isinstance(logits, DTensor):  # no sliced fill on shards
        keep = torch.arange(Vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits, NEG)
    elif Vp != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG
    return constrain(plan, logits, ("batch", "seq", "vocab"))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; logits fp32 (B,S,V), labels (B,S) int.  DTensor
    logits are gathered on the vocab dim and each rank sums its own rows
    (:func:`on_shards`), so neither the gold logit's gather nor its
    backward ever spans more than a rank's rows; the two sums are then
    reduced over the ranks."""
    if isinstance(logits, DTensor):
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        total, count = on_shards(_nll_sums, (logits, labels, mask), (BATCH, BATCH, BATCH),
                                 [SUM, SUM])
        rep = [Replicate()] * total.device_mesh.ndim
        return (total.redistribute(total.device_mesh, rep)
                / count.redistribute(total.device_mesh, rep).clamp_min(1.0))
    return _nll(logits, labels, mask)


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _nll_sums(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ mask·nll, Σ mask) over one rank's rows."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


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
