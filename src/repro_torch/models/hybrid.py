"""RecurrentGemma hybrid LM: (rec, rec, attn) pattern groups, ported from
the reference's ``models/hybrid.py``.

26 layers = 8 groups of (RG-LRU, RG-LRU, local attention) + 2 trailing
RG-LRU layers.  Every layer is temporal mix + MLP with pre-norm residuals.
Decode caches: per rec layer (conv, h), O(1); per attention layer a
``window``-slot ring buffer, slot = position mod window.  As in the port's
other decode steps, :func:`decode_step` writes the new states and K/V into
the cache's tensors in place and returns a cache holding the same tensors
and ``pos + 1``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan
from repro_torch.models import layers as Lx
from repro_torch.models.params import ParamSpec, TensorSpec
from repro_torch.models.rglru import rec_block, rec_block_decode, rec_param_specs
from repro_torch.models.transformer import attn_specs, logits, mlp_specs, stack_slices

Params = Dict[str, torch.Tensor]


def _pattern(cfg: ModelConfig) -> Tuple[int, int]:
    plen = len(cfg.block_pattern)  # (rec, rec, attn)
    return cfg.num_layers // plen, cfg.num_layers % plen  # (groups, tail)


def hybrid_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, V = cfg.d_model, cfg.padded_vocab
    G, tail = _pattern(cfg)
    if tuple(cfg.block_pattern) != ("rec", "rec", "attn"):
        raise NotImplementedError(f"block pattern {cfg.block_pattern}: the layout "
                                  f"is (rec, rec, attn) groups")
    specs: Dict[str, ParamSpec] = {
        "tok_embed": ParamSpec((V, D), ("vocab", "embed"), scale=0.02),
        "final_ln": ParamSpec((D,), (None,), init="ones"),
    }
    for slot in ("ra/", "rb/"):  # two rec layers per group
        specs.update(rec_param_specs(cfg, G, f"grp/{slot}"))
        specs.update(mlp_specs(cfg, G, f"grp/{slot}", cfg.d_ff))
    specs.update(attn_specs(cfg, G, "grp/at/"))
    specs.update(mlp_specs(cfg, G, "grp/at/", cfg.d_ff))
    if tail:
        specs.update(rec_param_specs(cfg, tail, "tail/"))
        specs.update(mlp_specs(cfg, tail, "tail/", cfg.d_ff))
    return specs


def _mlp_res(cfg: ModelConfig, x: torch.Tensor, lp: Params, prefix: str,
             plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    h = Lx.norm(cfg, x, lp[f"{prefix}ln2"])
    return x + Lx.mlp(cfg, h, lp, prefix, plan)


def _rec_with_state(cfg: ModelConfig, x: torch.Tensor, lp: Params, prefix: str,
                    collect: bool, plan: Optional[ShardingPlan] = None):
    """rec_block + MLP, with ``collect`` also (conv_state, h_final): the
    final carry is the last step's h, ``hseq[:, -1]``."""
    out = rec_block(cfg, x, lp, prefix, collect_state=collect, plan=plan)
    x, state = out if collect else (out, None)
    return _mlp_res(cfg, x, lp, prefix, plan), state


def _attn_with_kv(cfg: ModelConfig, x: torch.Tensor, lp: Params, prefix: str,
                  positions: torch.Tensor, collect: bool,
                  plan: Optional[ShardingPlan] = None):
    """Local attention + MLP; with ``collect`` also the last
    min(window, S) positions' K/V in ring-buffer layout (slot = position
    mod window): the slice rolled by S mod W."""
    h = Lx.norm(cfg, x, lp[f"{prefix}ln1"])
    out = Lx.attention(cfg, h, lp, prefix, positions, causal=True,
                       window=cfg.window, return_kv=collect, plan=plan)
    h_attn, kv = out if collect else (out, None)
    x = _mlp_res(cfg, x + h_attn, lp, prefix, plan)
    if collect:
        k, v = kv
        S = k.shape[1]
        W = min(cfg.window, S)
        kv = tuple(_ring(t[:, S - W:], S % W) for t in (k, v))
    return x, kv


def _ring(t: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(t, shift, dims=1)`` as two slices and a cat, which
    DTensor places on every torch release (not all have a rule for roll)."""
    if shift == 0:
        return t
    W = t.shape[1]
    return torch.cat([t[:, W - shift:], t[:, :W - shift]], dim=1)


def _groups(cfg: ModelConfig, params: Params, plan: Optional[ShardingPlan] = None):
    """The (rec, rec, attn) groups' and the tail layers' params, each at
    its gather point (``stack_slices``)."""
    G, tail = _pattern(cfg)
    specs = hybrid_param_specs(cfg)
    return (stack_slices(specs, params, "grp/", G, plan),
            stack_slices(specs, params, "tail/", tail, plan) if tail else [])


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    x = Lx.embed(cfg, params["tok_embed"], tokens, plan)
    return x * math.sqrt(cfg.d_model)  # gemma-style embedding scale


def _group_with_state(cfg: ModelConfig, x: torch.Tensor, lp: Params,
                      positions: torch.Tensor, collect: bool,
                      plan: Optional[ShardingPlan]):
    """One (rec, rec, attn) group on its batch-sharded input; with
    ``collect`` also its states (the two rec layers', the ring's K/V)."""
    x = Lx.constrain(plan, x, ("batch", "seq", None))
    x, sa = _rec_with_state(cfg, x, lp, "ra/", collect, plan)
    x, sb = _rec_with_state(cfg, x, lp, "rb/", collect, plan)
    x, kv = _attn_with_kv(cfg, x, lp, "at/", positions, collect, plan=plan)
    return x, (sa, sb, kv)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            plan: Optional[ShardingPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) → (logits fp32 (B,S,V), aux_loss 0).  Each (rec,
    rec, attn) group and each tail layer runs under the plan's remat
    policy (``Lx.remat_wrap``), as the reference wraps its scan bodies."""
    x = _embed(cfg, params, tokens, plan)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
    groups, tails = _groups(cfg, params, plan)
    group = Lx.remat_wrap(
        plan, lambda x, lp: _group_with_state(cfg, x, lp, positions, False, plan)[0])
    rec = Lx.remat_wrap(plan, lambda x, lp: _rec_with_state(cfg, x, lp, "", False, plan)[0])
    for lp in groups:
        x = group(x, lp)
    for lp in tails:
        x = rec(x, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits(cfg, params, x, plan), aux


def loss_fn(cfg: ModelConfig, plan: ShardingPlan, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token loss: tokens[:, :-1] → logits, labels tokens[:, 1:]."""
    tokens = batch["tokens"]
    lg, _ = forward(cfg, params, tokens[:, :-1], plan=plan)
    return Lx.cross_entropy(lg, tokens[:, 1:])


# --------------------------------------------------------------------- cache
def init_cache_specs(cfg: ModelConfig, batch: int,
                     cache_len: int = 0) -> Dict[str, TensorSpec]:
    """``cache_len`` is ignored: the attention K/V is a fixed ``window``
    ring buffer."""
    G, tail = _pattern(cfg)
    W = cfg.lru_width
    KV, Dh, Win, K = cfg.num_kv_heads, cfg.head_dim, cfg.window, cfg.ssm_conv
    dt = Lx.cdtype(cfg)
    specs = {
        "conv_a": TensorSpec((G, batch, K - 1, W), dt),
        "h_a": TensorSpec((G, batch, W), torch.float32),
        "conv_b": TensorSpec((G, batch, K - 1, W), dt),
        "h_b": TensorSpec((G, batch, W), torch.float32),
        "k": TensorSpec((G, batch, Win, KV, Dh), dt),
        "v": TensorSpec((G, batch, Win, KV, Dh), dt),
        "pos": TensorSpec((batch,), torch.int32),
    }
    if tail:
        specs["tail_conv"] = TensorSpec((tail, batch, K - 1, W), dt)
        specs["tail_h"] = TensorSpec((tail, batch, W), torch.float32)
    return specs


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of each decode-cache field."""
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    out = {"conv_a": ("layers", "batch", None, "lru"), "h_a": ("layers", "batch", "lru"),
           "conv_b": ("layers", "batch", None, "lru"), "h_b": ("layers", "batch", "lru"),
           "k": kv, "v": kv, "pos": ("batch",)}
    if _pattern(cfg)[1]:
        out["tail_conv"] = ("layers", "batch", None, "lru")
        out["tail_h"] = ("layers", "batch", "lru")
    return out


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None, plan: Optional[ShardingPlan] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B, S) at their exact length → (last-position logits (B, V)
    fp32, cache).  The ring is zero-padded past S when the prompt is
    shorter than the window."""
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(cfg, params, tokens, plan)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    groups, tails = _groups(cfg, params, plan)
    col = {n: [] for n in ("conv_a", "h_a", "conv_b", "h_b", "k", "v",
                           "tail_conv", "tail_h")}
    for lp in groups:
        x, ((ca, ha), (cb, hb), (kw, vw)) = _group_with_state(cfg, x, lp, positions,
                                                              True, plan)
        for n, t in (("conv_a", ca), ("h_a", ha), ("conv_b", cb), ("h_b", hb),
                     ("k", kw), ("v", vw)):
            col[n].append(t)
    for lp in tails:
        x, (cs, hs) = _rec_with_state(cfg, x, lp, "", True, plan)
        col["tail_conv"].append(cs)
        col["tail_h"].append(hs)
    specs = init_cache_specs(cfg, B)
    cache = {n: torch.stack(ts).to(specs[n].dtype) for n, ts in col.items() if ts}
    if S < cfg.window:  # pad the window ring past the prompt
        cache["k"] = Lx.pad_cache(cache["k"], cfg.window)
        cache["v"] = Lx.pad_cache(cache["v"], cfg.window)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
    return logits(cfg, params, x[:, -1:, :], plan)[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, plan: Optional[ShardingPlan] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. token: (B, 1) → (logits (B,V) fp32, new cache); the
    states and the ring are updated in place."""
    pos = cache["pos"]
    x = _embed(cfg, params, token, plan)
    groups, tails = _groups(cfg, params, plan)

    def rec(x, lp, prefix, conv, h):
        x, new_conv, new_h = rec_block_decode(cfg, x, lp, prefix, conv, h, plan)
        conv.copy_(new_conv)
        h.copy_(new_h)
        return _mlp_res(cfg, x, lp, prefix, plan)

    for g, lp in enumerate(groups):
        x = rec(x, lp, "ra/", cache["conv_a"][g], cache["h_a"][g])
        x = rec(x, lp, "rb/", cache["conv_b"][g], cache["h_b"][g])
        h = Lx.norm(cfg, x, lp["at/ln1"])
        h, _, _ = Lx.decode_attention(cfg, h, lp, "at/", cache["k"][g], cache["v"][g],
                                      pos, window=cfg.window, plan=plan)
        x = _mlp_res(cfg, x + h, lp, "at/", plan)
    for t, lp in enumerate(tails):
        x = rec(x, lp, "", cache["tail_conv"][t], cache["tail_h"][t])
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits(cfg, params, x, plan)[:, 0, :], new_cache
