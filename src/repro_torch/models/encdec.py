"""Whisper-style encoder-decoder backbone [arXiv:2212.04356] — ported from
the reference's ``models/encdec.py``.

The conv/audio frontend is a stub, as in the reference: the encoder reads
precomputed frame embeddings (B, S_enc, d_model).  Encoder: bidirectional
pre-LN blocks with fixed sinusoidal positions, attention through the
flash kernel without a causal mask.  Decoder: causal self-attention, then
cross-attention to the encoder's output, then the MLP, with learned
positions and the token embedding tied as the unembedding.

The full-sequence cross-attention (training, prefill) is the reference's
``_sdpa`` math in plain PyTorch (``Lx.sdpa``): the reference computes it
in XLA, outside any Pallas kernel.  A decode step's cross-attention goes
through the dense decode kernel (``Lx.decode_attention(cross=True)``)
against the fixed encoder cache, every row at its full length.

Decode carries two caches: the self-attention K/V, which grows, and the
cross-attention K/V, computed once from the encoder's output at prefill.
The decode step writes the new token's K/V into the cache in place and
returns a cache holding the same tensors and ``pos + 1``.  Per-layer
params keep the reference's stacked layout; each layer body runs under
the plan's remat policy (``Lx.remat_wrap``), as the reference wraps its
scan bodies.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan
from repro_torch.models import layers as Lx
from repro_torch.models.params import ParamSpec, TensorSpec
from repro_torch.models.transformer import attn_specs, mlp_specs, stack_slices, unembed

Params = Dict[str, torch.Tensor]

_MAX_POS = 32_768  # learned decoder position table (covers all non-long cells)


def encdec_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, V = cfg.d_model, cfg.padded_vocab
    Le, Ld = cfg.enc_layers, cfg.dec_layers
    max_pos = cfg.max_position or _MAX_POS
    specs: Dict[str, ParamSpec] = {
        "tok_embed": ParamSpec((V, D), ("vocab", "embed"), scale=0.02),
        "pos_embed": ParamSpec((max_pos, D), (None, "embed"), scale=0.02),
        "enc/final_ln": ParamSpec((D,), (None,), init="ones"),
        "dec/final_ln": ParamSpec((D,), (None,), init="ones"),
    }
    specs.update(attn_specs(cfg, Le, "enc/"))
    specs.update(mlp_specs(cfg, Le, "enc/", cfg.d_ff))
    specs.update(attn_specs(cfg, Ld, "dec/"))  # self-attention
    specs.update(mlp_specs(cfg, Ld, "dec/", cfg.d_ff))
    # cross-attention (queries from the decoder, K/V from the encoder output)
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs.update({
        "dec/lnx": ParamSpec((Ld, D), ("layers", None), init="ones"),
        "dec/xwq": ParamSpec((Ld, D, H * Dh), ("layers", "embed", "heads")),
        "dec/xwk": ParamSpec((Ld, D, KV * Dh), ("layers", "embed", "kv_heads")),
        "dec/xwv": ParamSpec((Ld, D, KV * Dh), ("layers", "embed", "kv_heads")),
        "dec/xwo": ParamSpec((Ld, H * Dh, D), ("layers", "heads", "embed")),
    })
    if cfg.qkv_bias:
        specs.update({
            "dec/xbq": ParamSpec((Ld, H * Dh), ("layers", "heads"), init="zeros"),
            "dec/xbk": ParamSpec((Ld, KV * Dh), ("layers", "kv_heads"), init="zeros"),
            "dec/xbv": ParamSpec((Ld, KV * Dh), ("layers", "kv_heads"), init="zeros"),
        })
    return specs


def _layers(cfg: ModelConfig, params: Params, prefix: str,
            plan: Optional[ShardingPlan]):
    """The encoder's (``enc/``) or decoder's (``dec/``) layer params, each
    at its gather point (``stack_slices``)."""
    L = cfg.enc_layers if prefix == "enc/" else cfg.dec_layers
    return stack_slices(encdec_param_specs(cfg), params, prefix, L, plan)


# ------------------------------------------------------------------ blocks
def _cross_kv(cfg: ModelConfig, lp: Params, y_enc: torch.Tensor,
              plan: Optional[ShardingPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K/V (B, S_enc, KV, Dh) from the encoder output,
    batch-sharded with heads replicated on a mesh."""
    B, Se, _ = y_enc.shape
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    return tuple(Lx.rows(plan, Lx._proj(cfg, y_enc, lp, "x", n)).reshape(B, Se, KV, Dh)
                 for n in "kv")


def _cross_attention(cfg: ModelConfig, x: torch.Tensor, lp: Params,
                     xk: torch.Tensor, xv: torch.Tensor,
                     plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    """Full-sequence cross-attention: queries x (B,Sd,D), K/V from the
    encoder (no mask)."""
    B, Sd, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = Lx.rows(plan, Lx._proj(cfg, x, lp, "x", "q")).reshape(B, Sd, KV, H // KV, Dh)
    o = Lx.sdpa(q, xk, xv, 1.0 / math.sqrt(Dh))
    return Lx.residual(plan, Lx.rows(plan, o.reshape(B, Sd, H * Dh))
                       @ lp["xwo"].to(Lx.cdtype(cfg)))


def _enc_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params, positions: torch.Tensor,
               plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    h = Lx.norm(cfg, x, lp["ln1"])
    x = x + Lx.attention(cfg, h, lp, "", positions, causal=False, plan=plan)
    h = Lx.norm(cfg, x, lp["ln2"])
    return x + Lx.mlp(cfg, h, lp, "", plan)


def _dec_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params, y_enc: torch.Tensor,
               positions: torch.Tensor, collect_kv: bool = False,
               plan: Optional[ShardingPlan] = None):
    """→ (x, (k, v, xk, xv) or None): the self-attention's K/V and the
    cross-attention's, computed once for the layer and the cache."""
    h = Lx.norm(cfg, x, lp["ln1"])
    out = Lx.attention(cfg, h, lp, "", positions, causal=True, return_kv=collect_kv,
                       plan=plan)
    h, kv = out if collect_kv else (out, None)
    x = x + h
    h = Lx.norm(cfg, x, lp["lnx"])
    xk, xv = _cross_kv(cfg, lp, y_enc, plan)
    x = x + _cross_attention(cfg, h, lp, xk, xv, plan)
    h = Lx.norm(cfg, x, lp["ln2"])
    x = x + Lx.mlp(cfg, h, lp, "", plan)
    return x, (kv + (xk, xv) if collect_kv else None)


def _encoder(cfg: ModelConfig, params: Params, enc_x: torch.Tensor,
             plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    B, Se, D = enc_x.shape
    dt = Lx.cdtype(cfg)
    pos = Lx.sinusoidal_positions(Se, D, enc_x.device)
    x = Lx.constrain(plan, enc_x.to(dt) + pos[None].to(dt), ("batch", "seq", None))
    positions = torch.arange(Se, dtype=torch.int32, device=x.device)
    body = Lx.remat_wrap(plan, functools.partial(_enc_layer, cfg, positions=positions,
                                                 plan=plan))
    for lp in _layers(cfg, params, "enc/", plan):
        x = body(x, lp)
    return Lx.norm(cfg, x, params["enc/final_ln"])


def _decoder_input(cfg: ModelConfig, params: Params, dec_tokens: torch.Tensor,
                   plan: Optional[ShardingPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings plus learned positions 0..Sd-1, and those positions."""
    Sd = dec_tokens.shape[1]
    x = Lx.embed(cfg, params["tok_embed"], dec_tokens, plan)
    x = x + Lx.whole(plan, params["pos_embed"])[:Sd][None].to(x.dtype)
    return x, torch.arange(Sd, dtype=torch.int32, device=x.device)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor,
            plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    return unembed(cfg, params, Lx.norm(cfg, x, params["dec/final_ln"]), plan)


# ------------------------------------------------------------------ forward
def forward(cfg: ModelConfig, params: Params, enc_x: torch.Tensor,
            dec_tokens: torch.Tensor, plan: Optional[ShardingPlan] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc_x: (B, S_enc, D) stub embeddings; dec_tokens: (B, S_dec) →
    (logits fp32 (B, S_dec, V), a zero aux loss)."""
    y_enc = _encoder(cfg, params, enc_x, plan)
    x, positions = _decoder_input(cfg, params, dec_tokens, plan)
    body = Lx.remat_wrap(plan, functools.partial(_dec_layer, cfg, positions=positions,
                                                 plan=plan))
    for lp in _layers(cfg, params, "dec/", plan):
        x, _ = body(x, lp, y_enc)
    return _logits(cfg, params, x, plan), torch.zeros((), dtype=torch.float32,
                                                      device=x.device)


def loss_fn(cfg: ModelConfig, plan: ShardingPlan, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token loss of the decoder over ``batch["tokens"]``, given the
    encoder's frames ``batch["enc"]``."""
    tokens = batch["tokens"]
    logits, _ = forward(cfg, params, batch["enc"], tokens[:, :-1], plan=plan)
    return Lx.cross_entropy(logits, tokens[:, 1:])


# -------------------------------------------------------------------- cache
def init_cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                     enc_len: int) -> Dict[str, TensorSpec]:
    """Self-attention K/V (Ld, batch, cache_len, KV, Dh), cross-attention
    K/V (Ld, batch, enc_len, KV, Dh) and each slot's fill position."""
    KV, Dh, Ld = cfg.num_kv_heads, cfg.head_dim, cfg.dec_layers
    dt = Lx.cdtype(cfg)
    return {"k": TensorSpec((Ld, batch, cache_len, KV, Dh), dt),
            "v": TensorSpec((Ld, batch, cache_len, KV, Dh), dt),
            "xk": TensorSpec((Ld, batch, enc_len, KV, Dh), dt),
            "xv": TensorSpec((Ld, batch, enc_len, KV, Dh), dt),
            "pos": TensorSpec((batch,), torch.int32)}


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of each decode-cache field."""
    ax = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"k": ax, "v": ax, "xk": ax, "xv": ax, "pos": ("batch",)}


def prefill(cfg: ModelConfig, params: Params, enc_x: torch.Tensor,
            dec_tokens: torch.Tensor, cache_len: Optional[int] = None,
            plan: Optional[ShardingPlan] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encoder pass + decoder prefill → (last logits (B, V) fp32, cache)."""
    B, Sd = dec_tokens.shape
    T = cache_len or Sd
    if T < Sd:
        raise ValueError(f"cache_len {T} shorter than the prompt {Sd}")
    y_enc = _encoder(cfg, params, enc_x, plan)
    x, positions = _decoder_input(cfg, params, dec_tokens, plan)
    kvs = []
    for lp in _layers(cfg, params, "dec/", plan):
        x, kv = _dec_layer(cfg, x, lp, y_enc, positions, collect_kv=True, plan=plan)
        kvs.append(kv)
    dt = Lx.cdtype(cfg)
    k, v, xk, xv = (torch.stack(t).to(dt) for t in zip(*kvs))
    # zero-fill positions Sd..T-1
    cache = {"k": Lx.pad_cache(k, T), "v": Lx.pad_cache(v, T), "xk": xk, "xv": xv,
             "pos": torch.full((B,), Sd, dtype=torch.int32, device=x.device)}
    return _logits(cfg, params, x[:, -1:, :], plan)[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, plan: Optional[ShardingPlan] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder token against the self K/V (written in place) and the
    fixed cross K/V.  token: (B, 1) → (logits (B, V) fp32, new cache)."""
    pos = cache["pos"]
    x = Lx.embed(cfg, params["tok_embed"], token, plan)
    x = x + Lx.whole(plan, params["pos_embed"]).index_select(0, pos.long())[:, None, :].to(
        x.dtype)
    for i, lp in enumerate(_layers(cfg, params, "dec/", plan)):
        h = Lx.norm(cfg, x, lp["ln1"])
        h, _, _ = Lx.decode_attention(cfg, h, lp, "", cache["k"][i], cache["v"][i], pos,
                                      plan=plan)
        x = x + h
        h = Lx.norm(cfg, x, lp["lnx"])
        h, _, _ = Lx.decode_attention(cfg, h, lp, "x", cache["xk"][i], cache["xv"][i],
                                      pos, cross=True, plan=plan)
        x = x + h
        h = Lx.norm(cfg, x, lp["ln2"])
        x = x + Lx.mlp(cfg, h, lp, "", plan)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _logits(cfg, params, x, plan)[:, 0, :], new_cache
