"""Decoder-only transformer, dense family — ported from the reference's
``models/transformer.py``.

Per-layer params keep the reference's stacked layout (a leading ``L``
dim); where the reference runs one ``lax.scan`` over the stack, the port
runs a Python loop over layer slices.  The training forward
(:func:`forward`, :func:`loss_fn`) wraps each layer in the plan's remat
policy, as the reference wraps its scan body.  The MoE and VLM variants
of the reference's decoder wait for later slices.

Two decode caches: the paged block pool (:func:`paged_cache_specs`) and
the seed's dense per-slot cache (:func:`init_cache_specs`).  Both decode
steps write the new token's K/V into the cache's tensors in place and
return a cache holding the same tensors and ``pos + 1``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan
from repro_torch.models import layers as Lx
from repro_torch.models.params import ParamSpec, TensorSpec

Params = Dict[str, torch.Tensor]

# params the reference reads in fp32, by the last part of their path: norm
# scales (``scale.astype(f32)``), the SSD's dt_bias and A_log and the
# RG-LRU's gate weights, biases and Λ (``models/ssm.py``, ``rglru.py``);
# every other param it casts to the compute dtype at each use.  ``unembed``
# is no param of the reference: compute_params adds it, already converted
FP32_PARAMS = frozenset({"ln", "ln1", "ln2", "gate_ln", "final_ln", "dt_bias",
                         "A_log", "lam", "w_a", "b_a", "w_i", "b_i", "unembed"})


# ------------------------------------------------------------------- specs
def attn_specs(cfg: ModelConfig, L: int, prefix: str) -> Dict[str, ParamSpec]:
    D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        f"{prefix}ln1": ParamSpec((L, D), ("layers", None), init="ones"),
        f"{prefix}wq": ParamSpec((L, D, H * Dh), ("layers", "embed", "heads")),
        f"{prefix}wk": ParamSpec((L, D, KV * Dh), ("layers", "embed", "kv_heads")),
        f"{prefix}wv": ParamSpec((L, D, KV * Dh), ("layers", "embed", "kv_heads")),
        f"{prefix}wo": ParamSpec((L, H * Dh, D), ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        specs.update({
            f"{prefix}bq": ParamSpec((L, H * Dh), ("layers", "heads"), init="zeros"),
            f"{prefix}bk": ParamSpec((L, KV * Dh), ("layers", "kv_heads"), init="zeros"),
            f"{prefix}bv": ParamSpec((L, KV * Dh), ("layers", "kv_heads"), init="zeros"),
        })
    return specs


def mlp_specs(cfg: ModelConfig, L: int, prefix: str, d_ff: int) -> Dict[str, ParamSpec]:
    D = cfg.d_model
    specs = {
        f"{prefix}ln2": ParamSpec((L, D), ("layers", None), init="ones"),
        f"{prefix}w_in": ParamSpec((L, D, d_ff), ("layers", "embed", "mlp")),
        f"{prefix}w_out": ParamSpec((L, d_ff, D), ("layers", "mlp", "embed")),
    }
    if cfg.glu:
        specs[f"{prefix}w_gate"] = ParamSpec((L, D, d_ff), ("layers", "embed", "mlp"))
    return specs


def decoder_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    if cfg.family != "dense" or cfg.first_dense or cfg.is_moe:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    D, V = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, ParamSpec] = {
        "tok_embed": ParamSpec((V, D), ("vocab", "embed"), scale=0.02),
        "final_ln": ParamSpec((D,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    specs.update(attn_specs(cfg, cfg.num_layers, "blk/"))
    specs.update(mlp_specs(cfg, cfg.num_layers, "blk/", cfg.d_ff))
    return specs


def compute_params(cfg: ModelConfig, params: Params) -> Params:
    """The params as the compute sees them, made once, for every ported
    family: everything the reference casts to ``cfg.dtype`` at each use is
    cast here, what it reads in fp32 (:data:`FP32_PARAMS`) stays fp32.  For frozen weights this is bit-identical to casting
    at every use, and it saves re-reading the fp32 masters every step.
    ``unembed`` is the unembedding's fp32 weight, made here once rather
    than cast from the table at every step (``Lx.unembed_weight``).
    Idempotent: the engine may get params the router already converted."""
    dt = Lx.cdtype(cfg)
    out = {k: (v if k.rsplit("/", 1)[-1] in FP32_PARAMS else v.to(dt))
           for k, v in params.items()}
    if "unembed" not in out:
        table = out["tok_embed"] if cfg.tie_embeddings else out["lm_head"]
        out["unembed"] = Lx.unembed_weight(cfg, table, transpose=cfg.tie_embeddings)
    return out


# ------------------------------------------------------------------ blocks
def layer_params(params: Params, i: int, prefix: str = "blk/") -> Params:
    """Layer ``i``'s slice of the stacked params (views, no copies)."""
    return {k[len(prefix):]: v[i] for k, v in params.items() if k.startswith(prefix)}


def unbind_layers(params: Params, L: int, prefix: str = "blk/") -> List[Params]:
    """Every layer's slice of the stacked params, by one ``unbind`` per
    param: under autograd each stacked gradient is then assembled once (one
    stack), where indexing would add a full-size zero-padded gradient per
    layer."""
    cols = {k[len(prefix):]: v.unbind(0) for k, v in params.items() if k.startswith(prefix)}
    return [{k: c[i] for k, c in cols.items()} for i in range(L)]


def _layer_body(cfg: ModelConfig, x: torch.Tensor, lp: Params,
                positions: torch.Tensor, collect_kv: bool = False,
                plan: Optional[ShardingPlan] = None):
    h = Lx.norm(cfg, x, lp["ln1"])
    out = Lx.attention(cfg, h, lp, "", positions, causal=cfg.causal,
                       window=cfg.window, return_kv=collect_kv, plan=plan)
    h, kv = out if collect_kv else (out, None)
    x = x + h
    h = Lx.norm(cfg, x, lp["ln2"])
    return x + Lx.mlp(cfg, h, lp, ""), kv


def logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the unembedding: x (B,S,D) → logits fp32."""
    x = Lx.norm(cfg, x, params["final_ln"])
    w = params.get("unembed")
    if w is None:  # the fp32 masters, not yet through compute_params
        table = params["tok_embed"] if cfg.tie_embeddings else params["lm_head"]
        w = Lx.unembed_weight(cfg, table, transpose=cfg.tie_embeddings)
    return Lx.unembed(cfg, x, w)


# ------------------------------------------------------------------ forward
def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            plan: Optional[ShardingPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) → (logits fp32 (B,S,V), aux_loss).  Each layer runs
    under the plan's remat policy (``Lx.remat_wrap``)."""
    x = Lx.embed(cfg, params["tok_embed"], tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def body(x, lp):
        return _layer_body(cfg, x, lp, positions, plan=plan)[0]

    body = Lx.remat_wrap(plan, body)
    for lp in unbind_layers(params, cfg.num_layers):
        x = body(x, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, plan: ShardingPlan, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token loss: tokens[:, :-1] → logits, labels tokens[:, 1:]."""
    tokens = batch["tokens"]
    lg, aux = forward(cfg, params, tokens[:, :-1], plan=plan)
    return Lx.cross_entropy(lg, tokens[:, 1:]) + cfg.router_aux_weight * aux


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            valid_len: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-pass forward + KV-cache collection.

    Returns (last-position logits (B, V) fp32, cache with ``k``/``v``
    (L, B, T, KV, Dh) and ``pos`` (B,)).  ``valid_len`` (scalar or (B,))
    supports right-padded prompts: logits are taken at ``valid_len - 1``
    and ``pos`` starts there; causality keeps the pad positions inert.
    """
    B, S = tokens.shape
    T = cache_len or S
    if T < S:
        raise ValueError(f"cache_len {T} shorter than the prompt {S}")
    dev = tokens.device
    x = Lx.embed(cfg, params["tok_embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _layer_body(cfg, x, layer_params(params, i), positions, collect_kv=True)
        ks.append(k)
        vs.append(v)
    dt = Lx.cdtype(cfg)
    cache = {"k": torch.stack(ks).to(dt), "v": torch.stack(vs).to(dt)}
    if T > S:
        pad = (0, 0, 0, 0, 0, T - S)  # zero-fill positions S..T-1
        cache = {n: torch.nn.functional.pad(c, pad) for n, c in cache.items()}
    if valid_len is None:
        cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
        x_last = x[:, -1:, :]
    else:
        vl = torch.as_tensor(valid_len, dtype=torch.int32, device=dev).broadcast_to((B,))
        cache["pos"] = vl.clone()
        idx = (vl.long() - 1).clamp(0, S - 1)
        x_last = x[torch.arange(B, device=dev), idx][:, None, :]
    return logits(cfg, params, x_last)[:, 0, :], cache


# -------------------------------------------------------------------- cache
def init_cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, TensorSpec]:
    """The seed's dense per-slot KV cache: (L, batch, cache_len, KV, Dh)
    K and V, and each slot's fill position."""
    KV, Dh, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    dt = Lx.cdtype(cfg)
    return {
        "k": TensorSpec((L, batch, cache_len, KV, Dh), dt),
        "v": TensorSpec((L, batch, cache_len, KV, Dh), dt),
        "pos": TensorSpec((batch,), torch.int32),
    }


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against the dense cache (see init_cache_specs).
    token: (B, 1) → (logits (B,V) fp32, new cache).  The new token's K/V
    are written into the cache in place; the returned cache holds the same
    tensors and ``pos + 1``."""
    pos = cache["pos"]
    x = Lx.embed(cfg, params["tok_embed"], token)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = Lx.norm(cfg, x, lp["ln1"])
        h, _, _ = Lx.decode_attention(cfg, h, lp, "", cache["k"][i], cache["v"][i], pos,
                                      window=cfg.window)
        x = x + h
        x = x + Lx.mlp(cfg, Lx.norm(cfg, x, lp["ln2"]), lp, "")
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits(cfg, params, x)[:, 0, :], new_cache


def paged_cache_specs(cfg: ModelConfig, num_pages: int, page_size: int,
                      max_batch: int, max_pages_per_req: int) -> Dict[str, TensorSpec]:
    """The *paged* KV cache: a block pool of ``num_pages`` fixed
    ``page_size`` pages shared by every layer (the same page index holds a
    request's tokens in all layers), plus per-slot page tables and fill
    positions.  Memory scales with live tokens, not max_batch × cache_len."""
    KV, Dh, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    dt = Lx.cdtype(cfg)
    return {
        "k": TensorSpec((L, num_pages, page_size, KV, Dh), dt),
        "v": TensorSpec((L, num_pages, page_size, KV, Dh), dt),
        "page_table": TensorSpec((max_batch, max_pages_per_req), torch.int32),
        "pos": TensorSpec((max_batch,), torch.int32),
    }


def decode_step_paged(cfg: ModelConfig, params: Params,
                      cache: Dict[str, torch.Tensor], token: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against the paged cache (see paged_cache_specs).
    token: (B, 1) → (logits (B,V) fp32, new cache).  The new token's K/V
    are written into the pools in place; the returned cache holds the same
    pool tensors and ``pos + 1``."""
    pos, pt = cache["pos"], cache["page_table"]
    x = Lx.embed(cfg, params["tok_embed"], token)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = Lx.norm(cfg, x, lp["ln1"])
        h, _, _ = Lx.paged_decode_attention(cfg, h, lp, "", cache["k"][i],
                                            cache["v"][i], pt, pos)
        x = x + h
        x = x + Lx.mlp(cfg, Lx.norm(cfg, x, lp["ln2"]), lp, "")
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits(cfg, params, x)[:, 0, :], new_cache
