"""Decoder-only transformer, dense, MoE and VLM families — ported from the
reference's ``models/transformer.py``.

Per-layer params keep the reference's stacked layout (a leading ``L``
dim); where the reference runs one ``lax.scan`` over a stack, the port
runs a Python loop over layer slices.  Two stacks, as in the reference:
the leading dense layers ``d0/`` (``cfg.first_dense`` of them, DeepSeekMoE's
layer 0, with ``dense_d_ff``), then ``blk/``, whose FFN is the MoE layer
(:mod:`repro_torch.models.moe`) for the MoE family and a dense MLP
otherwise.  The training forward (:func:`forward`, :func:`loss_fn`) wraps
each layer in the plan's remat policy, as the reference wraps its scan
body, and sums the MoE layers' aux losses.  The VLM family is the dense
decoder whose first ``cfg.n_patches`` positions take precomputed patch
embeddings (the vision frontend is a stub, as in the reference) and carry
no next-token loss.

Two decode caches: the paged block pool (:func:`paged_cache_specs`) and
the seed's dense per-slot cache (:func:`init_cache_specs`), each with
``k0``/``v0`` for the ``d0/`` stack.  Both decode steps write the new
token's K/V into the cache's tensors in place and return a cache holding
the same tensors and ``pos + 1``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan
from repro_torch.models import layers as Lx
from repro_torch.models.moe import moe_ffn, moe_param_specs
from repro_torch.models.params import ParamSpec, TensorSpec

Params = Dict[str, torch.Tensor]

# params the reference reads in fp32, by the last part of their path: norm
# scales (``scale.astype(f32)``), the SSD's dt_bias and A_log and the
# RG-LRU's gate weights, biases and Λ (``models/ssm.py``, ``rglru.py``);
# every other param it casts to the compute dtype at each use.  ``unembed``
# is no param of the reference: compute_params adds it, already converted
FP32_PARAMS = frozenset({"ln", "ln1", "ln2", "lnx", "gate_ln", "final_ln", "dt_bias",
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
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    D, V = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, ParamSpec] = {
        "tok_embed": ParamSpec((V, D), ("vocab", "embed"), scale=0.02),
        "final_ln": ParamSpec((D,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    fd, Lm = cfg.first_dense, cfg.num_layers - cfg.first_dense
    if fd > 0:  # leading dense layers (DeepSeekMoE layer 0)
        specs.update(attn_specs(cfg, fd, "d0/"))
        specs.update(mlp_specs(cfg, fd, "d0/", cfg.dense_d_ff or cfg.d_ff))
    specs.update(attn_specs(cfg, Lm, "blk/"))
    if cfg.is_moe:
        specs["blk/ln2"] = ParamSpec((Lm, D), ("layers", None), init="ones")
        specs.update(moe_param_specs(cfg, Lm, "blk/moe/"))
    else:
        specs.update(mlp_specs(cfg, Lm, "blk/", cfg.d_ff))
    return specs


def stacks(cfg: ModelConfig) -> List[Tuple[str, int, bool]]:
    """The layer stacks in order: (path prefix, layers, MoE FFN?)."""
    fd = cfg.first_dense
    return ([("d0/", fd, False)] if fd > 0 else []) + \
        [("blk/", cfg.num_layers - fd, cfg.is_moe)]


def _cache_keys(prefix: str) -> Tuple[str, str]:
    return ("k0", "v0") if prefix == "d0/" else ("k", "v")


def cast_param(cfg: ModelConfig, path: str, v: torch.Tensor) -> torch.Tensor:
    """One param as the compute sees it: fp32 if the reference reads it in
    fp32 (:data:`FP32_PARAMS`), else cast to the compute dtype."""
    return v if path.rsplit("/", 1)[-1] in FP32_PARAMS else v.to(Lx.cdtype(cfg))


def compute_params(cfg: ModelConfig, params: Params) -> Params:
    """The params as the compute sees them, made once, for every ported
    family: everything the reference casts to ``cfg.dtype`` at each use is
    cast here, what it reads in fp32 (:data:`FP32_PARAMS`) stays fp32.  For frozen weights this is bit-identical to casting
    at every use, and it saves re-reading the fp32 masters every step.
    ``unembed`` is the unembedding's fp32 weight, made here once rather
    than cast from the table at every step (``Lx.unembed_weight``).
    Idempotent: the engine may get params the router already converted."""
    out = {k: cast_param(cfg, k, v) for k, v in params.items()}
    if "unembed" not in out:
        out["unembed"] = Lx.unembed_weight(cfg, *unembed_table(cfg, out))
    return out


def unembed_table(cfg: ModelConfig, params: Params) -> Tuple[torch.Tensor, bool]:
    """(the table the logits multiply by, transposed?): the token embedding
    where it is tied (the enc-dec decoder always ties it), else
    ``lm_head``."""
    if cfg.tie_embeddings or cfg.family == "encdec":
        return params["tok_embed"], True
    return params["lm_head"], False


# ------------------------------------------------------------------ blocks
def layer_params(params: Params, i: int, prefix: str = "blk/") -> Params:
    """Layer ``i``'s slice of the stacked params (views, no copies)."""
    return {k[len(prefix):]: v[i] for k, v in params.items() if k.startswith(prefix)}


def unbind_layers(params: Params, L: int, prefix: str = "blk/") -> List[Params]:
    """Every layer's slice of the stacked params, by one ``unbind`` per
    param: under autograd each stacked gradient is then assembled once (one
    stack), where indexing would add a full-size zero-padded gradient per
    layer.  On a mesh it selects along ``layers``, which is never sharded."""
    cols = {k[len(prefix):]: v.unbind(0) for k, v in params.items() if k.startswith(prefix)}
    return [{k: c[i] for k, c in cols.items()} for i in range(L)]


# ------------------------------------------------------------- gather points
_GATHER_AXIS = "embed"  # the FSDP axis


def layer_axes(specs: Dict[str, ParamSpec], prefix: str) -> Dict[str, Tuple]:
    """Per-layer logical axes of the stacked params under ``prefix`` (the
    leading 'layers' dim dropped; a stack's own final norm is no layer's)."""
    return {path[len(prefix):]: tuple(a for a in s.axes if a != "layers")
            for path, s in specs.items()
            if path.startswith(prefix) and s.axes[:1] == ("layers",)}


def _gathered(axes: Tuple) -> Tuple:
    return tuple(None if a == _GATHER_AXIS else a for a in axes)


def gather_constrain(plan: Optional[ShardingPlan], tree: Params,
                     axes: Dict[str, Tuple]) -> Params:
    """Constrain every param to its *gathered* (non-FSDP) spec: the
    futurized plan's per-layer gather point."""
    return {k: Lx.constrain(plan, v, _gathered(axes[k])) for k, v in tree.items()}


def stacked_gather_constrain(plan: Optional[ShardingPlan], tree: Params,
                             axes: Dict[str, Tuple]) -> Params:
    """BSP: gather the whole stack up-front (axes still carry 'layers')."""
    return {k: Lx.constrain(plan, v, ("layers",) + _gathered(axes[k]))
            for k, v in tree.items()}


def stack_slices(specs: Dict[str, ParamSpec], params: Params, prefix: str, L: int,
                 plan: Optional[ShardingPlan]) -> List[Params]:
    """The layer slices of one stack at its gather point: the whole stack
    gathered before the loop (BSP, ``gather_upfront``), or each slice as
    it is reached (the futurized per-layer gather); ``specs`` are the
    family's param specs.  Without a mesh the constraints are identities."""
    ax = layer_axes(specs, prefix)
    stacked = {k: v for k, v in params.items() if k.startswith(prefix) and k[len(prefix):] in ax}
    if getattr(plan, "gather_upfront", False):
        stacked = stacked_gather_constrain(
            plan, {k[len(prefix):]: v for k, v in stacked.items()}, ax)
        stacked = {prefix + k: v for k, v in stacked.items()}
        return unbind_layers(stacked, L, prefix)
    return [gather_constrain(plan, lp, ax) for lp in unbind_layers(stacked, L, prefix)]


def _ffn(cfg: ModelConfig, x: torch.Tensor, lp: Params, moe_layer: bool,
         plan: Optional[ShardingPlan] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFN half of a layer: x + FFN(norm(x)), and the MoE aux loss
    (None for a dense FFN)."""
    h = Lx.norm(cfg, x, lp["ln2"])
    if moe_layer:
        ffn, aux = moe_ffn(cfg, h, lp, "moe/", plan=plan)
        return x + ffn, aux
    return x + Lx.mlp(cfg, h, lp, "", plan), None


def _layer_body(cfg: ModelConfig, x: torch.Tensor, lp: Params,
                positions: torch.Tensor, collect_kv: bool = False,
                plan: Optional[ShardingPlan] = None, moe_layer: bool = False):
    """→ (x, aux loss or None, (k, v) or None)."""
    x = Lx.constrain(plan, x, ("batch", "seq_sp", None))
    h = Lx.norm(cfg, x, lp["ln1"])
    out = Lx.attention(cfg, h, lp, "", positions, causal=cfg.causal,
                       window=cfg.window, return_kv=collect_kv, plan=plan)
    h, kv = out if collect_kv else (out, None)
    x, aux = _ffn(cfg, x + h, lp, moe_layer, plan)
    return x, aux, kv


def logits(cfg: ModelConfig, params: Params, x: torch.Tensor,
           plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    """The final norm and the unembedding: x (B,S,D) → logits fp32."""
    x = Lx.norm(cfg, x, params["final_ln"])
    return unembed(cfg, params, x, plan)


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor,
            plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    """x (B,S,D) → logits fp32 through ``params["unembed"]``, or through the
    table itself where the params have not been through compute_params."""
    w = params.get("unembed")
    if w is None:  # the fp32 masters, not yet through compute_params
        w = Lx.unembed_weight(cfg, *unembed_table(cfg, params))
    return Lx.unembed(cfg, x, w, plan)


def splice_patches(cfg: ModelConfig, x: torch.Tensor,
                   patches: Optional[torch.Tensor]) -> torch.Tensor:
    """The VLM family's input: the patch embeddings (B, n_patches, D) over
    the first ``n_patches`` positions of the token embeddings x (B, S, D);
    x itself for the other families, or where no patches are given (a
    prefill may leave them out, as in the reference)."""
    if cfg.family != "vlm" or patches is None:
        return x
    return torch.cat([patches.to(x.dtype), x[:, cfg.n_patches:, :]], dim=1)


# ------------------------------------------------------------------ forward
def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            plan: Optional[ShardingPlan] = None,
            patches: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) → (logits fp32 (B,S,V), aux_loss: the sum over the
    MoE layers).  The VLM family needs ``patches`` (B, n_patches, D).  Each
    layer runs under the plan's remat policy (``Lx.remat_wrap``)."""
    if cfg.family == "vlm" and patches is None:
        raise ValueError("the vlm family needs patch embeddings")
    x = splice_patches(cfg, Lx.embed(cfg, params["tok_embed"], tokens, plan), patches)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for prefix, L, moe_layer in stacks(cfg):
        body = Lx.remat_wrap(plan, functools.partial(
            _layer_body, cfg, positions=positions, plan=plan, moe_layer=moe_layer))
        for lp in stack_slices(decoder_param_specs(cfg), params, prefix, L, plan):
            x, a, _ = body(x, lp)
            if a is not None:
                aux = aux + a
    return logits(cfg, params, x, plan), aux


def loss_fn(cfg: ModelConfig, plan: ShardingPlan, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token loss: tokens[:, :-1] → logits, labels tokens[:, 1:]; the
    VLM family's image positions (the first ``n_patches``) carry none."""
    tokens = batch["tokens"]
    lg, aux = forward(cfg, params, tokens[:, :-1], plan=plan, patches=batch.get("patches"))
    labels = tokens[:, 1:]
    mask = None
    if cfg.family == "vlm":
        pos = torch.arange(labels.shape[1], device=labels.device)
        mask = (pos >= cfg.n_patches).float()[None, :].expand(labels.shape)
    return Lx.cross_entropy(lg, labels, mask) + cfg.router_aux_weight * aux


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            valid_len: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            plan: Optional[ShardingPlan] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-pass forward + KV-cache collection.

    Returns (last-position logits (B, V) fp32, cache with ``k``/``v``
    (L, B, T, KV, Dh) and ``pos`` (B,)).  ``valid_len`` (scalar or (B,))
    supports right-padded prompts: logits are taken at ``valid_len - 1``
    and ``pos`` starts there; causality keeps the pad positions inert.
    The VLM family's ``patches`` take the first ``n_patches`` positions.
    On a mesh, ``plan`` places the layers' gather points and constraints
    as in training.
    """
    B, S = tokens.shape
    T = cache_len or S
    if T < S:
        raise ValueError(f"cache_len {T} shorter than the prompt {S}")
    dev = tokens.device
    x = splice_patches(cfg, Lx.embed(cfg, params["tok_embed"], tokens, plan), patches)
    positions = torch.arange(S, dtype=torch.int32, device=dev)
    dt = Lx.cdtype(cfg)
    specs = decoder_param_specs(cfg)
    cache = {}
    for prefix, L, moe_layer in stacks(cfg):
        ks, vs = [], []
        for lp in stack_slices(specs, params, prefix, L, plan):
            x, _, (k, v) = _layer_body(cfg, x, lp, positions, collect_kv=True,
                                       plan=plan, moe_layer=moe_layer)
            ks.append(k)
            vs.append(v)
        kn, vn = _cache_keys(prefix)
        cache[kn], cache[vn] = torch.stack(ks).to(dt), torch.stack(vs).to(dt)
    if T > S:  # zero-fill positions S..T-1
        cache = {n: Lx.pad_cache(c, T) for n, c in cache.items()}
    if valid_len is None:
        cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=dev)
        x_last = x[:, -1:, :]
    else:
        vl = torch.as_tensor(valid_len, dtype=torch.int32, device=dev).broadcast_to((B,))
        cache["pos"] = vl.clone()
        idx = (vl.long() - 1).clamp(0, S - 1)
        x_last = x[torch.arange(B, device=dev), idx][:, None, :]
    return logits(cfg, params, x_last, plan)[:, 0, :], cache


# -------------------------------------------------------------------- cache
def init_cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, TensorSpec]:
    """The seed's dense per-slot KV cache: (L, batch, cache_len, KV, Dh)
    K and V for each stack (``k0``/``v0`` for ``d0/``), and each slot's
    fill position."""
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    dt = Lx.cdtype(cfg)
    specs = {"pos": TensorSpec((batch,), torch.int32)}
    for prefix, L, _ in stacks(cfg):
        for name in _cache_keys(prefix):
            specs[name] = TensorSpec((L, batch, cache_len, KV, Dh), dt)
    return specs


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of each field of the dense decode cache."""
    ax = ("layers", "batch", "kv_seq", "kv_heads", None)
    out = {"pos": ("batch",)}
    for prefix, _, _ in stacks(cfg):
        for name in _cache_keys(prefix):
            out[name] = ax
    return out


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, plan: Optional[ShardingPlan] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against the dense cache (see init_cache_specs).
    token: (B, 1) → (logits (B,V) fp32, new cache).  The new token's K/V
    are written into the cache in place; the returned cache holds the same
    tensors and ``pos + 1``.  On a mesh, ``plan`` places the layers'
    gather points, and the cache keeps the placements of
    :func:`cache_axes`."""
    pos = cache["pos"]
    x = Lx.embed(cfg, params["tok_embed"], token, plan)
    specs = decoder_param_specs(cfg)
    for prefix, L, moe_layer in stacks(cfg):
        kc, vc = (cache[n] for n in _cache_keys(prefix))
        for i, lp in enumerate(stack_slices(specs, params, prefix, L, plan)):
            h = Lx.norm(cfg, x, lp["ln1"])
            h, _, _ = Lx.decode_attention(cfg, h, lp, "", kc[i], vc[i], pos,
                                          window=cfg.window, plan=plan)
            x, _ = _ffn(cfg, x + h, lp, moe_layer, plan)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits(cfg, params, x, plan)[:, 0, :], new_cache


def paged_cache_specs(cfg: ModelConfig, num_pages: int, page_size: int,
                      max_batch: int, max_pages_per_req: int) -> Dict[str, TensorSpec]:
    """The *paged* KV cache: a block pool of ``num_pages`` fixed
    ``page_size`` pages shared by every layer (the same page index holds a
    request's tokens in all layers), plus per-slot page tables and fill
    positions.  Memory scales with live tokens, not max_batch × cache_len.
    Each stack has its pools (``k0``/``v0`` for ``d0/``)."""
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    dt = Lx.cdtype(cfg)
    specs = {}
    for prefix, L, _ in stacks(cfg):
        for name in _cache_keys(prefix):
            specs[name] = TensorSpec((L, num_pages, page_size, KV, Dh), dt)
    specs["page_table"] = TensorSpec((max_batch, max_pages_per_req), torch.int32)
    specs["pos"] = TensorSpec((max_batch,), torch.int32)
    return specs


def decode_step_paged(cfg: ModelConfig, params: Params,
                      cache: Dict[str, torch.Tensor], token: torch.Tensor,
                      plan: Optional[ShardingPlan] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against the paged cache (see paged_cache_specs).
    token: (B, 1) → (logits (B,V) fp32, new cache).  The new token's K/V
    are written into the pools in place; the returned cache holds the same
    pool tensors and ``pos + 1``."""
    pos, pt = cache["pos"], cache["page_table"]
    x = Lx.embed(cfg, params["tok_embed"], token, plan)
    specs = decoder_param_specs(cfg)
    for prefix, L, moe_layer in stacks(cfg):
        kp, vp = (cache[n] for n in _cache_keys(prefix))
        for i, lp in enumerate(stack_slices(specs, params, prefix, L, plan)):
            h = Lx.norm(cfg, x, lp["ln1"])
            h, _, _ = Lx.paged_decode_attention(cfg, h, lp, "", kp[i], vp[i], pt, pos,
                                                plan=plan)
            x, _ = _ffn(cfg, x + h, lp, moe_layer, plan)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits(cfg, params, x, plan)[:, 0, :], new_cache
