"""Mamba-2 language model: embed → SSD blocks → tied logits, ported from
the reference's ``models/ssm_lm.py``.

The decode cache is O(1) in the sequence: per layer the conv state (the
last K − 1 pre-conv inputs) and the fp32 SSD state.  As in the port's
paged decode, :func:`decode_step` writes the new states into the cache's
tensors in place and returns a cache holding the same tensors and
``pos + 1``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan
from repro_torch.models import layers as Lx
from repro_torch.models.params import ParamSpec, TensorSpec
from repro_torch.models.ssm import ssm_block, ssm_block_decode, ssm_dims, ssm_param_specs
from repro_torch.models.transformer import logits, stack_slices

Params = Dict[str, torch.Tensor]


def lm_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    D, V = cfg.d_model, cfg.padded_vocab
    specs: Dict[str, ParamSpec] = {
        "tok_embed": ParamSpec((V, D), ("vocab", "embed"), scale=0.02),
        "final_ln": ParamSpec((D,), (None,), init="ones"),
    }
    specs.update(ssm_param_specs(cfg, cfg.num_layers, "blk/"))
    return specs


def _blocks(cfg: ModelConfig, params: Params, plan: Optional[ShardingPlan]):
    """Each block's params at its gather point (``stack_slices``)."""
    return stack_slices(lm_param_specs(cfg), params, "blk/", cfg.num_layers, plan)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            plan: Optional[ShardingPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) → (logits fp32 (B,S,V), aux_loss 0).  Each block runs
    under the plan's remat policy (``Lx.remat_wrap``), as the reference
    wraps its scan body; on a mesh its params are gathered at the plan's
    gather point and its input is batch-sharded, as in the reference."""
    x = Lx.embed(cfg, params["tok_embed"], tokens, plan)

    def block(x, lp):
        return ssm_block(cfg, Lx.constrain(plan, x, ("batch", "seq", None)), lp, "",
                         plan=plan)

    body = Lx.remat_wrap(plan, block)
    for lp in _blocks(cfg, params, plan):
        x = body(x, lp)
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
    """The SSM decode state is O(1): ``cache_len`` is ignored (kept for the
    API)."""
    d = ssm_dims(cfg)
    L = cfg.num_layers
    return {
        "conv": TensorSpec((L, batch, cfg.ssm_conv - 1, d["conv_ch"]), Lx.cdtype(cfg)),
        "state": TensorSpec((L, batch, d["H"], d["P"], d["N"]), torch.float32),
        "pos": TensorSpec((batch,), torch.int32),
    }


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of each decode-cache field."""
    return {
        "conv": ("layers", "batch", None, "ssm_inner"),
        "state": ("layers", "batch", "ssm_heads", None, None),
        "pos": ("batch",),
    }


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None, plan: Optional[ShardingPlan] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B, S) at their exact length → (last-position logits (B, V)
    fp32, cache).  One SSD scan per layer, each returning its fp32 final
    state."""
    B, S = tokens.shape
    x = Lx.embed(cfg, params["tok_embed"], tokens, plan)
    convs, states = [], []
    for lp in _blocks(cfg, params, plan):
        x, (conv, state) = ssm_block(cfg, Lx.constrain(plan, x, ("batch", "seq", None)),
                                     lp, "", collect_state=True, plan=plan)
        convs.append(conv)
        states.append(state)
    cache = {"conv": torch.stack(convs), "state": torch.stack(states),
             "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device)}
    return logits(cfg, params, x[:, -1:, :], plan)[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, plan: Optional[ShardingPlan] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. token: (B, 1) → (logits (B,V) fp32, new cache); the
    conv and SSD states are updated in place."""
    x = Lx.embed(cfg, params["tok_embed"], token, plan)
    conv, state = cache["conv"], cache["state"]
    for i, lp in enumerate(_blocks(cfg, params, plan)):
        x, new_conv, new_state = ssm_block_decode(cfg, x, lp, "", conv[i], state[i], plan)
        conv[i].copy_(new_conv)
        state[i].copy_(new_state)
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + 1
    return logits(cfg, params, x, plan)[:, 0, :], new_cache
