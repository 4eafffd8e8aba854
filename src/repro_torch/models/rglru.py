"""Griffin / RecurrentGemma recurrent blocks [arXiv:2402.19427], ported
from the reference's ``models/rglru.py``: the RG-LRU recurrence behind a
causal conv, gated by a GELU branch.

RG-LRU recurrence (per channel):

    r_t = σ(W_a x_t + b_a)                   recurrence gate
    i_t = σ(W_x x_t + b_x)                   input gate
    a_t = exp(-c · softplus(Λ) · r_t)        c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill and training run the recurrence through ``ops.rglru_scan_trainable``
(the Hopper kernel on CUDA tensors, its plain version on CPU ones), with
fp32 a and b; its backward is the reverse recurrence on the same kernel.
Decode is the O(1) recurrence in plain tensor ops.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan
from repro_torch.kernels import ops
from repro_torch.models.layers import BATCH, cdtype, norm, on_shards, residual, rows, whole
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import causal_conv1d, conv_state, conv_step

Params = Dict[str, torch.Tensor]

_RGLRU_C = 8.0


def rec_param_specs(cfg: ModelConfig, L: int, prefix: str) -> Dict[str, ParamSpec]:
    """Recurrent-block params, stacked (L, …)."""
    D, W = cfg.d_model, cfg.lru_width
    return {
        f"{prefix}ln": ParamSpec((L, D), ("layers", None), init="ones"),
        f"{prefix}w_x": ParamSpec((L, D, W), ("layers", "embed", "lru")),
        f"{prefix}w_gate_branch": ParamSpec((L, D, W), ("layers", "embed", "lru")),
        f"{prefix}conv_w": ParamSpec((L, cfg.ssm_conv, W), ("layers", None, "lru"),
                                     init="scaled", scale=0.5),
        f"{prefix}conv_b": ParamSpec((L, W), ("layers", "lru"), init="zeros"),
        f"{prefix}lam": ParamSpec((L, W), ("layers", "lru"), init="ones"),
        f"{prefix}w_a": ParamSpec((L, W, W), ("layers", "lru", None)),
        f"{prefix}b_a": ParamSpec((L, W), ("layers", "lru"), init="zeros"),
        f"{prefix}w_i": ParamSpec((L, W, W), ("layers", "lru", None)),
        f"{prefix}b_i": ParamSpec((L, W), ("layers", "lru"), init="zeros"),
        f"{prefix}rec_out": ParamSpec((L, W, D), ("layers", "lru", "embed")),
    }


def _gates(p: Params, prefix: str, xw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a (the decay) and the gated input for the recurrence, both fp32.
    xw: (..., W).  The gate products run in fp32 on fp32 weights, as in
    the reference (on the card with TF32 off, torch's default)."""
    xf = xw.float()
    r = torch.sigmoid(xf @ p[f"{prefix}w_a"].float() + p[f"{prefix}b_a"].float())
    i = torch.sigmoid(xf @ p[f"{prefix}w_i"].float() + p[f"{prefix}b_i"].float())
    log_a = -_RGLRU_C * F.softplus(p[f"{prefix}lam"].float()) * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
    return a, gated_x


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t through ``ops.rglru_scan_trainable`` (the
    kernel forward, with a backward in grad mode). a/b: (B,S,W) fp32;
    ``h0`` (B,W) is folded into the first step: b_0 += a_0·h0.  On a mesh
    each rank scans its own batch rows (``on_shards``)."""
    if h0 is not None:
        b = b.clone()
        b[:, 0, :] += a[:, 0, :] * h0
    return on_shards(ops.rglru_scan_trainable, (a, b), (BATCH, BATCH), BATCH)


def rec_block(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
              collect_state: bool = False, plan: Optional[ShardingPlan] = None):
    """Griffin recurrent block (train/prefill): x (B,S,D) → (B,S,D); with
    ``collect_state`` also (conv_state (B,K−1,W) in the compute dtype, the
    final carry h_S (B,W) fp32) for the decode cache.  On a mesh
    (``plan``) the recurrence's input is batch-sharded."""
    dt = cdtype(cfg)
    h = norm(cfg, x, p[f"{prefix}ln"])
    gate = F.gelu(h @ p[f"{prefix}w_gate_branch"].to(dt), approximate="tanh")
    xw_raw = rows(plan, h @ p[f"{prefix}w_x"].to(dt))
    xw = causal_conv1d(xw_raw, p[f"{prefix}conv_w"], p[f"{prefix}conv_b"])
    a, gx = _gates(p, prefix, xw)
    hseq = rglru_scan(a, gx)
    y = residual(plan, (gate * hseq.to(dt)) @ p[f"{prefix}rec_out"].to(dt))
    if not collect_state:
        return x + y
    return x + y, (conv_state(cfg, xw_raw), hseq[:, -1, :].float())


def rec_block_decode(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
                     conv_state: torch.Tensor, h_state: torch.Tensor,
                     plan: Optional[ShardingPlan] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,D); conv_state: (B,K−1,W); h_state: (B,W)
    fp32. Returns (out, new_conv_state, new_h)."""
    dt = cdtype(cfg)
    h = norm(cfg, x, p[f"{prefix}ln"])[:, 0]  # (B,D)
    gate = F.gelu(h @ p[f"{prefix}w_gate_branch"].to(dt), approximate="tanh")
    xw, new_conv = conv_step(cfg, rows(plan, conv_state),
                             rows(plan, h @ p[f"{prefix}w_x"].to(dt)),
                             whole(plan, p[f"{prefix}conv_w"]),
                             whole(plan, p[f"{prefix}conv_b"]))
    a, gx = _gates(p, prefix, xw)
    new_h = a * h_state.float() + gx
    y = residual(plan, ((gate * new_h.to(dt)) @ p[f"{prefix}rec_out"].to(dt))[:, None, :])
    return x + y, new_conv.to(conv_state.dtype), new_h.to(h_state.dtype)
