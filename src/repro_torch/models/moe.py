"""Mixture-of-Experts FFN: shared + routed experts, top-k, capacity
dispatch — ported from the reference's ``models/moe.py``.

A token assigned to an expert is the reference's *parcel*: it travels to
the expert's rows of a capacity buffer, the expert GEMMs run there, and
the result comes back through the combine.  Capacity factor and the
Switch aux loss keep the load balanced at dispatch time.

The reference groups tokens by the batch-sharding degree of its mesh
(``_group_count``); with no mesh that is one group, and so it is here:
all ``T = B·S`` tokens are one group, and the port has no mesh code.

Steps, each as the reference does them:

- routing logits in fp32 from the router weights cast to the compute
  dtype (products of compute-dtype values are exact in fp32, so the fp32
  matmul of the cast operands is the reference's fp32-accumulated einsum);
  softmax, top-k, the top-k weights renormalised;
- the Switch aux loss ``E·Σ_e f_e·P_e``;
- capacity ``C = max(int(cf·A/E), min(A, 16), 1)`` for ``A = T·k``
  assignments; the rank of each assignment within its expert by a one-hot
  cumsum in token order (no sort); ranks at or past ``C`` go to a trap row
  ``E·C`` that is dropped;
- the dispatch scatter-add into the ``(E·C + 1, D)`` buffer, the three
  expert GEMMs over ``(E, C, D)``, the gather and weighted scatter-add of
  the combine;
- the always-on shared experts, a gated MLP of width ``n_shared·d_ff``.

Padding tokens of a right-padded prefill route and take capacity exactly
as in the reference, so a bucketed prefill gives the reference's tokens.
On the card the scatter-adds use atomics, so bf16 outputs may differ
between runs in summation order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, cdtype
from repro_torch.models.params import ParamSpec

Params = Dict[str, torch.Tensor]


def moe_param_specs(cfg: ModelConfig, L: int, prefix: str) -> Dict[str, ParamSpec]:
    """Stacked (L, …) specs for the routed-expert FFN of ``L`` layers."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs: Dict[str, ParamSpec] = {
        f"{prefix}router": ParamSpec((L, D, E), ("layers", "embed", None)),
        f"{prefix}w_in": ParamSpec((L, E, D, F_), ("layers", "experts", "embed", "mlp")),
        f"{prefix}w_gate": ParamSpec((L, E, D, F_), ("layers", "experts", "embed", "mlp")),
        f"{prefix}w_out": ParamSpec((L, E, F_, D), ("layers", "experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts > 0:
        Fs = cfg.n_shared_experts * F_
        specs.update({
            f"{prefix}shared_w_in": ParamSpec((L, D, Fs), ("layers", "embed", "mlp")),
            f"{prefix}shared_w_gate": ParamSpec((L, D, Fs), ("layers", "embed", "mlp")),
            f"{prefix}shared_w_out": ParamSpec((L, Fs, D), ("layers", "mlp", "embed")),
        })
    return specs


def capacity(cfg: ModelConfig, assignments: int) -> int:
    """Slots per expert for ``assignments`` (token, expert) pairs.  The
    floor ``min(A, 16)`` keeps small batches (decode) from ever dropping."""
    A = assignments
    return max(int(cfg.capacity_factor * A / cfg.n_experts), min(A, 16), 1)


def route(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, D) → (renormalised top-k weights (T, k) fp32, expert ids
    (T, k), aux loss fp32)."""
    E = cfg.n_experts
    logits = xt.float() @ router.to(cdtype(cfg)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    f_e = F.one_hot(gate_i, E).float().mean(dim=(0, 1))
    aux = E * (f_e * probs.mean(dim=0)).sum()
    return gate_w, gate_i, aux


def dispatch_slots(cfg: ModelConfig, gate_i: torch.Tensor, C: int) -> torch.Tensor:
    """Each assignment's row of the capacity buffer: ``e·C + rank`` where
    ``rank`` is its place among the assignments to expert ``e`` in token
    order, or the trap row ``E·C`` where the rank reaches ``C``.
    gate_i: (T, k) → (T·k,) int64."""
    E = cfg.n_experts
    flat_e = gate_i.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(E, device=flat_e.device)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0).gather(1, flat_e[:, None])[:, 0] - 1
    return torch.where(pos < C, flat_e * C + pos, torch.full_like(flat_e, E * C))


def moe_ffn(cfg: ModelConfig, x: torch.Tensor, p: Params,
            prefix: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D) in the compute dtype, aux loss fp32)."""
    dt = cdtype(cfg)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    gate_w, gate_i, aux = route(cfg, xt, p[f"{prefix}router"])

    A = T * K
    C = capacity(cfg, A)
    slot = dispatch_slots(cfg, gate_i, C)
    tok_of = torch.arange(T, device=x.device).repeat_interleave(K)
    updates = xt[:, None, :].expand(T, K, D).reshape(A, D).to(dt)  # xt[tok_of]
    buf = torch.zeros(E * C + 1, D, dtype=dt, device=x.device).index_add(0, slot, updates)
    buf = buf[: E * C].reshape(E, C, D)

    # the expert GEMMs, batched over E
    h = torch.bmm(buf, p[f"{prefix}w_in"].to(dt))
    g = torch.bmm(buf, p[f"{prefix}w_gate"].to(dt))
    out_buf = torch.bmm(act_fn(cfg, g) * h, p[f"{prefix}w_out"].to(dt))

    # combine: gather each assignment's row (the trap row reads zeros),
    # weight it, scatter-add it to its token
    flat_out = torch.cat([out_buf.reshape(E * C, D), out_buf.new_zeros(1, D)])
    y_assign = flat_out.index_select(0, slot) * gate_w.reshape(A, 1).to(dt)
    y = torch.zeros(T, D, dtype=dt, device=x.device).index_add(0, tok_of, y_assign)

    if cfg.n_shared_experts > 0:
        # the weights cast to dt, then promoted with x's dtype, as jnp's @
        # promotes (the model's x is already in dt)
        st = torch.promote_types(xt.dtype, dt)
        w_in, w_gate, w_out = (p[f"{prefix}shared_{n}"].to(dt).to(st)
                               for n in ("w_in", "w_gate", "w_out"))
        y = y + (act_fn(cfg, xt @ w_gate) * (xt @ w_in)) @ w_out
    return y.reshape(B, S, D), aux
