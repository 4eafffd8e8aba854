"""Mixture-of-Experts FFN: shared + routed experts, top-k, capacity
dispatch — ported from the reference's ``models/moe.py``.

A token assigned to an expert is the reference's *parcel*: it travels to
the expert's rows of a capacity buffer, the expert GEMMs run there, and
the result comes back through the combine.  Capacity factor and the
Switch aux loss keep the load balanced at dispatch time.

Dispatch is **grouped-local**, as in the reference: the ``T = B·S``
tokens are viewed as ``(G, T/G, D)`` with ``G`` the batch-sharding degree
(pod × data) of the active mesh (:func:`_group_count`; one group with no
mesh), and ranks, capacity and the dispatch buffers are per group.  On a
mesh the tokens are a DTensor sharded over the groups, and the group-local
body (routing, dispatch, the expert GEMMs, combine) runs on each rank's
own groups through ``local_map``: nothing of it crosses ranks but the aux
loss's two global means.  The expert weights enter that body gathered
(replicated over the model axis), so the reference's two constraints of
the capacity buffers (experts over ``model``) have nothing to act on:
expert parallelism over the model axis is left for a later slice.

Steps, each as the reference does them:

- routing logits in fp32 from the router weights cast to the compute
  dtype (products of compute-dtype values are exact in fp32, so the fp32
  matmul of the cast operands is the reference's fp32-accumulated einsum);
  softmax, top-k, the top-k weights renormalised;
- the Switch aux loss ``E·Σ_e f_e·P_e``;
- capacity ``C = max(int(cf·A/E), min(A, 16), 1)`` for the ``A = (T/G)·k``
  assignments of a group; the rank of each assignment within its expert
  by a one-hot cumsum in token order (no sort); ranks at or past ``C`` go
  to a trap row ``E·C`` that is dropped;
- the dispatch scatter-add into each group's ``(E·C + 1, D)`` buffer,
  the three expert GEMMs over ``(G, E, C, D)``, the gather and weighted
  scatter-add of the combine;
- the always-on shared experts, a gated MLP of width ``n_shared·d_ff``.

Padding tokens of a right-padded prefill route and take capacity exactly
as in the reference, so a bucketed prefill gives the reference's tokens.
On the card the scatter-adds use atomics, so bf16 outputs may differ
between runs in summation order.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan, _active_mesh, mesh_sizes
from repro_torch.models.layers import act_fn, cdtype, constrain
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


def _group_count(T: int) -> int:
    """Dispatch groups = batch-sharding degree of the active mesh."""
    mesh = _active_mesh()
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    g = 1
    for ax in ("pod", "data"):
        g *= sizes.get(ax, 1)
    return g if g > 1 and T % g == 0 else 1


def _route(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (..., D) → (renormalised top-k weights (..., k) fp32, expert ids
    (..., k), and the sums over tokens of the one-hot choices (E,) and of
    the probabilities (E,), fp32: the aux loss's two means before their
    division, which a mesh finishes across ranks)."""
    E = cfg.n_experts
    logits = xt.float() @ router.to(cdtype(cfg)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    f_sum = F.one_hot(gate_i, E).float().reshape(-1, E).sum(dim=0)
    p_sum = probs.reshape(-1, E).sum(dim=0)
    return gate_w, gate_i, f_sum, p_sum


def _aux(cfg: ModelConfig, f_sum: torch.Tensor, p_sum: torch.Tensor, T: int) -> torch.Tensor:
    """The Switch aux loss ``E·Σ_e f_e·P_e`` from the sums over T tokens."""
    E, K = cfg.n_experts, cfg.top_k
    return E * ((f_sum / (T * K)) * (p_sum / T)).sum()


def route(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, D) → (renormalised top-k weights (T, k) fp32, expert ids
    (T, k), aux loss fp32)."""
    gate_w, gate_i, f_sum, p_sum = _route(cfg, xt, router)
    return gate_w, gate_i, _aux(cfg, f_sum, p_sum, xt.shape[0])


def dispatch_slots(cfg: ModelConfig, gate_i: torch.Tensor, C: int) -> torch.Tensor:
    """Each assignment's row of its group's capacity buffer: ``e·C + rank``
    where ``rank`` is its place among the group's assignments to expert
    ``e`` in token order, or the trap row ``E·C`` where the rank reaches
    ``C``.  gate_i: (T, k) → (T·k,), or per group (G, TL, k) → (G, TL·k);
    int64."""
    if gate_i.dim() == 2:
        return dispatch_slots(cfg, gate_i[None], C)[0]
    E = cfg.n_experts
    flat_e = gate_i.reshape(gate_i.shape[0], -1)
    onehot = (flat_e[..., None] == torch.arange(E, device=flat_e.device)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1).gather(2, flat_e[..., None])[..., 0] - 1
    return torch.where(pos < C, flat_e * C + pos, torch.full_like(flat_e, E * C))


def _grouped(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor,
             w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The group-local body on plain tensors: xt (G, TL, D) → (routed
    output (G, TL, D) in the compute dtype, f_sum, p_sum)."""
    dt = cdtype(cfg)
    G, TL, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    gate_w, gate_i, f_sum, p_sum = _route(cfg, xt, router)

    A = TL * K
    C = capacity(cfg, A)
    slot = dispatch_slots(cfg, gate_i, C)                     # (G, A)
    rows = E * C + 1                                          # + the trap row
    gslot = (slot + torch.arange(G, device=xt.device)[:, None] * rows).reshape(-1)
    updates = xt[:, :, None, :].expand(G, TL, K, D).reshape(G * A, D).to(dt)
    buf = torch.zeros(G * rows, D, dtype=dt, device=xt.device).index_add(0, gslot, updates)
    buf = buf.reshape(G, rows, D)[:, : E * C].reshape(G, E, C, D)

    # the expert GEMMs, batched over the groups' experts
    def gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.einsum("gecd,edf->gecf", a, w.to(dt))

    out_buf = gemm(act_fn(cfg, gemm(buf, w_gate)) * gemm(buf, w_in), w_out)

    # combine: gather each assignment's row (the trap row reads zeros),
    # weight it, scatter-add it to its token
    flat_out = torch.cat([out_buf.reshape(G, E * C, D), out_buf.new_zeros(G, 1, D)], dim=1)
    y_assign = flat_out.reshape(G * rows, D).index_select(0, gslot)
    y_assign = y_assign * gate_w.reshape(G * A, 1).to(dt)
    tok_of = torch.arange(G * TL, device=xt.device).repeat_interleave(K)
    y = torch.zeros(G * TL, D, dtype=dt, device=xt.device).index_add(0, tok_of, y_assign)
    return y.reshape(G, TL, D), f_sum, p_sum


def moe_ffn(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str = "",
            plan: Optional[ShardingPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D) in the compute dtype, aux loss fp32)."""
    B, S, D = x.shape
    T = B * S
    G = _group_count(T)
    xt = constrain(plan, x.reshape(G, T // G, D), ("batch", None, None))
    weights = [p[f"{prefix}{n}"] for n in ("router", "w_in", "w_gate", "w_out")]
    if isinstance(xt, DTensor):
        mesh = xt.device_mesh
        pl = list(xt.placements)
        rep = [Replicate()] * len(pl)
        sums = [Partial() if pp != Replicate() else Replicate() for pp in pl]
        weights = [w.redistribute(mesh, rep) for w in weights]
        # each rank's weight gradient covers its own groups' tokens: a
        # partial sum over the batch mesh dims
        y, f_sum, p_sum = local_map(
            functools.partial(_grouped, cfg), out_placements=(pl, sums, sums),
            in_placements=(pl,) + (rep,) * 4,
            in_grad_placements=(pl,) + (sums,) * 4, device_mesh=mesh)(xt, *weights)
    else:
        y, f_sum, p_sum = _grouped(cfg, xt, *weights)
    y = constrain(plan, y, ("batch", None, None))
    aux = _aux(cfg, f_sum, p_sum, T)  # Switch load balance: global means

    y = y.reshape(T, D)
    if cfg.n_shared_experts > 0:
        # the weights cast to dt, then promoted with x's dtype, as jnp's @
        # promotes (the model's x is already in dt)
        dt = cdtype(cfg)
        xs = xt.reshape(T, D)
        st = torch.promote_types(xs.dtype, dt)
        w_in, w_gate, w_out = (p[f"{prefix}shared_{n}"].to(dt).to(st)
                               for n in ("w_in", "w_gate", "w_out"))
        y = y + (act_fn(cfg, xs @ w_gate) * (xs @ w_in)) @ w_out
    return y.reshape(B, S, D), aux
