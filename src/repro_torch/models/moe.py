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
mesh the tokens are a DTensor sharded over the groups: routing, dispatch
and combine run on each rank's own groups through ``local_map``, and the
capacity buffers carry the reference's two constraints (experts over
``model``), so the expert GEMMs run expert-parallel on each rank's
experts (:func:`moe_ffn`).

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan, _active_mesh, mesh_sizes
from repro_torch.models.layers import act_fn, cdtype, constrain, residual
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


def _dispatch(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routing and the dispatch scatter on plain tensors: xt (G, TL, D) →
    (each group's capacity buffer (G, E, C, D) in the compute dtype, each
    assignment's row of the groups' stacked buffers with their trap rows
    (G, A) int64, the top-k weights (G, TL, k) fp32, f_sum, p_sum)."""
    dt = cdtype(cfg)
    G, TL, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    gate_w, gate_i, f_sum, p_sum = _route(cfg, xt, router)
    A = TL * K
    C = capacity(cfg, A)
    slot = dispatch_slots(cfg, gate_i, C)                     # (G, A)
    rows = E * C + 1                                          # + the trap row
    gslot = slot + torch.arange(G, device=xt.device)[:, None] * rows
    updates = xt[:, :, None, :].expand(G, TL, K, D).reshape(G * A, D).to(dt)
    buf = torch.zeros(G * rows, D, dtype=dt, device=xt.device).index_add(
        0, gslot.reshape(-1), updates)
    return buf.reshape(G, rows, D)[:, : E * C].reshape(G, E, C, D), gslot, gate_w, f_sum, p_sum


def _experts(cfg: ModelConfig, buf: torch.Tensor, w_in: torch.Tensor,
             w_gate: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """The expert GEMMs, batched over the groups' experts: buf (G, E, C, D)
    → (G, E, C, D).  On shards of the experts or of d_ff it is the same
    code on each rank's slices (a d_ff shard gives a partial sum)."""
    dt = cdtype(cfg)

    def gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.einsum("gecd,edf->gecf", a, w.to(dt))

    return gemm(act_fn(cfg, gemm(buf, w_gate)) * gemm(buf, w_in), w_out)


def _combine(cfg: ModelConfig, out_buf: torch.Tensor, gslot: torch.Tensor,
             gate_w: torch.Tensor) -> torch.Tensor:
    """Gather each assignment's row of its group's output buffer (the trap
    row reads zeros), weight it and scatter-add it to its token: → (G, TL, D)."""
    dt = cdtype(cfg)
    G, E, C, D = out_buf.shape
    TL, K = gate_w.shape[1], cfg.top_k
    rows = E * C + 1
    flat_out = torch.cat([out_buf.reshape(G, E * C, D), out_buf.new_zeros(G, 1, D)], dim=1)
    y_assign = flat_out.reshape(G * rows, D).index_select(0, gslot.reshape(-1))
    y_assign = y_assign * gate_w.reshape(G * TL * K, 1).to(dt)
    tok_of = torch.arange(G * TL, device=gslot.device).repeat_interleave(K)
    y = torch.zeros(G * TL, D, dtype=dt, device=gslot.device).index_add(0, tok_of, y_assign)
    return y.reshape(G, TL, D)


def _grouped(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor,
             w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The group-local body on plain tensors: xt (G, TL, D) → (routed
    output (G, TL, D) in the compute dtype, f_sum, p_sum)."""
    buf, gslot, gate_w, f_sum, p_sum = _dispatch(cfg, xt, router)
    return _combine(cfg, _experts(cfg, buf, w_in, w_gate, w_out), gslot, gate_w), f_sum, p_sum


def _experts_on_mesh(cfg: ModelConfig, buf: DTensor, weights) -> DTensor:
    """The expert GEMMs on each rank's shards.  Per mesh dim, by the
    placements the capacity buffer and the gathered weights have: a batch
    dim (buffer on its groups, weights replicated, their gradient a
    partial sum), expert parallelism (buffer and weights on the experts),
    tensor parallelism over d_ff (weights on d_ff, buffer replicated, the
    output a partial sum), or replicated."""
    mesh = buf.device_mesh
    w_in = weights[0]
    b_in, w_pl, out, b_grad, w_grad = [], [[], [], []], [], [], [[], [], []]
    for i, bp in enumerate(buf.placements):
        wp = w_in.placements[i]
        if isinstance(bp, Shard) and bp.dim == 0:        # dispatch groups
            role, wd = (Shard(0), Shard(0), Shard(0)), (None, None, None)
        elif isinstance(bp, Shard) and bp.dim == 1:      # experts
            role, wd = (Shard(1), Shard(1), Shard(1)), (0, 0, 0)
        elif isinstance(wp, Shard) and wp.dim == 2:      # d_ff
            role, wd = (Replicate(), Partial(), Partial()), (2, 2, 1)
        else:
            role, wd = (Replicate(), Replicate(), Replicate()), (None, None, None)
        b_in.append(role[0])
        out.append(role[1])
        b_grad.append(role[2])
        for j, d in enumerate(wd):
            w_pl[j].append(Replicate() if d is None else Shard(d))
            w_grad[j].append(Partial() if isinstance(bp, Shard) and bp.dim == 0
                             else Replicate() if d is None else Shard(d))
    buf = buf.redistribute(mesh, b_in)
    weights = [w.redistribute(mesh, pl) for w, pl in zip(weights, w_pl)]
    return local_map(functools.partial(_experts, cfg), out_placements=out,
                     in_placements=(b_in, *w_pl), in_grad_placements=(b_grad, *w_grad),
                     device_mesh=mesh)(buf, *weights)


def moe_ffn(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str = "",
            plan: Optional[ShardingPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D) in the compute dtype, aux loss fp32).

    On a mesh the tokens are DTensors sharded over the dispatch groups:
    routing and the dispatch scatter run on each rank's own groups
    (``local_map``), the capacity buffer is constrained as the reference
    constrains it, ``("batch", "experts", "expert_cap", None)``, so the
    expert GEMMs run expert-parallel over ``model`` (or over ``d_ff``
    where the experts do not divide it), and the output buffer is
    gathered back to each rank's groups for the combine."""
    B, S, D = x.shape
    T = B * S
    G = _group_count(T)
    xt = constrain(plan, x.reshape(G, T // G, D), ("batch", None, None))
    router = p[f"{prefix}router"]
    weights = [p[f"{prefix}{n}"] for n in ("w_in", "w_gate", "w_out")]
    if isinstance(xt, DTensor):
        mesh = xt.device_mesh
        pl = list(xt.placements)
        rep = [Replicate()] * len(pl)
        sums = [Partial() if pp != Replicate() else Replicate() for pp in pl]
        # each rank's router gradient covers its own groups' tokens: a
        # partial sum over the batch mesh dims
        buf, gslot, gate_w, f_sum, p_sum = local_map(
            functools.partial(_dispatch, cfg), out_placements=(pl, pl, pl, sums, sums),
            in_placements=(pl, rep), in_grad_placements=(pl, sums),
            device_mesh=mesh)(xt, router.redistribute(mesh, rep))
        buf = constrain(plan, buf, ("batch", "experts", "expert_cap", None))
        out_buf = constrain(plan, _experts_on_mesh(cfg, buf, weights),
                            ("batch", "experts", "expert_cap", None))
        y = local_map(functools.partial(_combine, cfg), out_placements=pl,
                      in_placements=(pl, pl, pl), device_mesh=mesh)(
            out_buf.redistribute(mesh, pl), gslot, gate_w)
    else:
        y, f_sum, p_sum = _grouped(cfg, xt, router, *weights)
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
    return residual(plan, y.reshape(B, S, D)), aux
