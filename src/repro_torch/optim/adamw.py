"""AdamW — ported from the reference's ``optim/adamw.py``, with its exact
math: clip by global norm, bias corrections, and
delta = m̂/(√v̂ + eps) + wd·p applied to every param.

The reference is pure (new params, new state); the port updates params,
m and v in place under ``torch.no_grad()`` and uses the grads' storage as
its scratch, so a step at full size allocates nothing the size of a
param.  The moments are fp32, ``step`` a 0-d int32 tensor, all on the
params' device; nothing here waits for the device.  DTensor params,
grads and moments (a mesh) update shard by shard, in their own
placements: every op here has a DTensor rule, and the global norm reduces
across the shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay, in fp32 as the reference computes it."""
    step = torch.as_tensor(step).float()
    warm = (step / max(cfg.warmup_steps, 1)).clamp_max(1.0)
    prog = ((step - cfg.warmup_steps) /
            max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params: Params) -> Dict[str, Any]:
    """Zero fp32 moments beside each param and ``step`` 0."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_state(param_specs, device="meta") -> Dict[str, Any]:
    """Stand-ins matching :func:`init` for the dry run (meta tensors, or
    fake ones under ``FakeTensorMode``)."""
    def moments():
        return {p: torch.empty(s.shape, dtype=torch.float32, device=device)
                for p, s in param_specs.items()}

    return {"m": moments(), "v": moments(),
            "step": torch.empty((), dtype=torch.int32, device=device)}


def state_axes(param_specs) -> Dict[str, Any]:
    """Logical axes for the optimizer state (the params'; ZeRO)."""
    ax = {p: s.axes for p, s in param_specs.items()}
    return {"m": ax, "v": dict(ax), "step": ()}


def _norm(x: torch.Tensor) -> torch.Tensor:
    """‖x‖₂ in fp32, reduced one dim at a time, the last first: no
    temporary the size of ``x``, and no fp32 sum longer than ``x``'s
    largest dim (a flat fp32 norm of 10⁸ elements drifts by ~1 % on the
    CPU)."""
    n = x.float()
    for _ in range(max(x.dim(), 1)):
        n = torch.linalg.vector_norm(n, dim=-1)
    return n


def global_norm(tree: Iterable[torch.Tensor]) -> torch.Tensor:
    """√(Σ‖x‖²) over the tensors, in fp32: the norm of the per-tensor
    norms."""
    return torch.linalg.vector_norm(torch.stack([_norm(x) for x in tree]))


@torch.no_grad()
def update(cfg: AdamWConfig, params: Params, grads: Params, state: Dict[str, Any]
           ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  ``grads`` must be fp32 tensors the caller
    gives up: they are the scratch of the step.  Returns (params, state,
    {"grad_norm", "lr"}), the same dicts updated."""
    step = state["step"] + 1
    gnorm = global_norm(grads.values())
    scale = ((cfg.grad_clip / gnorm.clamp_min(1e-9)).clamp_max(1.0)
             if cfg.grad_clip > 0 else None)
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    for k, p in params.items():
        g, m, v = grads[k], state["m"][k], state["v"][k]
        if scale is not None:
            g.mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        # g := m̂ / (√v̂ + eps) + wd·p (m / b1c divided last: the same two
        # roundings in another order, and no temporary), then p -= lr·g
        torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
        torch.div(m, g, out=g).div_(b1c)
        g.add_(p, alpha=cfg.weight_decay)
        p.sub_(g.mul_(lr))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
