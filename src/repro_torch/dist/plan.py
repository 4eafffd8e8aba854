"""Sharding plans, single-device part — ported from the reference's
``dist/plan.py`` (its ``ShardingPlan`` fields and the plan registry).

A :class:`ShardingPlan` is the whole distribution strategy of a step: the
logical-axis rules, where the gather point sits (bulk/BSP vs per-layer/
futurized), the remat policy and the collective dtype boundaries.  On one
device only the flags that change the math of a step act:

- ``remat_policy`` — what the backward recomputes (``Lx.remat_wrap``);
- ``bf16_boundaries`` — bf16 cotangents at attention's q/k/v
  (``Lx.bf16_cotangent``);
- ``microbatches`` — gradient accumulation chunks (``train/step.py``).

``rules``, ``fsdp``, ``gather_upfront`` and ``compress_pod_grads`` are
kept with the reference's values so a plan reads the same in both
packages; nothing here resolves them.  Spec resolution, shardings and the
mesh wait for device-plane distribution: :meth:`ShardingPlan.constrain` is
the identity, as the reference's is without a mesh.

The registry (``get_plan``) holds the four plans:

    bsp        gather-upfront, full remat, no FSDP
    futurized  FSDP with per-layer gathers, no remat
    optimized  futurized + KV/seq sharding + bf16 boundaries + dots remat
    serve      TP-only inference plan, sequence-sharded KV cache
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple, Union

# A rule value: mesh-axis name, preference-ordered tuple of mesh axes, or
# None (replicate) — the reference's ``Rule``.
Rule = Union[str, Tuple[str, ...], None]


@dataclass(frozen=True)
class ShardingPlan:
    """A named distribution strategy; immutable (ablate with
    ``dataclasses.replace``)."""

    name: str
    rules: Dict[str, Rule] = field(default_factory=dict)
    fsdp: bool = True                  # params sharded over the data axis
    gather_upfront: bool = False       # BSP: bulk all-gather before the loop
    remat_policy: str = "none"         # none | dots | full
    bf16_boundaries: bool = False      # bf16 cotangents at collective edges
    compress_pod_grads: bool = False   # pod-axis bf16 gradient reduction
    microbatches: int = 1              # grad-accumulation chunks

    def constrain(self, x: Any, axes: Sequence[Optional[str]]) -> Any:
        """The identity: one device has no mesh to constrain against."""
        return x


def _tp_rules(**overrides: Rule) -> Dict[str, Rule]:
    """The shared tensor-parallel core every plan builds on (the
    reference's rules, kept for the mesh slice)."""
    rules: Dict[str, Rule] = {
        # -------- parameters (logical axes from models/params.py)
        "embed": "data",          # FSDP axis (overridden off for bsp/serve)
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "ssm_inner": "model",
        "lru": "model",
        # -------- activations
        "batch": ("pod", "data"),
        "seq": None,
        "seq_sp": None,
        "kv_seq": None,
        "expert_cap": None,
    }
    rules.update(overrides)
    return rules


def bsp_plan(**overrides: Any) -> ShardingPlan:
    """The paper's baseline: params gathered up-front, full remat."""
    return replace(ShardingPlan(
        name="bsp",
        rules=_tp_rules(embed=None),
        fsdp=False,
        gather_upfront=True,
        remat_policy="full",
    ), **overrides)


def futurized_plan(**overrides: Any) -> ShardingPlan:
    """The AMT analogue: FSDP, per-layer gathers, no remat."""
    return replace(ShardingPlan(
        name="futurized",
        rules=_tp_rules(),
        fsdp=True,
        gather_upfront=False,
        remat_policy="none",
    ), **overrides)


def optimized_plan(**overrides: Any) -> ShardingPlan:
    """Futurized + KV/sequence sharding, bf16 collective boundaries and
    selective remat."""
    return replace(ShardingPlan(
        name="optimized",
        rules=_tp_rules(kv_seq="model", seq_sp="model"),
        fsdp=True,
        gather_upfront=False,
        remat_policy="dots",
        bf16_boundaries=True,
        compress_pod_grads=False,
    ), **overrides)


def serve_plan(**overrides: Any) -> ShardingPlan:
    """Inference: TP-only, sequence-sharded KV cache."""
    return replace(ShardingPlan(
        name="serve",
        rules=_tp_rules(embed=None, kv_seq="model"),
        fsdp=False,
        gather_upfront=True,
        remat_policy="none",
    ), **overrides)


_REGISTRY = {
    "bsp": bsp_plan,
    "futurized": futurized_plan,
    "optimized": optimized_plan,
    "serve": serve_plan,
}


def get_plan(name: str, **overrides: Any) -> ShardingPlan:
    """Look up a plan by name; keyword overrides are applied with
    ``dataclasses.replace`` (e.g. ``get_plan("futurized",
    microbatches=4)``).  Raises ``KeyError`` for unknown names."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown plan {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)
