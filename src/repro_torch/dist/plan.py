"""Sharding plans: logical-axis → mesh-axis resolution — ported from the
reference's ``dist/plan.py``.

A :class:`ShardingPlan` is the whole distribution strategy of a step: which
mesh axis every logical tensor axis lands on, where the gather point sits
(bulk/BSP vs per-layer/futurized), the remat policy and the collective
dtype boundaries.  Models never name mesh axes: they constrain activations
and declare parameters by **logical** axes (``embed``, ``mlp``, ``kv_seq``,
…, see ``models/params.py``) and the plan resolves them against a mesh.

The reference resolves against a single-controller ``jax.sharding`` mesh;
the port resolves against a torch ``DeviceMesh`` (one per process, SPMD),
or against a plain ``{axis: size}`` mapping, the counterpart of the
reference's ``AbstractMesh``.  Resolution rules, as in the reference:

- **FCFS mesh-axis allocation** — axes are resolved left-to-right and each
  mesh axis is used at most once per spec; a logical axis whose mesh axis
  was already consumed replicates instead.
- **divisibility guard** — a dim that the assigned mesh axes do not divide
  falls back toward replication (axes are dropped right-to-left until the
  product divides).  DTensor would accept an uneven shard; the guard stays
  so that every spec equals the reference's.
- **trailing-``None`` trimming** — specs drop trailing replicated entries.

A spec is a tuple with one entry per tensor dim (a mesh-axis name, a tuple
of names, or ``None``); :func:`placements` turns it into DTensor
placements, one per *mesh* dim: a joint entry ``("pod", "data")`` on dim
``d`` becomes ``Shard(d)`` on both mesh dims, pod-major as in JAX.

``constrain`` redistributes a DTensor to its resolved placements and is
the identity on a plain tensor, as the reference's is with no mesh.  On
one device only the plan's flags that change the math of a step act:
``remat_policy`` (``Lx.remat_wrap``), ``bf16_boundaries``
(``Lx.bf16_cotangent``), ``microbatches`` and ``compress_pod_grads``
(``train/step.py``).

The registry (``get_plan``) holds the four plans:

    bsp        gather-upfront, full remat, no FSDP
    futurized  FSDP with per-layer gathers, no remat
    optimized  futurized + KV/seq sharding + bf16 boundaries + dots remat
    serve      TP-only inference plan, sequence-sharded KV cache
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

# A rule value: mesh-axis name, preference-ordered tuple of mesh axes (the
# dim is sharded over every present one jointly), or None (replicate).
Rule = Union[str, Tuple[str, ...], None]
# A resolved spec: one entry per tensor dim, trailing Nones trimmed.
Spec = Tuple[Union[str, Tuple[str, ...], None], ...]


def _active_mesh() -> Optional[Any]:
    """The mesh of the innermost ``launch.mesh.use(...)`` block, or None."""
    from repro_torch.launch import mesh as _mesh  # deferred: launch imports dist

    return _mesh.active()


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} for a ``DeviceMesh`` or a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names cannot resolve "
                         "logical axes")
    return dict(zip(names, (int(n) for n in mesh.shape)))


def placements(spec: Sequence[Any], mesh: Any) -> List[Any]:
    """DTensor placements (one per mesh dim) for a resolved ``spec`` (one
    entry per tensor dim).  A joint entry shards its dim over each named
    mesh dim, in mesh order (the first named is the major one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(ax)] = Shard(d)
    return out


def spec_of(placements_: Sequence[Any], mesh: Any, ndim: int) -> Spec:
    """The spec that :func:`placements` turns into ``placements_`` (the
    round trip): each tensor dim lists the mesh dims that shard it, in mesh
    order.  ``Replicate`` and ``Partial`` leave a dim unnamed."""
    from torch.distributed.tensor import Shard

    names = list(mesh_sizes(mesh))
    entries: List[Any] = []
    for d in range(ndim):
        axes = tuple(n for n, p in zip(names, placements_)
                     if isinstance(p, Shard) and p.dim == d)
        entries.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


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

    # ------------------------------------------------------------- resolve
    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh: Any) -> Spec:
        """Resolve logical ``axes`` for a tensor of ``shape`` on ``mesh``
        (a ``DeviceMesh`` or an ``{axis: size}`` mapping): FCFS over mesh
        axes, divisibility-guarded, trailing-None trimmed."""
        assert len(axes) == len(shape), (axes, shape)
        sizes = mesh_sizes(mesh)
        used: set = set()
        entries: list = []
        for ax, dim in zip(axes, shape):
            assigned: list = []
            for cand in self._candidates(ax):
                if cand in sizes and cand not in used and cand not in assigned:
                    assigned.append(cand)
            # divisibility guard: drop axes (least-preferred first) until
            # the joint degree divides the dim; empty ⇒ replicate
            while assigned and dim % math.prod(sizes[a] for a in assigned):
                assigned.pop()
            if assigned:
                used.update(assigned)
                entries.append(assigned[0] if len(assigned) == 1
                               else tuple(assigned))
            else:
                entries.append(None)
        while entries and entries[-1] is None:  # canonical trailing trim
            entries.pop()
        return tuple(entries)

    def _candidates(self, ax: Optional[str]) -> Tuple[str, ...]:
        if ax is None:
            return ()
        rule = self.rules.get(ax)
        if rule is None:
            return ()
        if isinstance(rule, str):
            return (rule,)
        return tuple(rule)

    # ----------------------------------------------------------- shardings
    def sharding(self, axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh: Any) -> List[Any]:
        """DTensor placements of a tensor of logical ``axes`` on ``mesh``."""
        return placements(self.spec(axes, shape, mesh), mesh)

    def replicated(self, mesh: Any) -> List[Any]:
        return placements((), mesh)

    def param_shardings(self, specs: Mapping[str, Any], mesh: Any
                        ) -> Dict[str, List[Any]]:
        """Placements for a ``{path: ParamSpec}`` dict (one source of
        truth: the spec's logical axes)."""
        return {p: self.sharding(s.axes, s.shape, mesh) for p, s in specs.items()}

    def sharding_for(self, leaf: Any, mesh: Optional[Any] = None) -> Spec:
        """Spec for a path-free leaf (elastic migration of opaque trees,
        ``core/migration.py``): batch-shard dim 0 over the data axes when
        divisible, otherwise replicate.  Pass the TARGET mesh explicitly
        when migrating: the divisibility guard must see its axis sizes."""
        mesh = mesh if mesh is not None else _active_mesh()
        shape = tuple(getattr(leaf, "shape", ()))
        if mesh is None or not shape:
            return ()
        return self.spec(("batch",) + (None,) * (len(shape) - 1), shape, mesh)

    # ----------------------------------------------------------- constrain
    def constrain(self, x: Any, axes: Sequence[Optional[str]]) -> Any:
        """Redistribute a DTensor to the placements ``axes`` resolve to on
        its own mesh (differentiable); the identity on a plain tensor."""
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        want = self.sharding(axes, x.shape, x.device_mesh)
        if list(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


def _tp_rules(**overrides: Rule) -> Dict[str, Rule]:
    """The shared tensor-parallel core every plan builds on."""
    rules: Dict[str, Rule] = {
        # -------- parameters (logical axes from models/params.py)
        "embed": "data",          # FSDP axis (overridden off for bsp/serve)
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",       # EP rides the model axis
        "ssm_inner": "model",
        "lru": "model",
        # "layers" is never sharded: absent ⇒ replicate
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
