"""Pod-axis manual collectives — ported from the reference's
``dist/collectives.py``.

The plan's DTensor placements derive every *intra-pod* collective; the
*inter-pod* hop is the one place the step drops to manual control, since
it is the slow wire and the one worth compressing.

- :func:`pod_manual_value_and_grad` — each pod runs the backward on its
  batch shard over its own ``(data, model)`` submesh, then every
  gradient's local shard is all-reduced over the pod group as **bf16**
  (half the wire bytes of fp32), with the mean and the cast back in fp32.
- :func:`make_error_feedback` — unbiased error-feedback compression for a
  gradient stream whose quantization point the caller controls: the
  rounding residual is carried to the next step, so the *sum* of the
  compressed gradients equals the true sum.
- :func:`all_gather_tree` — explicit pod-axis all-gather of a tree.

The reference runs these as a partial-manual ``shard_map``; the port is
SPMD already, so the manual part is a ``torch.distributed`` collective on
``mesh.get_group(axis)`` over each rank's local shard.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate


def _pod_axis(mesh: Any) -> str:
    """The inter-pod mesh axis; falls back to the leading axis on meshes
    without an explicit ``pod`` dimension (single-pod test meshes)."""
    names = mesh.mesh_dim_names
    return "pod" if "pod" in names else names[0]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _split(mesh: Any, axis: str) -> Tuple[int, Any]:
    """(index of ``axis`` among the mesh dims, the submesh of the others —
    None when ``axis`` is the only one)."""
    names = list(mesh.mesh_dim_names)
    rest = tuple(n for n in names if n != axis)
    return names.index(axis), (mesh[rest] if rest else None)


def _to_sub(t: Any, mesh: Any, i: int, sub: Any) -> Any:
    """A full-mesh DTensor as the same local shard on the submesh without
    mesh dim ``i`` (a shard over that dim is gathered first); a plain
    tensor stays as it is."""
    if not isinstance(t, DTensor):
        return t
    pl = list(t.placements)
    if pl[i] != Replicate():
        pl[i] = Replicate()
        t = t.redistribute(mesh, pl)
    local = t.to_local()
    if sub is None:
        return local
    return DTensor.from_local(local, sub, pl[:i] + pl[i + 1:], run_check=False)


def _batch_to_sub(t: Any, mesh: Any, i: int, sub: Any) -> Any:
    """A batch field sharded over the pod dim (dim 0): this pod's part, as
    a DTensor on the submesh (or this rank's plain tensor)."""
    if not isinstance(t, DTensor):
        return t
    pl = list(t.placements)
    local = t.to_local()
    if sub is None:
        return local
    return DTensor.from_local(local, sub, pl[:i] + pl[i + 1:], run_check=False)


def _to_full(t: Any, mesh: Any, i: int) -> Any:
    """A submesh DTensor (or a plain tensor) back on the full mesh,
    replicated over mesh dim ``i``."""
    if isinstance(t, DTensor):
        pl = list(t.placements)
        local = t.to_local()
    else:
        pl, local = [], t
    pl.insert(i, Replicate())
    if len(pl) != mesh.ndim:  # no submesh: every other dim replicated
        pl = [Replicate()] * mesh.ndim
    return DTensor.from_local(local, mesh, pl, run_check=False)


def pod_manual_value_and_grad(loss_fn: Callable, mesh: Any,
                              compress: bool = True) -> Callable:
    """``value_and_grad(loss_fn)`` with a manual pod-axis reduction.

    Returns ``f(params, batch) -> (loss, grads)``.  ``params`` are DTensors
    on ``mesh``, replicated across pods (a shard over the pod dim is
    gathered first); ``batch`` fields are sharded over the pod dim (dim
    0).  Each pod computes its loss and gradients on its own submesh; then
    each gradient's local shard is summed over the pod group — as bf16
    when ``compress`` (the sum itself runs at wire precision: the
    bandwidth win), the mean and the cast back to the gradient's dtype in
    fp32.  The loss is the mean of the pod means (equal pod shards).  The
    per-step rounding is not error-corrected: :func:`make_error_feedback`
    is the primitive for callers that own a quantization point.  Returns
    the loss and grads as DTensors on ``mesh``, replicated over the pods.
    """
    from repro_torch.train.step import value_and_grad  # deferred: train imports dist

    axis = _pod_axis(mesh)
    i, sub = _split(mesh, axis)
    n_pods = mesh.size(i)
    group = mesh.get_group(axis)

    def reduce(t: torch.Tensor, compress: bool = compress) -> torch.Tensor:
        if compress:
            wire = t.to(torch.bfloat16)          # half-width inter-pod hop
            dist.all_reduce(wire, group=group)
            return (wire.float() / n_pods).to(t.dtype)
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t / n_pods

    def vg(params: Dict[str, Any], batch: Dict[str, Any]):
        sub_params = {k: _to_sub(v, mesh, i, sub) for k, v in params.items()}
        sub_batch = {k: _batch_to_sub(v, mesh, i, sub) for k, v in batch.items()}
        loss, grads = value_and_grad(loss_fn, sub_params, sub_batch)
        local = loss.to_local() if isinstance(loss, DTensor) else loss
        loss = _to_full(reduce(local.float(), compress=False), mesh, i)
        out = {}
        for k, g in grads.items():
            red = reduce(g.to_local() if isinstance(g, DTensor) else g)
            out[k] = _to_full(DTensor.from_local(red, g.device_mesh, g.placements,
                                                 run_check=False)
                              if isinstance(g, DTensor) else red, mesh, i)
        return loss, out

    return vg


def all_gather_tree(tree: Any, mesh: Any, axis: str | None = None,
                    tiled: bool = False) -> Any:
    """Explicit pod-axis all-gather of a tree of this rank's tensors.

    A 0-dim leaf (a per-pod scalar metric) is gathered into an
    ``(n_pods,)`` vector; a leaf with dims is stacked into ``(n_pods,
    ...)``, or concatenated along dim 0 with ``tiled``."""
    axis = axis or _pod_axis(mesh)
    group = mesh.get_group(axis)
    n = mesh.size(list(mesh.mesh_dim_names).index(axis))

    def gather(x: torch.Tensor) -> torch.Tensor:
        x = x.to_local() if isinstance(x, DTensor) else torch.as_tensor(x)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        if tiled and x.dim() > 0:
            return torch.cat(parts, dim=0)
        return torch.stack(parts)

    return _tree_map(gather, tree)


# ------------------------------------------------------- error feedback
def make_error_feedback(wire_dtype: torch.dtype = torch.bfloat16
                        ) -> Tuple[Callable, Callable]:
    """Unbiased error-feedback compression for a gradient stream.

    Returns ``(init, compress)``:

        residual = init(grads_like)            # zeros, fp32
        q, residual = compress(grads, residual)

    Each step quantizes ``grads + residual`` to ``wire_dtype`` (round to
    nearest even) and carries the rounding error forward in fp32.
    Telescoping makes the stream exact: ``Σ dequant(q_t) + residual_T ==
    Σ g_t``.  Runs on any device, on any tree of tensors.
    """

    def init(grads: Any) -> Any:
        return _tree_map(lambda g: torch.zeros(tuple(g.shape), dtype=torch.float32,
                                               device=g.device), grads)

    def compress(grads: Any, residual: Any) -> Tuple[Any, Any]:
        carried = _zip_map(lambda g, e: g.float() + e, grads, residual)
        q = _tree_map(lambda s: s.to(wire_dtype), carried)
        new_residual = _zip_map(lambda s, qq: s - qq.float(), carried, q)
        return q, new_residual

    return init, compress


def _zip_map(fn: Callable, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)
