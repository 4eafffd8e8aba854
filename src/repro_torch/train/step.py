"""Train/serve step builders — ported from the reference's
``train/step.py``.

The plan shapes a step through its remat policy and bf16 boundaries
(inside ``Model.loss``), its ``microbatches`` (gradient accumulation
here) and, on a mesh with a ``pod`` axis, ``compress_pod_grads``: the
pod-manual branch, whose gradients cross pods as bf16
(:func:`repro_torch.dist.collectives.pod_manual_value_and_grad`).

On a mesh (``make_train_step(model, opt_cfg, mesh)``) params and
optimizer state are DTensors placed by :func:`train_state_shardings`, and
every rank hands the step the same global batch: each field becomes a
DTensor by :func:`batch_shardings`, each rank keeping its own rows.
Gradients come back in their params' placements, so the AdamW update runs
on each rank's shards.

The reference donates ``(params, opt_state)`` to its jitted step; the
port's step updates them in place (``adamw.update``) and returns the same
dicts.  A step enqueues its work and returns device tensors: nothing in
it waits for the device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.dist.collectives import pod_manual_value_and_grad
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model
from repro_torch.optim import adamw

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


def make_loss_fn(model: Model) -> Callable:
    def loss_fn(params, batch):
        return model.loss(params, batch)

    return loss_fn


def value_and_grad(loss_fn: Callable, params: Params, batch: Batch
                   ) -> Tuple[torch.Tensor, Params]:
    """(loss, fp32 grads) of ``loss_fn(params, batch)`` wrt every param:
    the reference's ``jax.value_and_grad``.  The params are read through
    detached aliases, so the caller's tensors need no ``requires_grad``;
    a DTensor param stays a DTensor, and its gradient comes back in the
    param's own placements (a partial sum is reduced)."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    # the backward too mixes DTensors with the plain tensors the forward
    # saved (RoPE tables, masks), taken as replicated
    mesh = any(isinstance(p, DTensor) for p in params.values())
    with torch.enable_grad(), mesh_mod.replicating() if mesh else contextlib.nullcontext():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: _placed(g, leaves[k]).float()
                           for k, g in zip(leaves, grads)}


def _placed(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if isinstance(g, DTensor) and list(g.placements) != list(like.placements):
        return g.redistribute(like.device_mesh, like.placements)
    return g


def _microbatch_grads(loss_fn: Callable, params: Params, batch: Batch, n_mb: int
                      ) -> Tuple[torch.Tensor, Params]:
    """Gradient accumulation over ``n_mb`` microbatches: dim 0 of every
    batch field is split into ``n_mb`` chunks (it must divide), each
    chunk's fp32 grads are summed, and the loss and grads averaged."""
    n = next(iter(batch.values())).shape[0]
    if n % n_mb:
        raise ValueError(f"batch of {n} does not split into {n_mb} microbatches")
    mbs = [dict(zip(batch, parts)) for parts in
           zip(*(_chunks(v, n_mb) for v in batch.values()))]
    loss_sum, acc = value_and_grad(loss_fn, params, mbs[0])
    for mb in mbs[1:]:
        loss, grads = value_and_grad(loss_fn, params, mb)
        loss_sum = loss_sum + loss
        for k, g in grads.items():
            acc[k].add_(g)
        del grads
    inv = 1.0 / n_mb
    for g in acc.values():
        g.mul_(inv)
    return loss_sum * inv, acc


def check_mesh(model: Model, mesh: Any) -> None:
    """A mesh must live on the model's device type: no CPU mesh under a
    CUDA model, nor the reverse."""
    if mesh is not None and mesh.device_type != model.device.type:
        raise ValueError(f"a {mesh.device_type} mesh under a model on "
                         f"{model.device}")


def takes_pod_manual(model: Model, mesh: Any) -> bool:
    """The reference's branch rule: the plan compresses pod gradients and
    the mesh has a ``pod`` axis."""
    return (model.plan.compress_pod_grads and mesh is not None
            and "pod" in mesh.mesh_dim_names)


def _chunks(v: torch.Tensor, n: int):
    """``n`` equal chunks of dim 0.  A batch-sharded DTensor is chunked on
    each rank's rows (its microbatch i is rows i of every rank's shard):
    the same microbatches up to the order of their rows, which neither the
    loss nor the gradients see."""
    if isinstance(v, DTensor):
        mesh, pl = v.device_mesh, v.placements
        return [DTensor.from_local(c, mesh, pl, run_check=False)
                for c in v.to_local().chunk(n, dim=0)]
    return v.chunk(n, dim=0)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    mesh: Any = None) -> Callable:
    """Returns ``step(params, opt_state, batch) → (params, opt_state,
    metrics)``; the batch's tensors are moved to the model's device, and
    on ``mesh`` placed by :func:`batch_shardings` (every rank passes the
    same global batch).  The pod-manual branch runs exactly when
    :func:`takes_pod_manual`."""
    check_mesh(model, mesh)
    plan = model.plan
    loss_fn = make_loss_fn(model)
    pod_vg = (pod_manual_value_and_grad(loss_fn, mesh) if takes_pod_manual(model, mesh)
              else None)

    def step(params: Params, opt_state: Dict[str, Any], batch: Batch):
        batch = {k: v.to(model.device, non_blocking=True) for k, v in batch.items()}
        if mesh is not None:
            batch = place_batch(model, mesh, batch)
        if pod_vg is not None:
            loss, grads = pod_vg(params, batch)
        elif plan.microbatches > 1:
            loss, grads = _microbatch_grads(loss_fn, params, batch, plan.microbatches)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, om = adamw.update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return step


def _inference(params: Params):
    """``torch.inference_mode()``, or ``torch.no_grad()`` on a mesh: DTensor
    views of tensors made outside inference mode cannot be taken inside
    it."""
    if any(isinstance(v, DTensor) for v in params.values()):
        return torch.no_grad()
    return torch.inference_mode()


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, inputs):
        with _inference(params):
            return model.prefill(params, inputs)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """Greedy one-token decode (the ``serve_step`` of the decode cells)."""

    def decode_step(params, cache, token):
        with _inference(params):
            logits, new_cache = model.decode(params, cache, token)
            # the vocab gathered on a mesh: each rank takes its own rows' argmax
            logits = model.plan.constrain(logits, ("batch", None))
            next_token = logits.argmax(dim=-1).to(torch.int32)[:, None]
        return next_token, new_cache

    return decode_step


# ---------------------------------------------------------------- shardings
def train_state_shardings(model: Model, mesh: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(param placements, optimizer-state placements) on ``mesh``: the
    plan's placements of each param, its moments the same, ``step``
    replicated."""
    plan = model.plan
    specs = model.param_specs()
    p_sh = plan.param_shardings(specs, mesh)
    ax = adamw.state_axes(specs)
    o_sh = {
        "m": {k: plan.sharding(ax["m"][k], specs[k].shape, mesh) for k in specs},
        "v": {k: plan.sharding(ax["v"][k], specs[k].shape, mesh) for k in specs},
        "step": plan.replicated(mesh),
    }
    return p_sh, o_sh


def batch_shardings(model: Model, mesh: Any, batch_specs: Dict[str, Any]) -> Dict[str, Any]:
    """Placements of each batch field (anything with a ``shape``): the
    model's batch axes, or the batch dim then replicated."""
    plan = model.plan
    axes = model.batch_axes()
    return {k: plan.sharding(axes.get(k, ("batch",) + (None,) * (len(s.shape) - 1)),
                             s.shape, mesh)
            for k, s in batch_specs.items()}


def cache_shardings(model: Model, mesh: Any, cache_specs: Dict[str, Any]) -> Dict[str, Any]:
    """Placements of each decode-cache field on ``mesh``."""
    plan = model.plan
    axes = model.cache_axes()
    return {k: plan.sharding(axes[k], s.shape, mesh) if s.shape else plan.replicated(mesh)
            for k, s in cache_specs.items()}


def place_batch(model: Model, mesh: Any, batch: Batch,
                shardings: Optional[Dict[str, Any]] = None) -> Dict[str, DTensor]:
    """Each field of the global ``batch`` (the same on every rank) as a
    DTensor on ``mesh``: each rank keeps its own rows, nothing moves."""
    sh = shardings if shardings is not None else batch_shardings(model, mesh, batch)
    return {k: v if isinstance(v, DTensor)
            else distribute_tensor(v, mesh, sh[k], src_data_rank=None)
            for k, v in batch.items()}
