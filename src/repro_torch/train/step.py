"""Train/serve step builders — ported from the reference's
``train/step.py``.

On one device the plan shapes a step through its remat policy and bf16
boundaries (inside ``Model.loss``) and its ``microbatches`` (gradient
accumulation here).  The reference's pod-manual branch (bf16-compressed
pod-axis gradients) needs a mesh and waits for device-plane distribution;
so do the sharding helpers.

The reference donates ``(params, opt_state)`` to its jitted step; the
port's step updates them in place (``adamw.update``) and returns the same
dicts.  A step enqueues its work and returns device tensors: nothing in
it waits for the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

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
    detached aliases, so the caller's tensors need no ``requires_grad``."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: g.float() for k, g in zip(leaves, grads)}


def _microbatch_grads(loss_fn: Callable, params: Params, batch: Batch, n_mb: int
                      ) -> Tuple[torch.Tensor, Params]:
    """Gradient accumulation over ``n_mb`` microbatches: dim 0 of every
    batch field is split into ``n_mb`` chunks (it must divide), each
    chunk's fp32 grads are summed, and the loss and grads averaged."""
    n = next(iter(batch.values())).shape[0]
    if n % n_mb:
        raise ValueError(f"batch of {n} does not split into {n_mb} microbatches")
    mbs = [dict(zip(batch, parts)) for parts in
           zip(*(v.chunk(n_mb, dim=0) for v in batch.values()))]
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


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    mesh: Any = None) -> Callable:
    """Returns ``step(params, opt_state, batch) → (params, opt_state,
    metrics)``; the batch's tensors are moved to the model's device.
    ``mesh`` (the reference's pod-manual path) raises: no mesh yet."""
    if mesh is not None:
        raise NotImplementedError(
            "pod-manual compressed gradients need a device mesh, which waits "
            "for device-plane distribution")
    plan = model.plan
    loss_fn = make_loss_fn(model)

    def step(params: Params, opt_state: Dict[str, Any], batch: Batch):
        batch = {k: v.to(model.device, non_blocking=True) for k, v in batch.items()}
        if plan.microbatches > 1:
            loss, grads = _microbatch_grads(loss_fn, params, batch, plan.microbatches)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, om = adamw.update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return step


def make_prefill_step(model: Model) -> Callable:
    @torch.inference_mode()
    def prefill_step(params, inputs):
        return model.prefill(params, inputs)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """Greedy one-token decode (the ``serve_step`` of the decode cells)."""

    @torch.inference_mode()
    def decode_step(params, cache, token):
        logits, new_cache = model.decode(params, cache, token)
        next_token = logits.argmax(dim=-1).to(torch.int32)[:, None]
        return next_token, new_cache

    return decode_step
