"""Training steps of the dense decoder in fp32: next-token cross-entropy
over each microbatch, the gradients averaged over the microbatches,
then AdamW (Loshchilov & Hutter) with the gradients clipped by their
global norm, bias corrections and decoupled weight decay, under a linear
warm-up and a cosine decay to ``min_lr_ratio`` of the rate.  Each layer
is recomputed in the backward (checkpointed), so that three fp32 steps
of a 3-billion-parameter model fit one card beside their optimizer
state; that changes no number."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import transformer as T


def _layer_fn(shape: Dict, ref: Dict, moe_layer: bool, fp8: bool) -> Callable:
    def fn(x, *ws, names):
        return T.block(shape, ref, dict(zip(names, ws)), x, moe_layer, fp8)
    return fn


def loss(shape: Dict, ref: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         fp8: bool = False) -> torch.Tensor:
    """Mean next-token NLL of tokens (B, S+1): positions 0..S−1 predict
    1..S, each sequence apart."""
    total = 0.0
    for row in tokens:
        x = params["tok_embed"][row[:-1].long()]
        for prefix, L, moe_layer in T.stacks(shape):
            names = sorted(k[len(prefix):] for k in params if k.startswith(prefix))
            fn = _layer_fn(shape, ref, moe_layer, fp8)
            for i in range(L):
                ws = [params[prefix + n][i] for n in names]
                x = checkpoint(fn, x, *ws, names=names, use_reentrant=False)
        h = T.norm(shape, ref, x, params["final_ln"])
        logits = T.mm(h, params["lm_head"], fp8)[:, : shape["vocab_size"]]
        total = total + F.cross_entropy(logits, row[1:].long(), reduction="sum")
    return total / (tokens.shape[0] * (tokens.shape[1] - 1))


def lr_at(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


def steps(shape: Dict, ref: Dict, opt: Dict, make_leaf: Callable[[str], torch.Tensor],
          names: Sequence[str], batches: Sequence[torch.Tensor], microbatches: int,
          fp8: bool = False) -> Dict:
    """``len(batches)`` training steps from the leaves ``make_leaf(name)``
    makes.  → {"losses": [each step's loss], "grad_norms": {leaf: norm of
    its clipped gradient at the first step}, "change_norms": {leaf: norm
    of its change over the steps}}."""
    T.fp32_matmuls()
    params = {n: make_leaf(n).float().requires_grad_() for n in names}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for t, batch in enumerate(batches, start=1):
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        step_loss = 0.0
        for mb in batch.chunk(microbatches, dim=0):
            lo = loss(shape, ref, params, mb, fp8)
            gs = torch.autograd.grad(lo, list(params.values()))
            for n, g in zip(params, gs):
                grads[n].add_(g, alpha=1.0 / microbatches)
            step_loss += lo.item() / microbatches
            del gs, lo
        losses.append(step_loss)
        with torch.no_grad():
            gnorm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()])).item()
            clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9)) if opt["grad_clip"] > 0 else 1.0
            lr = lr_at(opt, t)
            for n, p in params.items():
                g = grads[n].mul_(clip)
                if t == 1:
                    grad_norms[n] = torch.linalg.vector_norm(g).item()
                m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                mhat = m[n] / (1 - opt["b1"] ** t)
                vhat = v[n] / (1 - opt["b2"] ** t)
                p.sub_(lr * (mhat / (vhat.sqrt() + opt["eps"]) + opt["weight_decay"] * p))
        del grads
    del m, v
    with torch.no_grad():
        change = {n: torch.linalg.vector_norm(p - make_leaf(n).float()).item()
                  for n, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
