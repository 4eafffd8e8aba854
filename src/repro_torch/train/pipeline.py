"""Task-based pipeline parallelism: 1F1B from dataflow ordering — ported
from the reference's ``train/pipeline.py``.

The paper's claim in miniature: express the pipeline as a dependency DAG of
stage tasks and the schedule *emerges* — no hand-written 1F1B state machine,
no global barrier.  Forward task (s, m) depends on (s−1, m); backward task
(s, m) depends on (s+1, m)'s cotangent and its own forward residuals; the
AMT scheduler (work-stealing pool) runs whatever is ready, so bubbles fill
exactly as in 1F1B the moment resources free up.

Each stage holds its own parameters (= a pipeline rank's weights); the step
returns per-stage gradients averaged over microbatches.  Here every stage
runs on the local device: all stages enqueue onto the device's current
stream from the scheduler's worker threads, which orders their kernels as
the dataflow graph orders their tasks.

Where the reference takes ``jax.vjp``, a forward task records the stage
under ``torch.enable_grad()`` on fresh leaves — the stage's params (aliases,
no copy) and its input, detached — and the backward task runs
``torch.autograd.grad`` from the stage's output with the incoming
cotangent.  Grad mode is per thread and the tasks run on worker threads, so
each task sets it itself, whatever the caller's mode is.  An integer input
(stage 0's tokens) gets no cotangent.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.core import counters as _counters
from repro_torch.core.dataflow import dataflow
from repro_torch.core.future import Future


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples) and the
    matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def mean_tree(*trees: Any) -> Any:
    """The leafwise mean of trees of one structure (dicts, lists, tuples)."""
    return _tree_map(lambda *xs: sum(xs) / len(xs), *trees)


def pipeline_value_and_grad(
    stage_fns: Sequence[Callable],  # stage_fns[s](params_s, x) -> y
    loss_fn: Callable,  # loss_fn(y_last, target_mb) -> scalar
    stage_params: Sequence[Any],
    batches: Sequence[Tuple[Any, Any]],  # [(x_mb, target_mb)] microbatches
) -> Tuple[Future, List[Future]]:
    """Futurized pipeline step.

    Returns (loss future (mean over microbatches),
             per-stage gradient futures (mean over microbatches)).
    """
    S, M = len(stage_fns), len(batches)
    c_tasks = _counters.counter("/pipeline{1f1b}/tasks/cumulative")

    # ---- forward wave: fwd[s][m] = (activation, residuals for backward) ----
    acts: List[List[Future]] = [[None] * M for _ in range(S)]
    saved: List[List[Future]] = [[None] * M for _ in range(S)]

    def fwd_task(s: int, x: Any) -> Tuple[Any, Tuple[Any, Any, Any]]:
        c_tasks.increment()
        with torch.enable_grad():
            params = _tree_map(lambda p: p.detach().requires_grad_(), stage_params[s])
            xin = x.detach()
            if xin.is_floating_point():
                xin.requires_grad_()
            y = stage_fns[s](params, xin)
        return y.detach(), (params, xin, y)

    for m, (x_mb, _) in enumerate(batches):
        carry: Any = x_mb
        for s in range(S):
            pair = (dataflow(fwd_task, s, carry) if s == 0 else
                    dataflow(lambda prev, s=s: fwd_task(s, prev[0]), carry))
            acts[s][m] = pair.then_value(lambda p: p[0])
            saved[s][m] = pair.then_value(lambda p: p[1])
            carry = pair

    # ---- loss + backward wave ---------------------------------------------
    def loss_task(y: Any, target: Any) -> Tuple[Any, Any]:
        c_tasks.increment()
        with torch.enable_grad():
            yl = y.detach().requires_grad_()
            loss = loss_fn(yl, target)
            (dy,) = torch.autograd.grad(loss, yl)
        return loss.detach(), dy

    def bwd_task(res: Tuple[Any, Any, Any], dy: Any) -> Tuple[Any, Any]:
        c_tasks.increment()
        params, xin, y = res
        leaves = _leaves(params)
        wrt = leaves + ([xin] if xin.requires_grad else [])
        gs = torch.autograd.grad(y, wrt, dy, allow_unused=True)
        gs = [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, gs)]
        dx = gs[len(leaves)] if xin.requires_grad else None
        return _unflatten_like(params, gs[:len(leaves)]), dx

    losses: List[Future] = []
    grads: List[List[Future]] = [[None] * M for _ in range(S)]
    for m, (_, tgt) in enumerate(batches):
        lt = dataflow(loss_task, acts[S - 1][m], tgt)
        losses.append(lt.then_value(lambda p: p[0]))
        ct = lt.then_value(lambda p: p[1])  # cotangent entering stage S-1
        for s in reversed(range(S)):
            bt = dataflow(bwd_task, saved[s][m], ct)
            grads[s][m] = bt.then_value(lambda p: p[0])
            ct = bt.then_value(lambda p: p[1])

    # ---- reductions (dataflow, no barrier until the caller looks) ----------
    loss_fut = dataflow(lambda *ls: sum(ls) / len(ls), *losses)
    grad_futs = [dataflow(mean_tree, *grads[s]) for s in range(S)]
    return loss_fut, grad_futs


def split_stages(layers: Sequence[Any], n_stages: int) -> List[List[Any]]:
    """Even-ish contiguous split of layer params into pipeline stages."""
    k, r = divmod(len(layers), n_stages)
    out, i = [], 0
    for s in range(n_stages):
        n = k + (1 if s < r else 0)
        out.append(list(layers[i: i + n]))
        i += n
    return out
