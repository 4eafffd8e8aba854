"""Training through the port's normal entry, ``Trainer.fit``, with the
batches handed in through its ``prefetcher`` argument.

Set-up builds one trainer (model, fp32 masters, AdamW state), writes the
benchmark's weights from the seed into its parameters, and drives it
through the mix's first ``checked_steps`` steps by ``fit`` itself, on the
generator's rows (all different): their losses, the first gradient's
norm per leaf (read from AdamW's first moment after one step: m₁ =
(1 − β₁)·g) and each leaf's change over the steps are kept.  The same
trainer then steps for the window (each step ends in the loss's read to
the host): ``train_tokens_per_s`` is the tokens of the steps completed
over the time they took.

Once the window has closed, the peak memory is read and the trainer
freed, and the plain fp32 reference runs the same steps from the same
weights and rows: each step's loss, each leaf's first-gradient norm and
change norm are held against it, by the worst leaf, as a share of the
reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's (a key bias under softmax) are left out of the change,
since AdamW moves them by round-off alone.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Dict, List, Tuple

ENV: Dict[str, str] = {
    # the program's training launcher sets it: the allocator's split
    # segments cannot place a full step's gradients otherwise
    "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
}


class _Feeder:
    """The trainer's ``prefetcher``: step i's batch from the generator."""

    def __init__(self, gen, mix, seed, vocab):
        self.gen, self.mix, self.seed, self.vocab = gen, mix, seed, vocab

    def get(self, step: int):
        from repro_torch.core.future import make_ready_future

        return make_ready_future(self.gen.batch(self.mix, self.seed, step, self.vocab))


def gap_by_leaf(prog: Dict[str, float], gold: Dict[str, float], keep=None) -> float:
    """The worst leaf's |prog − gold| over max(gold, the median leaf's
    gold)."""
    names = [n for n in gold if keep is None or n in keep]
    med = statistics.median(gold[n] for n in names)
    return max(abs(prog[n] - gold[n]) / max(gold[n], med, 1e-30) for n in names)


def compare(prog: Dict, gold: Dict) -> Dict[str, float]:
    """The three compared numbers of a training cell."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], gold["losses"]))
    grads = gap_by_leaf(prog["grad_norms"], gold["grad_norms"])
    med = statistics.median(gold["grad_norms"].values())
    moved = {n for n, g in gold["grad_norms"].items() if g >= 1e-3 * med}
    change = gap_by_leaf(prog["change_norms"], gold["change_norms"], moved)
    return {"loss_gap": loss, "grad_norm_gap": grads, "change_norm_gap": change,
            "left_out": sorted(set(gold["grad_norms"]) - moved)}


class Session:
    """One trainer for one seed, driven through the mix's checked steps
    (set-up); ``prog`` holds what the check compares."""

    def __init__(self, ctx, seed: int, fault=None):
        import torch

        import repro_torch.core as core
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.dist.plan import get_plan
        from repro_torch.models.model import Model
        from repro_torch.optim import adamw
        from repro_torch.train.trainer import TrainConfig, Trainer

        from perfbench import harness, weights

        self.ctx, self.seed, mix = ctx, seed, ctx.mix
        self.on_card = ctx.device == "cuda"
        cfg = harness.port_config(ctx.config)
        self.vocab = ctx.shape["vocab_size"]
        rows, seq, n_mb = mix["rows_per_step"], mix["seq_len"], mix["microbatches"]
        if seq > ctx.shape.get("max_position", seq):
            raise ValueError(f"sequences of {seq} exceed the configuration's positions")
        self.opt = opt = dict(mix["optimizer"])
        core.init(pools={"default": 2, "io": 1})
        model = Model(cfg, device=ctx.device, plan=get_plan(mix["plan"], microbatches=n_mb))
        self.layout = weights.layout_of(model.param_specs())
        tr = Trainer(model, adamw.AdamWConfig(**opt), DataConfig(batch_size=rows, seq_len=seq),
                     TrainConfig(steps=1, log_every=1), rng_seed=seed % (2 ** 31),
                     device=ctx.device, prefetcher=_Feeder(ctx.gen, mix, seed, self.vocab))
        with torch.no_grad():
            for name, p in tr.params.items():
                p.copy_(self.leaf(name))
        if fault is not None:
            fault(tr)
        self.prog = {"losses": []}
        for i in range(mix["checked_steps"]):
            self.prog["losses"] += [h["loss"] for h in tr.fit(1)]
            if i == 0:
                self.prog["grad_norms"] = {
                    n: torch.linalg.vector_norm(m).item() / (1 - opt["b1"])
                    for n, m in tr.opt_state["m"].items()}
        with torch.no_grad():
            self.prog["change_norms"] = {n: torch.linalg.vector_norm(p - self.leaf(n)).item()
                                         for n, p in tr.params.items()}
        if self.on_card:
            torch.cuda.synchronize()
        self.trainer, self.model = tr, model

    def leaf(self, name: str):
        import torch

        from perfbench import weights

        return weights.make_one(name, *self.layout[name], self.seed, self.ctx.device,
                                torch.float32)

    def close(self) -> None:
        import torch

        import repro_torch.core as core

        self.trainer.close()
        self.trainer = self.model = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()
        core.finalize()

    def reference(self, fp8: bool = False, half: bool = False) -> Dict:
        """The plain reference's readings over the checked steps from the
        same weights and rows; ``half`` leaves out the second half of
        each step's rows (a fault the check has to catch)."""
        from perfbench.reference import train as ref_train

        mix = self.ctx.mix
        batches = [self.ctx.gen.batch(mix, self.seed, i, self.vocab)["tokens"].to(self.ctx.device)
                   for i in range(mix["checked_steps"])]
        n_mb = mix["microbatches"]
        if half:
            batches = [b[: b.shape[0] // 2] for b in batches]
            n_mb //= 2
        return ref_train.steps(self.ctx.shape, self.ctx.shape, self.opt, self.leaf,
                               sorted(self.layout), batches, n_mb, fp8=fp8)


def judge(ctx, cmp: Dict[str, float]) -> Tuple[List[Tuple[str, float, float]], bool]:
    """(each number of ``compare`` that the cell's file names, with its
    limit; correct)."""
    checks = [(k, cmp[k], lim) for k, lim in ctx.params["limits"].items()]
    return checks, bool(checks) and all(v <= lm for _, v, lm in checks)


def run(ctx):
    import torch

    from perfbench import harness
    from perfbench import profiling as prof_mod

    mix = ctx.mix
    rows, seq = mix["rows_per_step"], mix["seq_len"]
    ses = Session(ctx, ctx.seed, ctx.fault)
    if ctx.trace and ses.on_card:
        prof_mod.warm(torch)

    # ------------------------------------------------------------ window
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    steps = 0
    while time.perf_counter() - t0 < ctx.seconds:
        ses.trainer.fit(1)  # ends in the loss's read to the host
        steps += 1
    elapsed = time.perf_counter() - t0
    metrics = {"train_tokens_per_s": steps * rows * seq / elapsed, "setup_s": setup_s}
    print(f"window: {steps} steps of {rows * seq} tokens in {elapsed:.4f} s", file=sys.stderr)
    record = None
    if ctx.trace:
        record = harness.Record(shape=ctx.shape, peaks={}, window=(t0, t0 + elapsed),
                                steps=steps, rows=rows, seq=seq,
                                microbatches=mix["microbatches"])
        if ses.on_card:  # one step more, profiled
            profiler = prof_mod.Profiler()
            profiler.start()
            ses.trainer.fit(1)
            profiler.stop()
            record.profile = profiler.result
    memory_peak = torch.cuda.max_memory_allocated() if ses.on_card else 0
    ses.close()

    t_ref = time.perf_counter()
    gold = ses.reference()
    print(f"reference: {mix['checked_steps']} steps, {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    cmp = compare(ses.prog, gold)
    checks, correct = judge(ctx, cmp)
    notes = [f"left out of the change: {cmp['left_out']}",
             f"losses {ses.prog['losses']} reference {gold['losses']}",
             f"loss_gap {cmp['loss_gap']!r} (not compared: PERF.md)"]
    return harness.Outcome(metrics=metrics, attempted=steps, failed=0, correct=correct,
                           checks=checks, memory_peak_bytes=memory_peak, record=record,
                           notes=notes)
