"""Futurized training loop (the end-to-end AMT loop) — ported from the
reference's ``train/trainer.py``.

- batches are built by scheduler tasks ``prefetch`` steps ahead
  (``data.Prefetcher`` futures, or any ``get(step) -> Future[batch]``
  source given as ``prefetcher=`` — notably ``data.LocalShardFeeder``,
  which feeds from the segments of a sharded dataset this locality owns);
- the step is enqueued on the device without waiting for it (PyTorch
  returns before the device finishes), so the host starts the next
  iteration at once;
- checkpoints are snapshotted to the host and written by a scheduler task
  (``checkpoint.save_async``) while the device keeps training;
- the loop waits for the device only to read metrics, every ``log_every``
  steps.

The train state is AGAS-registered under ``/train/state/<name>``;
``resume`` restores the latest checkpoint.  Straggler detection: a logged
step slower than ``straggler_factor``× the step-time EMA is counted
(``/train{loop#0}/stragglers/detected``), and with ``retry_stragglers``
its batch is stepped again (host-level redundant dispatch).  The
reference's ``elastic_restart`` (a reshard onto another mesh through
``migration.migrate_to_mesh``) waits for the port's mesh.

The trainer runs on ``cuda`` unless given ``device="cpu"``; without CUDA
it raises, and the model must live on the trainer's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import scheduler as _sched
from repro_torch.core.future import Future
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.models.model import Model
from repro_torch.obs import trace as _trace
from repro_torch.optim import adamw
from repro_torch.train import step as step_mod


@dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0  # 0 = disabled
    ckpt_dir: str = "checkpoints"
    straggler_factor: float = 3.0
    retry_stragglers: bool = False


class Trainer:
    def __init__(self, model: Model, opt_cfg: adamw.AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainConfig, rng_seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 prefetcher: Any = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, trainer asked "
                             f"for {self.device}")
        self.model = model
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        # the AMT runtime up, its I/O plane partitioned: prefetch assembly
        # and checkpoint writes run on the "io" pool
        _sched.get_runtime().add_pool("io", 1)

        self.params = model.init(rng_seed)
        self.opt_state = adamw.init(self.params)
        self.step_num = 0
        self._step_fn = step_mod.make_train_step(model, opt_cfg)
        self.prefetcher = (prefetcher if prefetcher is not None
                           else Prefetcher(model.cfg, data_cfg))
        self.gid = _agas.default().register_name(
            f"/train/state/{model.cfg.name}", self.state(), replace=True)

        reg = _counters.default()
        self.t_step = reg.timer("/train{loop#0}/step/duration", percentiles=True)
        self.c_steps = reg.counter("/train{loop#0}/steps/cumulative")
        self.c_straggler = reg.counter("/train{loop#0}/stragglers/detected")
        self.g_loss = reg.gauge("/train{loop#0}/loss/instantaneous")

    def state(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt_state}

    def close(self) -> None:
        """Drop the trainer's AGAS record, which otherwise holds its params
        and moments for the life of the process.  Trainers of one arch
        bind the same name, hence the same record: closing either drops it."""
        reg = _agas.default()
        if reg.contains(self.gid):
            reg.unregister(self.gid)

    # ------------------------------------------------------------------ fit
    def fit(self, steps: Optional[int] = None) -> List[Dict[str, float]]:
        steps = steps or self.tcfg.steps
        history: List[Dict[str, float]] = []
        ckpt_futures: List[Future] = []
        for _ in range(steps):
            i = self.step_num
            batch = self.prefetcher.get(i).get()  # future → host batch
            t0 = time.perf_counter()
            with _trace.span("train/step", "train", step=i):
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch)
            if (i + 1) % self.tcfg.log_every == 0 or i + 1 == steps:
                loss = float(metrics["loss"])  # waits for the device (only here)
                dt = time.perf_counter() - t0
                self.t_step.add(dt)
                self._check_straggler(dt, batch)
                self.g_loss.set(loss)
                history.append({"step": i + 1, "loss": loss,
                                "grad_norm": float(metrics["grad_norm"])})
            self.c_steps.increment()
            self.step_num += 1
            if self.tcfg.ckpt_every and self.step_num % self.tcfg.ckpt_every == 0:
                ckpt_futures.append(self.checkpoint_async())
        for f in ckpt_futures:
            f.get()  # join outstanding checkpoint I/O
        _agas.default().rebind(self.gid, self.state())
        return history

    def _check_straggler(self, dt: float, batch) -> None:
        ema = self.t_step.ema
        if ema is not None and dt > self.tcfg.straggler_factor * max(ema, 1e-9):
            self.c_straggler.increment()
            if self.tcfg.retry_stragglers:
                # host-level redundant dispatch: re-run the same batch (the
                # multi-controller analogue re-sends work to a healthy host)
                self.params, self.opt_state, _ = self._step_fn(
                    self.params, self.opt_state, batch)

    # ----------------------------------------------------------- checkpoint
    def checkpoint_async(self) -> Future:
        return ckpt_mod.save_async(Path(self.tcfg.ckpt_dir), self.step_num, self.state())

    def resume(self) -> int:
        """Restore the latest checkpoint onto the trainer's device."""
        step, state = ckpt_mod.restore(Path(self.tcfg.ckpt_dir))
        dev = self.device
        self.params = {k: v.to(dev) for k, v in state["params"].items()}
        opt = state["opt"]
        self.opt_state = {"m": {k: v.to(dev) for k, v in opt["m"].items()},
                          "v": {k: v.to(dev) for k, v in opt["v"].items()},
                          "step": opt["step"].to(dev)}
        self.step_num = step
        _agas.default().rebind(self.gid, self.state())
        return step
