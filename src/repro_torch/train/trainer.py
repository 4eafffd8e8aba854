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
``resume`` restores the latest checkpoint (with ``shardings=``, onto a
mesh).  Straggler detection: a logged step slower than
``straggler_factor``× the step-time EMA is counted
(``/train{loop#0}/stragglers/detected``), and with ``retry_stragglers``
its batch is stepped again (host-level redundant dispatch).

On a mesh (``mesh=``, SPMD: every rank builds the same trainer) params
and optimizer state are DTensors placed by
``step.train_state_shardings``, and each batch — the same global batch
on every rank — by ``step.batch_shardings``; metrics read the replicated
loss's full value.  ``elastic_restart(new_mesh)`` migrates the live state
onto another mesh (failure shrink / regrow), rebuilds the step against it
and rebinds the AGAS record with ``placement=new_mesh``.  A rank outside
the trainer's mesh holds no state and steps nothing.

The trainer runs on ``cuda`` unless given ``device="cpu"``; without CUDA
it raises, and the model (and mesh) must live on the trainer's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import migration
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
                 prefetcher: Any = None, mesh: Any = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, trainer asked "
                             f"for {self.device}")
        step_mod.check_mesh(model, mesh)
        self.model = model
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        # the AMT runtime up, its I/O plane partitioned: prefetch assembly
        # and checkpoint writes run on the "io" pool
        _sched.get_runtime().add_pool("io", 1)

        self.params = model.init(rng_seed)
        self.opt_state = adamw.init(self.params)
        self.mesh = None
        if mesh is not None:
            self._place(mesh)
        self.step_num = 0
        self._step_fn = step_mod.make_train_step(model, opt_cfg, mesh)
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

    def shardings(self, mesh: Any) -> Dict[str, Any]:
        """The train state's placements on ``mesh``, as a tree like
        :meth:`state` (``resume(shardings=...)`` takes it)."""
        p_sh, o_sh = step_mod.train_state_shardings(self.model, mesh)
        return {"params": p_sh, "opt": o_sh}

    def _place(self, mesh: Any) -> None:
        """The state onto ``mesh``, leaf by leaf in its own dicts (a second
        full state would not fit beside the first on one card)."""
        migration.migrate_tree(self.state(), self.shardings(mesh), mesh, in_place=True)
        self.mesh = mesh

    def _member(self) -> bool:
        return self.mesh is None or self.mesh.get_coordinate() is not None

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
        if not self._member():  # outside the mesh: nothing to step
            return history
        for _ in range(steps):
            i = self.step_num
            batch = self.prefetcher.get(i).get()  # future → host batch
            t0 = time.perf_counter()
            with _trace.span("train/step", "train", step=i):
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch)
            if (i + 1) % self.tcfg.log_every == 0 or i + 1 == steps:
                loss = _value(metrics["loss"])  # waits for the device (only here)
                dt = time.perf_counter() - t0
                self.t_step.add(dt)
                self._check_straggler(dt, batch)
                self.g_loss.set(loss)
                history.append({"step": i + 1, "loss": loss,
                                "grad_norm": _value(metrics["grad_norm"])})
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
            if self.tcfg.retry_stragglers and self.mesh is None:
                # (not on a mesh: each rank times its own step, and a retry
                # on one rank alone would leave its peers' collectives waiting)
                # host-level redundant dispatch: re-run the same batch (the
                # multi-controller analogue re-sends work to a healthy host)
                self.params, self.opt_state, _ = self._step_fn(
                    self.params, self.opt_state, batch)

    # ----------------------------------------------------------- checkpoint
    def checkpoint_async(self) -> Future:
        return ckpt_mod.save_async(Path(self.tcfg.ckpt_dir), self.step_num, self.state())

    def resume(self, shardings: Optional[Any] = None, mesh: Any = None) -> int:
        """Restore the latest checkpoint onto the trainer's device, or with
        ``shardings`` (:meth:`shardings` of the target mesh) onto ``mesh``
        (default: the trainer's), which becomes the trainer's mesh.  On a
        mesh every rank of the process group calls it: a barrier first
        lets the writing rank finish."""
        if shardings is None:
            step, state = ckpt_mod.restore(Path(self.tcfg.ckpt_dir))
            dev = self.device
            self.params = {k: v.to(dev) for k, v in state["params"].items()}
            opt = state["opt"]
            self.opt_state = {"m": {k: v.to(dev) for k, v in opt["m"].items()},
                              "v": {k: v.to(dev) for k, v in opt["v"].items()},
                              "step": opt["step"].to(dev)}
        else:
            mesh = mesh if mesh is not None else self.mesh
            step_mod.check_mesh(self.model, mesh)
            dist.barrier()
            step, state = ckpt_mod.restore(Path(self.tcfg.ckpt_dir),
                                           shardings=shardings, mesh=mesh)
            self.params, self.opt_state = state["params"], state["opt"]
            if mesh is not self.mesh:
                self.mesh = mesh
                self._step_fn = step_mod.make_train_step(self.model, self.opt_cfg, mesh)
        self.step_num = step
        _agas.default().rebind(self.gid, self.state())
        return step

    # -------------------------------------------------------------- elastic
    def elastic_restart(self, new_mesh: Any) -> None:
        """Migrate the live state onto a different mesh (failure shrink /
        regrow) and rebuild the step function against it.  Every rank of
        the old and the new mesh calls it."""
        step_mod.check_mesh(self.model, new_mesh)
        self._place(new_mesh)
        self._step_fn = step_mod.make_train_step(self.model, self.opt_cfg, new_mesh)
        _agas.default().rebind(self.gid, self.state(), placement=new_mesh)
        _counters.counter("/train{loop#0}/elastic_restarts/cumulative").increment()


def _value(t: Any) -> float:
    """A metric's value: a DTensor's full (replicated) value."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return float(t)
