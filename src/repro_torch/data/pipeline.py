"""Data pipeline: synthetic token stream with AMT-scheduler prefetch —
ported from the reference's ``data/pipeline.py``.

A deterministic numpy token stream (seeded per step, so restarts
reproduce it) with the reference's draws, so a batch is bit-equal to the
reference's; host-side batch assembly on the resource partitioner's "io"
pool; a prefetch window so batch i+1 is built while the device runs step
i.  The trainer consumes ``Future[batch]``s; batches are CPU tensors and
the train step moves every field to the model's device.  The vlm family's
batches carry ``patches`` (B, n_patches, D) and the encdec family's
``enc`` (B, seq_len, D), the stub frontends' embeddings, in bf16.

The locality-sharded dataset (``ShardedTokenDataset``,
``LocalShardFeeder``) comes with the multi-locality slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import counters as _counters
from repro_torch.core import executor as _executor
from repro_torch.core.future import Future


@dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    prefetch: int = 2


def synth_batch(cfg: ModelConfig, dcfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    """Deterministic synthetic batch for ``step``: ``tokens`` (B, S+1)
    int32 on the CPU, and the vlm family's ``patches`` or the encdec
    family's ``enc``: standard normal draws from the same generator after
    the tokens', cast to bf16 as the reference casts them (round to
    nearest even, so bit-equal).  The stream has learnable structure (a
    noisy cyclic grammar) so the train loss falls below the uniform
    entropy floor."""
    rng = np.random.default_rng(dcfg.seed * 1_000_003 + step)
    B, S = dcfg.batch_size, dcfg.seq_len + 1
    V = cfg.vocab_size
    period = max(2, min(64, V // 4))
    phase = rng.integers(0, period, size=(B, 1))
    base = (np.arange(S)[None, :] + phase) % period
    noise = rng.integers(0, V, size=(B, S))
    keep = rng.random((B, S)) < 0.85  # 85% grammar, 15% noise
    tokens = np.where(keep, base, noise).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model))
    if cfg.family == "encdec":
        batch["enc"] = rng.standard_normal((B, dcfg.seq_len, cfg.d_model))
    for k in ("patches", "enc"):
        if k in batch:
            batch[k] = torch.from_numpy(batch[k].astype(np.float32)).to(torch.bfloat16)
    return batch


class Prefetcher:
    """AMT-driven double buffering: ``get(step)`` returns a Future[batch];
    the batches for the next ``prefetch`` steps are already being
    assembled by pool tasks.  Every batch is synthesized here (the
    reference's single-locality feeder)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        self._pending: Dict[int, Future] = {}
        self._lock = threading.Lock()
        # host I/O-plane work: the "io" pool, so prefetch never steals
        # compute slots (the default pool on unpartitioned runtimes)
        self._exec = _executor.get_executor("io", fallback="default")
        self.c_built = _counters.counter("/data{pipeline#0}/batches/built")
        self.t_build = _counters.timer("/data{pipeline#0}/build/duration")

    def _schedule(self, step: int) -> Future:
        def build():
            with self.t_build.time():
                b = synth_batch(self.cfg, self.dcfg, step)
            self.c_built.increment()
            return b

        return self._exec.async_execute(build)

    def get(self, step: int) -> Future:
        with self._lock:
            fut = self._pending.pop(step, None)
            if fut is None:
                fut = self._schedule(step)
            for s in range(step + 1, step + 1 + self.dcfg.prefetch):
                if s not in self._pending:
                    self._pending[s] = self._schedule(s)
        return fut
