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

Locality-sharded mode (work-to-data, ``repro_torch.container``): a
:class:`ShardedTokenDataset` is a :class:`PartitionedVector` of token
rows, block-distributed over the localities and *synthesized in place at
each owner*, in its device memory (``fill_with`` ships the generator
function, never the token bytes).  Its :class:`LocalShardFeeder` is
Prefetcher-compatible (``get(step) → Future[batch]``) but assembles
batches exclusively from the segments this locality owns, on their device
— a trainer per locality feeds from local data, and the dataset as a
whole never transits the wire.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict

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


class _WindowedFeeder:
    """AMT-driven double buffering: ``get(step)`` returns a Future[batch];
    the batches for the next ``prefetch`` steps are already being
    assembled by pool tasks.  Subclasses provide ``_build(step) → batch``."""

    def __init__(self, dcfg: DataConfig, counter_tag: str):
        self.dcfg = dcfg
        self._pending: Dict[int, Future] = {}
        self._lock = threading.Lock()
        # host I/O-plane work: the "io" pool, so prefetch never steals
        # compute slots (the default pool on unpartitioned runtimes)
        self._exec = _executor.get_executor("io", fallback="default")
        self.c_built = _counters.counter(f"/data{{{counter_tag}}}/batches/built")
        self.t_build = _counters.timer(f"/data{{{counter_tag}}}/build/duration")

    def _build(self, step: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _schedule(self, step: int) -> Future:
        def build():
            with self.t_build.time():
                b = self._build(step)
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


class Prefetcher(_WindowedFeeder):
    """Single-locality feeder: every batch synthesized here."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        super().__init__(dcfg, "pipeline#0")
        self.cfg = cfg

    def _build(self, step: int) -> Dict[str, torch.Tensor]:
        return synth_batch(self.cfg, self.dcfg, step)


# ------------------------------------------------------ locality-sharded mode
def synth_token_rows(global_idx: Any, cfg: ModelConfig,
                     dcfg: DataConfig) -> np.ndarray:
    """Deterministic token rows of the *global* stream: row ``r`` depends
    only on ``(dcfg.seed, r)``, so any locality synthesizing its own
    segment produces exactly the rows a single process would have (the
    ``fill_with`` generator — module-level, pickled by reference).  The
    reference's draws, so bit-equal to its rows."""
    S, V = dcfg.seq_len + 1, cfg.vocab_size
    period = max(2, min(64, V // 4))
    idx = np.asarray(global_idx, dtype=np.int64)
    out = np.empty((idx.shape[0], S), dtype=np.int32)
    for k, r in enumerate(idx):
        rng = np.random.default_rng(dcfg.seed * 1_000_003 + 7919 * int(r))
        base = (np.arange(S) + rng.integers(0, period)) % period
        noise = rng.integers(0, V, size=S)
        keep = rng.random(S) < 0.85  # 85% grammar, 15% noise
        out[k] = np.where(keep, base, noise)
    return out


class ShardedTokenDataset:
    """Token rows as a PartitionedVector: each locality holds — and
    synthesized, in place, on its device — only its own segments."""

    def __init__(self, pv: Any, cfg: ModelConfig, dcfg: DataConfig):
        self.pv = pv
        self.cfg = cfg
        self.dcfg = dcfg

    @classmethod
    def create(cls, name: str, cfg: ModelConfig, dcfg: DataConfig,
               rows: int, distribution: Any = "block",
               device: Any = None) -> "ShardedTokenDataset":
        """Rows of int32 tokens (``seq_len + 1`` each) on ``device``
        (``cuda`` unless ``"cpu"``; raises without CUDA)."""
        from repro_torch.container import PartitionedVector

        if cfg.family in ("vlm", "encdec"):
            raise ValueError(
                f"locality-sharded datasets synthesize token rows only; "
                f"the {cfg.family!r} family needs extra batch fields "
                f"(patches/enc) — use Prefetcher for it")
        pv = PartitionedVector.create(name, rows, dtype=np.int32,
                                      element_shape=(dcfg.seq_len + 1,),
                                      distribution=distribution, device=device)
        pv.fill_with(synth_token_rows, cfg, dcfg)
        return cls(pv, cfg, dcfg)

    @classmethod
    def attach(cls, name: str, cfg: ModelConfig,
               dcfg: DataConfig) -> "ShardedTokenDataset":
        from repro_torch.container import PartitionedVector

        return cls(PartitionedVector.attach(name), cfg, dcfg)

    def __len__(self) -> int:
        return len(self.pv)

    def feeder(self) -> "LocalShardFeeder":
        return LocalShardFeeder(self.pv, self.dcfg)


class LocalShardFeeder(_WindowedFeeder):
    """Prefetcher-compatible feeder over the *locally-owned* segments of a
    sharded dataset: batch assembly reads a construction-time snapshot of
    the local segments, taken once on their device (a copy in device
    memory — still no token ever crosses the wire), so later mutation or
    migration of the dataset never races in-flight batch builds.  Each
    batch is one index gather on that device; the rows picked are the
    reference's draws, so its batches equal the reference feeder's."""

    def __init__(self, pv: Any, dcfg: DataConfig):
        super().__init__(dcfg, f"feeder:{pv.name}")
        local = pv.local_segments()
        if not local:
            raise RuntimeError(
                f"no segment of {pv.name!r} lives on this locality — "
                f"rebalance() it here or use Prefetcher")
        self._rows = torch.cat([seg for _j, seg in local], dim=0)
        self.global_rows = np.concatenate(
            [pv.dist.global_indices(j) for j, _seg in local])
        self.pv = pv

    def _build(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(self.dcfg.seed * 9_176_081 + step)
        pick = rng.integers(0, self._rows.shape[0], size=self.dcfg.batch_size)
        return {"tokens": self._rows[torch.from_numpy(pick).to(self._rows.device)]}
