"""Training rows of random token ids: step ``i``'s batch is ``rows``
sequences of ``seq_len + 1`` ids drawn from ``(seed, i)``, so every row
of every step differs and a step's batch can be made again alone."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def batch(mix: Dict, seed: int, step: int, vocab: int) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng([int(seed), 3, int(step)])
    toks = rng.integers(0, vocab, size=(mix["rows_per_step"], mix["seq_len"] + 1))
    return {"tokens": torch.from_numpy(toks.astype(np.int32))}
