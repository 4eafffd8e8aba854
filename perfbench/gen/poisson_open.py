"""An open loop of independent requests: Poisson arrivals at the cell's
rate, prompt and output lengths from the mix's distributions.

Every seed gets the same schedule: the gaps between arrivals are the
exponential distribution's quantiles at (i + 0.5) / N and the lengths the
quantiles of theirs, each set shuffled once by the mix's ``order_seed``.
The run's seed draws the prompts' token ids (and the weights).  So the
work of a window is the same for every seed: with the order drawn from
the seed, which requests' tokens fall inside the window moved
``output_tokens_per_s`` by 15 % between seeds where two runs of one seed
agreed within 1 % (PERF.md).

Requests are due from ``-lead_s`` (a lead-in that fills the engine and
is not measured) to the window's end; the window is ``[0, seconds)``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def _quantiles(dist: Dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "log_uniform":
        return np.rint(np.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)).astype(np.int64)
    if dist["dist"] == "uniform":
        return (lo + np.floor((hi - lo + 1) * u)).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def _arrivals(rng: np.random.Generator, n: int, rate: float, start: float,
              length: float) -> np.ndarray:
    """``n`` due times in ``[start, start + length)``: the first at
    ``start``, then exponential gaps in ``rng``'s order, scaled to the
    stretch."""
    if n == 0:
        return np.zeros(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = rng.permutation(gaps)
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return start + t * (length / gaps.sum())


def schedule(mix: Dict, cell: Dict, seed: int, seconds: float, vocab: int) -> List[Dict]:
    """[{due, prompt, out_tokens, in_window}] in due order; ``prompt`` an
    int64 array of ids in [1, vocab), ``out_tokens`` the tokens to
    generate (the prefill's first token included)."""
    rate, lead = float(cell["rate_per_s"]), float(mix["lead_s"])
    order = np.random.default_rng([int(mix["order_seed"]), 1])
    n_lead, n_win = round(rate * lead), round(rate * seconds)
    due = np.concatenate([_arrivals(order, n_lead, rate, -lead, lead),
                          _arrivals(order, n_win, rate, 0.0, seconds)])
    n = len(due)
    prompts = order.permutation(_quantiles(mix["prompt_tokens"], n))
    outs = order.permutation(_quantiles(mix["output_tokens"], n))
    rng = np.random.default_rng([int(seed), 1])
    out = []
    for i in range(n):
        ids = rng.integers(1, vocab, size=int(prompts[i]), dtype=np.int64)
        out.append({"due": float(due[i]), "prompt": ids, "out_tokens": int(outs[i]),
                    "in_window": bool(due[i] >= 0.0)})
    return out


def warmup(mix: Dict, seed: int, vocab: int) -> List[np.ndarray]:
    """Prompts whose lengths cover the mix's range (its ends, every power
    of two inside it and the next length, and points between), from a
    stream of their own: every prefill shape the window can meet, under
    any bucketing by length."""
    rng = np.random.default_rng([int(seed), 2])
    lo, hi = mix["prompt_tokens"]["min"], mix["prompt_tokens"]["max"]
    lengths = {lo, hi}
    k = 1
    while k < hi:
        lengths.update(n for n in (k, k + 1) if lo <= n <= hi)
        k *= 2
    lengths.update(int(round(lo * (hi / lo) ** (i / 4))) for i in range(1, 4))
    return [rng.integers(1, vocab, size=n, dtype=np.int64) for n in sorted(lengths)]
