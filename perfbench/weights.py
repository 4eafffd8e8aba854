"""Weights made from ``--seed`` on the device: every tensor in one call
of its own generator, so that any one of them can be made again alone
(the reference regenerates a training step's starting point leaf by
leaf), in the type it is used in.

The layout (names and shapes) is the program's, read from its parameter
specs; the values are the benchmark's: matrices ~ N(0, 1/fan_in), tables
~ N(0, 0.02²), norm scales 1 + N(0, 0.1²) and biases N(0, 0.02²), so
that the comparison with the reference exercises every one of them.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import torch

Layout = Dict[str, Tuple[Tuple[int, ...], str]]  # name -> (shape, kind)


def layout_of(param_specs) -> Layout:
    """{name: (shape, kind)} from the program's parameter specs; kind is
    ``scale`` (a norm scale: its spec starts at ones), ``bias`` (zeros),
    ``table`` (a spec with its own scale) or ``matrix``."""
    out: Layout = {}
    for name, spec in param_specs.items():
        kind = {"ones": "scale", "zeros": "bias"}.get(spec.init)
        if kind is None:
            kind = "table" if spec.scale is not None else "matrix"
        out[name] = (tuple(spec.shape), kind)
    return out


def _seed_of(seed: int, name: str) -> int:
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (2 ** 63)


def make_one(name: str, shape: Tuple[int, ...], kind: str, seed: int,
             device, dtype: torch.dtype) -> torch.Tensor:
    """One tensor, the same for the same (seed, name) on the same device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_of(seed, name))
    x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if kind == "scale":
        return x.mul_(0.1).add_(1.0)
    if kind in ("bias", "table"):
        return x.mul_(0.02)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return x.mul_(1.0 / math.sqrt(fan_in))


def make(layout: Layout, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every tensor of ``layout`` in ``dtype`` but the norm scales, in
    fp32 (the types the program serves them in)."""
    out = {}
    for name in sorted(layout):
        shape, kind = layout[name]
        dt = torch.float32 if kind == "scale" else dtype
        out[name] = make_one(name, shape, kind, seed, device, dt)
    return out
