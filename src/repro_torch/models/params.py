"""Parameter specification system: one source of truth for shape, dtype
and init, ported from the reference's ``models/params.py``.

A flat ``{path: tensor}`` dict is the params container everywhere, with
the reference's path names (``blk/wq`` …) and stacked ``(L, …)`` layer
shapes, so :func:`from_reference` maps the reference's params one to one.
The logical sharding axes are what a plan resolves against a mesh
(``dist/plan.py``).  :func:`abstract_params` gives stand-ins that hold
no data (meta tensors, or fake ones under ``FakeTensorMode``) for the dry
run, the reference's ``ShapeDtypeStruct``s.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | scaled (normal × scale)
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a buffer (the reference's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _fan_in(shape: Tuple[int, ...]) -> int:
    # matmul weights here are (.., in, out); fan-in = second-to-last dim
    return shape[-2] if len(shape) >= 2 else shape[-1]


def init_param(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(_fan_in(spec.shape))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(std).to(spec.dtype)


def init_params(specs: Dict[str, ParamSpec], seed: int, device: torch.device,
                convert: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The reference's rule (normal × 1/√fan_in, ``scale`` overrides, ones
    and zeros), drawn on ``device`` from one ``torch.Generator`` per path,
    seeded by the root seed and crc32 of the path (not ``hash()``, which is
    salted per process).  torch cannot replay ``jax.random``'s draws: parity
    with the reference goes through :func:`from_reference` instead.

    ``convert(path, tensor)``, if given, is applied to each tensor as soon
    as it is drawn, and the draw is dropped before the next: the peak is
    then the converted params plus one fp32 tensor (and its converted
    copy), not all the fp32 params."""
    out: Dict[str, torch.Tensor] = {}
    for path in sorted(specs):
        gen = torch.Generator(device=device)
        gen.manual_seed((seed << 32) | (zlib.crc32(path.encode()) % (2**31)))
        x = init_param(specs[path], gen, device)
        out[path] = x if convert is None else convert(path, x)
        del x
    return out


def from_reference(flat: Mapping[str, np.ndarray], cfg,
                   device) -> Dict[str, torch.Tensor]:
    """Turn the reference's flat ``{path: array}`` params into the port's
    tensors on ``device``: same paths, same shapes, the spec's dtype, for
    every ported family (the reference's ``init_params`` dict as it is)."""
    from repro_torch.models.model import param_specs

    specs = param_specs(cfg)
    if set(flat) != set(specs):
        raise KeyError(f"param paths differ: missing {sorted(set(specs) - set(flat))}, "
                       f"unexpected {sorted(set(flat) - set(specs))}")
    out: Dict[str, torch.Tensor] = {}
    for path, spec in specs.items():
        arr = np.asarray(flat[path], dtype=np.float32)
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"{path}: shape {arr.shape} != spec {spec.shape}")
        out[path] = torch.from_numpy(arr.copy()).to(device=device, dtype=spec.dtype)
    return out



def abstract_params(specs: Dict[str, ParamSpec], device="meta",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Stand-ins for the dry run that allocate nothing: meta tensors, or
    fake ones when called under ``FakeTensorMode`` with a real device;
    each spec's dtype unless ``dtype`` overrides it."""
    return {p: torch.empty(s.shape, dtype=dtype or s.dtype, device=device)
            for p, s in specs.items()}


def param_bytes(specs: Dict[str, ParamSpec]) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize for s in specs.values()))
