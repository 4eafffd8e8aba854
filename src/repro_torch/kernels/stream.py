"""STREAM triad: the Hopper kernel's launcher and its plain PyTorch
version.

The kernel (``csrc/stream.cu``) replaces the reference's TPU kernel
``repro/kernels/stream.py::triad``: out = a + α·b over (N,), with the
product rounded to the dtype before the sum, as ``a + alpha * b`` rounds
it in both frameworks.  It takes any N (16-byte vectors and a scalar
tail), so nothing is padded as the reference's wrapper does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
# the plain version is the oracle itself, ``a + alpha * b``; the kernel
# equals it bit for bit
from repro_torch.kernels.ref import triad as stream_triad_plain

__all__ = ["stream_triad_fwd", "stream_triad_plain"]


def stream_triad_fwd(a: torch.Tensor, b: torch.Tensor,
                     alpha: float = 3.0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  a/b: (N,) in
    one dtype, contiguous and 16-byte aligned on one CUDA device."""
    what = "stream_triad_fwd"
    _build.check_tensors(what, a, (("a", a), ("b", b)), a.dtype)
    if a.dim() != 1 or a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"{what}: a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be one non-empty (N,) shape")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{what}: a and b must be 16-byte aligned (the kernel "
                         f"moves 16-byte vectors)")
    o = torch.empty_like(a)
    _build.launch("repro_stream_triad", what, a, a.data_ptr(), b.data_ptr(),
                  o.data_ptr(), a.numel(), float(alpha), _build.DTYPES[a.dtype])
    return o
