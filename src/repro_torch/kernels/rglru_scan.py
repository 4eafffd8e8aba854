"""RG-LRU linear recurrence: the Hopper kernel's launcher and its plain
PyTorch version.

The kernel (``csrc/rglru_scan.cu``) replaces the reference's TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan_fwd``: h_t = a_t·h_{t−1} + b_t
per channel from h_0 = 0 over a/b (B, S, W), carried in fp32 and written
in a's dtype at every step.  It masks a ragged W itself, so nothing is
padded as the reference's wrapper does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
# the plain version is the sequential oracle itself: the kernel runs the
# same recurrence, one rounded product and one rounded sum per step
from repro_torch.kernels.ref import rglru as rglru_scan_plain

__all__ = ["rglru_scan_fwd", "rglru_scan_plain"]


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  a/b: (B,S,W)
    in one dtype, contiguous on one CUDA device → h (B,S,W)."""
    what = "rglru_scan_fwd"
    _build.check_tensors(what, a, (("a", a), ("b", b)), a.dtype)
    if a.dim() != 3 or a.shape != b.shape or a.shape[0] > 65535 or a.numel() == 0:
        raise ValueError(f"{what}: a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be one non-empty (B,S,W) shape with B ≤ 65535")
    B, S, W = a.shape
    h = torch.empty_like(a)
    _build.launch("repro_rglru_scan_fwd", what, a, a.data_ptr(), b.data_ptr(),
                  h.data_ptr(), B, S, W, _build.DTYPES[a.dtype])
    return h
