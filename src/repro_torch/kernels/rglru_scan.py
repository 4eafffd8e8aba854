"""RG-LRU linear recurrence: the Hopper kernel's launcher, its plan and its
plain PyTorch version.

The kernel (``csrc/rglru_scan.cu``) replaces the reference's TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan_fwd``: h_t = a_t·h_{t−1} + b_t
per channel from h_0 = 0 over a/b (B, S, W), carried in fp32 and written
in a's dtype at every step.  It masks a ragged W itself, so nothing is
padded as the reference's wrapper does.

The scan is split across S (:func:`rglru_plan`): chunks of ``CHUNK``
steps, each a block of ``THREADS`` channels, compose their affine maps
h ↦ (Π a)·h + h_local in fp32, then replay their steps from the true
incoming carry.  Only the carry at a chunk edge is rounded differently
from the serial chain; one chunk (S ≤ ``CHUNK``) is the serial chain.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
# the plain version is the sequential oracle itself: the kernel replays the
# same recurrence, one rounded product and one rounded sum per step
from repro_torch.kernels.ref import rglru as rglru_scan_plain

__all__ = ["rglru_plan", "rglru_scan_fwd", "rglru_scan_plain"]

CHUNK = 64     # csrc: steps per chunk
THREADS = 128  # csrc: channels per block, one per thread
MAX_GRID_YZ = 65535


class RGLRUPlan(NamedTuple):
    chunks: int                     # ⌈S / CHUNK⌉; the last holds S − (chunks − 1)·CHUNK steps
    grid: Tuple[int, int, int]      # the replay's (⌈W / THREADS⌉, chunks, B)
    ws_floats: int                  # (Π a, carry) per (batch, chunk, channel); 0 for one chunk


@functools.lru_cache(maxsize=None)
def rglru_plan(B: int, S: int, W: int) -> RGLRUPlan:
    """How the kernel cuts (B, S, W): chunks of ``CHUNK`` steps, blocks of
    ``THREADS`` channels, and the fp32 scratch for the chunks' maps."""
    chunks = -(-S // CHUNK)
    return RGLRUPlan(chunks, (-(-W // THREADS), chunks, B),
                     2 * B * chunks * W if chunks > 1 else 0)


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  a/b: (B,S,W)
    in one dtype, contiguous on one CUDA device → h (B,S,W)."""
    what = "rglru_scan_fwd"
    _build.check_tensors(what, a, (("a", a), ("b", b)), a.dtype)
    if a.dim() != 3 or a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"{what}: a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be one non-empty (B,S,W) shape")
    B, S, W = a.shape
    plan = rglru_plan(B, S, W)
    if B > MAX_GRID_YZ or plan.chunks > MAX_GRID_YZ:
        raise ValueError(f"{what}: batch {B} or {plan.chunks} chunks above "
                         f"{MAX_GRID_YZ}")
    h = torch.empty_like(a)
    _build.launch("repro_rglru_scan_fwd", what, a, a.data_ptr(), b.data_ptr(),
                  _build.WORKSPACE if plan.ws_floats else None, h.data_ptr(), B, S, W,
                  plan.chunks, _build.DTYPES[a.dtype], ws_floats=plan.ws_floats)
    return h
