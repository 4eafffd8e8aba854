"""Public wrappers around the kernels: the port's counterpart of the
reference's single-source kernel API, ``repro.kernels.ops``.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor goes to the kernel's plain PyTorch version, a CUDA tensor to the
hand-written Hopper kernel — or the wrapper raises.  There is no fallback
from one to the other.

Every kernel wrapper counts its launches (:func:`launch_counts`), so a run
can show that its main path went through the kernels; plain-version calls
are not counted.

The wrappers keep the reference's shapes and semantics but drop its TPU
tile arguments (``block_q``, ``block_k``, ``block_s``, ``block_w``,
``block``) and ``interpret``: the tiles never changed a result, and the
kernels here choose their own.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                  decode_attention_plain,
                                                  paged_decode_attention_fwd,
                                                  paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)
from repro_torch.kernels.rglru_scan import rglru_scan_fwd, rglru_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain
from repro_torch.kernels.stream import stream_triad_fwd, stream_triad_plain

KERNELS = ("flash_attention", "paged_decode_attention", "decode_attention",
           "ssd_scan", "rglru_scan", "stream_triad")
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_launch_lock = threading.Lock()  # prefill and decode launch from different threads


def _count(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in _launches:
            _launches[name] = 0


def _route(t: torch.Tensor, what: str) -> bool:
    """True → the CUDA kernel, False → the plain version; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    valid_len: int = 0) -> torch.Tensor:
    """q: (B,S,H,Dh), k/v: (B,S,KV,Dh) → (B,S,H,Dh). GQA via H % KV == 0.
    ``valid_len`` (0 means S) masks K positions at or past it."""
    if not _route(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     valid_len=valid_len)
    o = flash_attention_fwd(q, k, v, causal=causal, window=window,
                            valid_len=valid_len)
    _count("flash_attention")
    return o


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length) -> torch.Tensor:
    """One-token decode over a dense cache.

    q: (B,H,Dh), k/v: (B,T,KV,Dh) → (B,H,Dh).  ``length`` is the valid
    cache prefix: an int or 0-d tensor (uniform fill) or a (B,) tensor
    (every slot at its own depth), clamped to T.  A slot of length 0 gives
    zeros, as the reference's kernel does.  The kernel reads each K/V head
    once for its G query heads; nothing is repeated or padded."""
    if not _route(q, "decode_attention"):
        return decode_attention_plain(q, k, v, length)
    o = decode_attention_fwd(q, k, v, length)
    _count("decode_attention")
    return o


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Paged decode over a block-pool KV cache.

    q: (B,H,Dh); k_pages/v_pages: (P, page, KV, Dh); page_table: (B, maxp)
    int32 (entries past the fill must be valid pool indices, e.g. 0);
    lengths: (B,) int32 → (B,H,Dh).  The kernel walks each request's own
    page list; no dense gather."""
    if not _route(q, "paged_decode_attention"):
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths)
    o = paged_decode_attention_fwd(q, k_pages, v_pages, page_table, lengths)
    _count("paged_decode_attention")
    return o


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
             return_final_state: bool = False):
    """Mamba-2 SSD scan.  x: (B,S,H,P), dt: (B,S,H) in x's dtype or
    float32, A: (H,) float32, Bm/Cm: (B,S,G,N) in x's dtype → y (B,S,H,P)
    in x's dtype; with ``return_final_state`` → (y, the fp32 state after
    step S, (B,H,P,N)), as the reference's ``ssd_chunked`` returns it.

    ``chunk`` (clipped to S, as the reference does) is where the fp32 state
    is carried from one chunk to the next; mamba2_780m sets 256, the
    kernel takes 1–256."""
    chunk = min(chunk, x.shape[1])
    if not _route(x, "ssd_scan"):
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                              return_final_state=return_final_state)
    out = ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk,
                       return_final_state=return_final_state)
    _count("ssd_scan")
    return out


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t from h_0 = 0, fp32 carry.
    a/b: (B,S,W) → (B,S,W) in a's dtype."""
    if not _route(a, "rglru_scan"):
        return rglru_scan_plain(a, b)
    h = rglru_scan_fwd(a, b)
    _count("rglru_scan")
    return h


def stream_triad(a: torch.Tensor, b: torch.Tensor, alpha: float = 3.0) -> torch.Tensor:
    """STREAM triad a + alpha·b over (N,), rounded as ``a + alpha * b``."""
    if not _route(a, "stream_triad"):
        return stream_triad_plain(a, b, alpha)
    o = stream_triad_fwd(a, b, alpha)
    _count("stream_triad")
    return o


def gather_paged_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize per-request dense caches from the block pool.

    k_pages/v_pages: (P, page, KV, Dh), page_table: (B, maxp)
    → (B, maxp·page, KV, Dh).  Tests and the plain decode version use it;
    the kernel never materializes it."""
    P, page, KV, Dh = k_pages.shape
    B, maxp = page_table.shape
    idx = page_table.reshape(-1).long()
    return (k_pages.index_select(0, idx).reshape(B, maxp * page, KV, Dh),
            v_pages.index_select(0, idx).reshape(B, maxp * page, KV, Dh))
