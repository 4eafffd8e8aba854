"""Flash attention forward: the Hopper kernel's launcher and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the reference's TPU
kernel ``repro/kernels/flash_attention.py::flash_attention_fwd``.  Unlike
the TPU kernel it takes the public layouts directly — q (B, S, H, Dh), k/v
(B, S, KV, Dh) — routes each q head to its KV head (kv = h // G) in its
indexing, and masks the ragged sequence edge itself, so nothing is
repeated per GQA group and nothing is padded.

Both functions compute softmax(q·kᵀ/√Dh + mask)·v with fp32 math and the
TPU kernel's masks: K positions at or past ``valid_len`` (0 means S),
causal (kpos ≤ qpos) and sliding window (kpos > qpos − window), each
masked with −1e30; the output is acc / max(l, 1e-20) in q's dtype.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def _mask(S: int, causal: bool, window: int, valid_len: int,
          device: torch.device) -> torch.Tensor:
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    ok = kpos < (valid_len or S)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          valid_len: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same masks, same −1e30, same
    final division).  q: (B,S,H,Dh), k/v: (B,S,KV,Dh) → (B,S,H,Dh)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * (1.0 / math.sqrt(Dh))
    s = s.masked_fill(~_mask(S, causal, window, valid_len, q.device), NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).clamp_min(1e-20)  # (B,KV,G,S)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, v.float()) / l[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int, valid_len: int) -> None:
    """Raise on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} must be on q's CUDA "
                             f"device, got {t.device}")
        if t.dtype not in _build.DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_fwd: {name} has dtype {t.dtype}; "
                            f"q, k and v must share float32 or bfloat16")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} must be a contiguous, "
                             f"16-byte aligned 4-d tensor, got shape "
                             f"{tuple(t.shape)}")
    B, S, H, Dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != Dh:
        raise ValueError(f"flash_attention_fwd: k/v shape {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"flash_attention_fwd: {H} q heads not a multiple of "
                         f"{k.shape[2]} kv heads")
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {Dh} not in {_build.HEAD_DIMS}")
    if not 0 <= valid_len <= S or window < 0 or B * H > 65535:
        raise ValueError(f"flash_attention_fwd: bad valid_len={valid_len}, "
                         f"window={window} or B·H={B * H}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        valid_len: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.
    q: (B,S,H,Dh), k/v: (B,S,KV,Dh), contiguous, on one CUDA device."""
    check_inputs(q, k, v, window, valid_len)
    B, S, H, Dh = q.shape
    o = torch.empty_like(q)
    _build.launch("repro_flash_attention_fwd", "flash_attention_fwd", q,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, S, H, k.shape[2], Dh, int(causal), window, valid_len or S,
                  _build.DTYPES[q.dtype])
    return o
