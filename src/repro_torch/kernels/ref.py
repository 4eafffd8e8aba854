"""Plain PyTorch oracles for the attention kernels (the ground truth in
tests), ported from the reference's ``kernels/ref.py``.

Deliberately naive: quadratic attention, fp32 math, ``-inf`` masks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
        window: int = 0) -> torch.Tensor:
    """q: (B,S,H,Dh), k/v: (B,S,KV,Dh), GQA via H % KV == 0. fp32 math."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) / math.sqrt(Dh)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        ok = kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(B, S, H, Dh).to(q.dtype)


def decode_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode. q: (B,H,Dh), k/v: (B,T,KV,Dh); positions >= length
    masked (length scalar or (B,)). fp32 math."""
    B, H, Dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k.float()) / math.sqrt(Dh)
    if length is not None:
        lens = torch.as_tensor(length, device=q.device).broadcast_to((B,))
        mask = torch.arange(T, device=q.device)[None, :] < lens[:, None]
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(B, H, Dh).to(q.dtype)
