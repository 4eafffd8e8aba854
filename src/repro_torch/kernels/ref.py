"""Plain PyTorch oracles (the ground truth in tests), ported from the
reference's ``kernels/ref.py``.

Deliberately naive: O(S) sequential recurrences in fp32, no blocking
tricks.  The attention kernels' oracles are their plain versions
(``flash_attention_plain``, ``decode_attention_plain``), held against the
reference's ``ref.mha`` and ``ref.decode_mha`` in the tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (the O(S) definition).

    x: (B,S,H,P), dt: (B,S,H), A: (H,) negative, Bm/Cm: (B,S,G,N).
    h_t = h_{t-1}·exp(dt_t·A) + dt_t·B_t⊗x_t ;  y_t = C_t·h_t
    Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])  # (B,H)
        upd = torch.einsum("bh,bhn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        h = h * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def rglru(a: torch.Tensor, b: torch.Tensor,
          h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential linear recurrence h_t = a_t·h_{t-1} + b_t, fp32 carry,
    each h_t written in a's dtype. a/b: (B,S,W)."""
    B, S, W = a.shape
    h = (torch.zeros(B, W, dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    out = torch.empty_like(a)
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h
    return out


def triad(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """STREAM triad: a + alpha·b (the product rounded to the dtype, then
    the sum)."""
    return a + alpha * b
