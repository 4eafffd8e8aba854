"""Mamba-2 SSD (state-space duality) blocks [arXiv:2405.21060], ported from
the reference's ``models/ssm.py``.

The chunked "dual" algorithm: within a chunk the recurrence is computed in
matmul form, across chunks the fp32 (H, P, N) state is carried.  The same
math lives in three places with one oracle:

- here (`ssd_chunked`): the model's path, through ``ops.ssd_scan_trainable``
  (the kernel forward, a backward through the plain version);
- ``kernels/ssd_scan.py``: the Hopper kernel (chunks in parallel across
  blocks) and its plain PyTorch version, which ``ops`` runs on CPU tensors;
- ``kernels/ref.py::ssd``: the O(S) sequential oracle both are tested
  against.

Decode is the recurrent form: state ← state·exp(dt·A) + dt·B⊗x, O(1) per
token, in plain tensor ops with the state in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import ShardingPlan
from repro_torch.kernels import ops
from repro_torch.models.layers import BATCH, cdtype, norm, on_shards, residual, rows, whole
from repro_torch.models.params import ParamSpec

Params = Dict[str, torch.Tensor]


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_headdim
    return dict(
        d_inner=d_inner,
        H=H,
        P=cfg.ssm_headdim,
        N=cfg.ssm_state,
        G=cfg.ssm_ngroups,
        conv_ch=d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state,
        d_in_proj=2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + H,
    )


def ssm_param_specs(cfg: ModelConfig, L: int, prefix: str) -> Dict[str, ParamSpec]:
    d = ssm_dims(cfg)
    D = cfg.d_model
    return {
        f"{prefix}ln": ParamSpec((L, D), ("layers", None), init="ones"),
        f"{prefix}in_proj": ParamSpec((L, D, d["d_in_proj"]), ("layers", "embed", "ssm_inner")),
        f"{prefix}conv_w": ParamSpec((L, cfg.ssm_conv, d["conv_ch"]), ("layers", None, "ssm_inner"),
                                     init="scaled", scale=0.5),
        f"{prefix}conv_b": ParamSpec((L, d["conv_ch"]), ("layers", "ssm_inner"), init="zeros"),
        f"{prefix}A_log": ParamSpec((L, d["H"]), ("layers", "ssm_heads"), init="ones"),
        f"{prefix}D": ParamSpec((L, d["H"]), ("layers", "ssm_heads"), init="ones"),
        f"{prefix}dt_bias": ParamSpec((L, d["H"]), ("layers", "ssm_heads"), init="zeros"),
        f"{prefix}gate_ln": ParamSpec((L, d["d_inner"]), ("layers", "ssm_inner"), init="ones"),
        f"{prefix}out_proj": ParamSpec((L, d["d_inner"], D), ("layers", "ssm_inner", "embed")),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv then silu. x: (B,S,C), w: (K,C), b: (C,).
    One ``F.conv1d`` with a group per channel over x left-padded by K − 1;
    on a mesh on each rank's batch rows, the weights whole (``on_shards``:
    DTensor's convolution takes no batch sharded over two mesh dims)."""
    def conv(x, w, b):
        K, C = w.shape
        w, b = w.to(x.dtype), b.to(x.dtype)
        y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), w.t()[:, None, :], b, groups=C)
        return F.silu(y.transpose(1, 2))

    return on_shards(conv, (x, w, b), (BATCH, None, None), BATCH)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, return_final_state: bool = True):
    """SSD in chunked matmul form through ``ops.ssd_scan_trainable``: the
    kernel on CUDA tensors, its plain version on CPU ones, with a backward
    in grad mode.

    x: (B,S,H,P)  dt: (B,S,H), fp32 or x's dtype  A: (H,) fp32 (negative)
    Bm/Cm: (B,S,G,N), G|H.  Returns (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N) fp32), or y alone without ``return_final_state``.  The chunk
    is clipped to S; a ragged last chunk ends at step S, so the final
    state is the state after S steps.  On a mesh each rank scans its own
    batch rows (``Lx.on_shards``).
    """
    def scan(x, dt, A, Bm, Cm):
        return ops.ssd_scan_trainable(x, dt, A, Bm, Cm, chunk=chunk,
                                      return_final_state=return_final_state)

    return on_shards(scan, (x, dt, A, Bm, Cm), (BATCH, BATCH, None, BATCH, BATCH),
                     [BATCH, BATCH] if return_final_state else BATCH)


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recurrent single step. state: (B,H,P,N) fp32, x: (B,H,P), dt: (B,H),
    Bm/Cm: (B,G,N). Returns (y (B,H,P) in x's dtype, new fp32 state)."""
    H, G = x.shape[1], Bm.shape[1]
    rep = H // G
    Bf = Bm.float().repeat_interleave(rep, dim=1)  # (B,H,N)
    Cf = Cm.float().repeat_interleave(rep, dim=1)
    dtf = dt.float()
    decay = torch.exp(dtf * A[None, :])  # (B,H)
    upd = (dtf[:, :, None] * x.float())[..., None] * Bf[:, :, None, :]  # (B,H,P,N)
    new_state = state.float() * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cf)
    return y.to(x.dtype), new_state.to(state.dtype)


# ------------------------------------------------------------- full block
def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d = ssm_dims(cfg)
    return torch.split(zxbcdt, [d["d_inner"], d["conv_ch"], d["H"]], dim=-1)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    d = ssm_dims(cfg)
    GN = d["G"] * d["N"]
    return torch.split(xbc, [d["d_inner"], GN, GN], dim=-1)


def ssm_block(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
              collect_state: bool = False, plan: Optional[ShardingPlan] = None):
    """One Mamba-2 block (train/prefill): x (B,S,D) → (B,S,D); with
    ``collect_state`` also (conv_state (B,K−1,conv_ch) in the compute
    dtype, final ssm state (B,H,P,N) fp32) for the decode cache.  The
    conv state is the last K − 1 pre-conv inputs, left-padded with zeros
    when S < K − 1.  On a mesh (``plan``) the input projection is
    batch-sharded before it splits."""
    d = ssm_dims(cfg)
    dt_ = cdtype(cfg)
    B, S, D = x.shape
    h = norm(cfg, x, p[f"{prefix}ln"])
    z, xbc_raw, dt = _split_in_proj(cfg, rows(plan, h @ p[f"{prefix}in_proj"].to(dt_)))
    xbc = causal_conv1d(xbc_raw, p[f"{prefix}conv_w"], p[f"{prefix}conv_b"])
    xs, Bm, Cm = _split_xbc(cfg, xbc)
    xs = xs.reshape(B, S, d["H"], d["P"])
    Bm = Bm.reshape(B, S, d["G"], d["N"]).contiguous()
    Cm = Cm.reshape(B, S, d["G"], d["N"]).contiguous()
    dt = F.softplus(dt.float() + p[f"{prefix}dt_bias"][None, None, :].float())
    A = -torch.exp(p[f"{prefix}A_log"].float())
    out = ssd_chunked(xs.contiguous(), dt, A, Bm, Cm, cfg.ssm_chunk,
                      return_final_state=collect_state)
    y, final_state = out if collect_state else (out, None)
    y = y + p[f"{prefix}D"].to(dt_)[None, None, :, None] * xs
    y = rows(plan, y.reshape(B, S, d["d_inner"]))
    # gated RMSNorm (Mamba-2: norm(y * silu(z)))
    y = norm(cfg, y * F.silu(z), p[f"{prefix}gate_ln"])
    out = x + residual(plan, y @ p[f"{prefix}out_proj"].to(dt_))
    if not collect_state:
        return out
    return out, (conv_state(cfg, xbc_raw), final_state.float())


def conv_state(cfg: ModelConfig, x_raw: torch.Tensor) -> torch.Tensor:
    """The last K − 1 pre-conv inputs (B,K−1,C) in the compute dtype,
    left-padded with zeros when the sequence is shorter."""
    K, S = cfg.ssm_conv, x_raw.shape[1]

    def last(x):
        pad = F.pad(x, (0, 0, max(K - 1 - S, 0), 0))
        return pad[:, pad.shape[1] - (K - 1):, :].to(cdtype(cfg))

    return on_shards(last, (x_raw,), (BATCH,), BATCH)


def conv_step(cfg: ModelConfig, conv_state: torch.Tensor, x_new: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the causal conv + silu over (state ++ current).
    conv_state: (B,K−1,C), x_new: (B,C) → (out (B,C), new state)."""
    dt_ = cdtype(cfg)
    seq = torch.cat([conv_state.to(dt_), x_new[:, None, :]], dim=1)  # (B,K,C)
    y = (seq * w.to(dt_)[None]).sum(dim=1) + b.to(dt_)
    return F.silu(y), seq[:, 1:, :]


def ssm_block_decode(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str,
                     conv_state: torch.Tensor, ssm_state: torch.Tensor,
                     plan: Optional[ShardingPlan] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B,1,D). conv_state: (B,K−1,conv_ch),
    ssm_state: (B,H,P,N). Returns (out, new_conv_state, new_ssm_state)."""
    d = ssm_dims(cfg)
    dt_ = cdtype(cfg)
    B = x.shape[0]
    h = norm(cfg, x, p[f"{prefix}ln"])[:, 0]  # (B,D)
    z, xbc, dt = _split_in_proj(cfg, rows(plan, h @ p[f"{prefix}in_proj"].to(dt_)))
    xbc, new_conv = conv_step(cfg, rows(plan, conv_state), xbc,
                              whole(plan, p[f"{prefix}conv_w"]),
                              whole(plan, p[f"{prefix}conv_b"]))
    xs, Bm, Cm = _split_xbc(cfg, xbc)
    xs = xs.reshape(B, d["H"], d["P"])
    Bm = Bm.reshape(B, d["G"], d["N"])
    Cm = Cm.reshape(B, d["G"], d["N"])
    dt = F.softplus(dt.float() + p[f"{prefix}dt_bias"][None, :].float())
    A = -torch.exp(p[f"{prefix}A_log"].float())
    ys, new_state = ssd_decode_step(ssm_state, xs, dt, A, Bm, Cm)
    ys = ys + p[f"{prefix}D"].to(dt_)[None, :, None] * xs
    ys = rows(plan, ys.reshape(B, d["d_inner"]))
    ys = norm(cfg, ys * F.silu(z), p[f"{prefix}gate_ln"])
    out = x + residual(plan, (ys @ p[f"{prefix}out_proj"].to(dt_))[:, None, :])
    return out, new_conv.to(conv_state.dtype), new_state
