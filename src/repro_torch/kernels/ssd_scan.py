"""Mamba-2 SSD chunked scan: the Hopper kernel's launcher, its plan and its
plain PyTorch version.

The kernel (``csrc/ssd_scan.cu``) replaces the reference's TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan_fwd``.  It takes the public layouts
— x (B, S, H, P), dt (B, S, H), A (H,) fp32, B/C (B, S, G, N) — reads A by
head and B/C by group (h // (H/G)), and masks the ragged last chunk, so
nothing is tiled, repeated or padded as the reference's wrapper does.  dt
is in x's dtype or fp32: the Mamba-2 block feeds an fp32 softplus dt with
bf16 x, B and C, and the kernel reads it as it lies, as the reference's
kernel casts each input to fp32.  On request it also returns the fp32
state after the last step, (B, H, P, N), as the model's prefill caches it
(the reference's ``models/ssm.py::ssd_chunked``).

Per chunk c of ``chunk`` steps, with cum the inclusive cumsum of dt·A in
the chunk and S_in(c) the fp32 (N, P) state entering it:
    y_i = Σ_{j≤i} (C_i·B_j)·exp(cum_i − cum_j)·dt_j·x_j + exp(cum_i)·C_i·S_in(c)
    S_in(c+1) = S_in(c)·exp(cum_end) + Σ_j exp(cum_end − cum_j)·dt_j·B_j ⊗ x_j
The chunk decides where the state is carried, so it changes the sums'
order (not the function): the plain version uses the same chunks.

The kernel runs the chunks in parallel (:func:`ssd_plan`): every chunk's
local state, then the one walk over chunks that turns them into S_in(c),
then every chunk's outputs (bf16: a block per chunk and head; fp32: per
64 rows of one); the workspace holds the states and the cumsums between
the launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

MAX_CHUNK = 256      # csrc: one scan element per thread
MAX_N = 128          # csrc: one warp per 16 rows of the state
MAX_P = 128          # csrc: a warp's accumulators span P
ROW_TILE = 64        # csrc: chunk rows per fp32 output block (4 warps × 16)
PASS_THREADS = 256   # csrc: state entries per block of the state pass
MAX_GRID_YZ = 65535


class SSDPlan(NamedTuple):
    chunks: int       # ⌈S / chunk⌉; the last holds S − (chunks − 1)·chunk steps
    out_blocks: int   # output blocks per chunk: bf16 1 (16 row tiles of 16 in pairs,
                      # one per warp), fp32 ⌈chunk / ROW_TILE⌉ (past a ragged end: none)
    grids: Tuple[Tuple[int, int, int], ...]  # chunk states, state pass (none for one
                                             # chunk and no final state), outputs
    state_floats: int  # the (N, P) states, B·H·chunks of them (the last one
                       # formed only for the final state)
    ws_floats: int     # + cum_end per (b, h, chunk) and cum per (b, h, step), rounded up
                       # to 16 bytes; bf16: + S_in as bf16 hi and lo planes


@functools.lru_cache(maxsize=None)
def ssd_plan(B: int, S: int, H: int, P: int, N: int, chunk: int, bf16: bool,
             final: bool = False) -> SSDPlan:
    """How the kernel cuts (B, S, H) into blocks and what scratch it takes
    (fp32 floats), for ``chunk`` steps a chunk; ``bf16``: the call's dtype
    is bfloat16 (the tensor cores take S_in as bf16 planes); ``final``: the
    call returns the final state (the state pass then runs for one chunk
    too, and writes it)."""
    chunks = -(-S // chunk)
    out_blocks = 1 if bf16 else -(-chunk // ROW_TILE)
    state_pass = chunks > 1 or final
    grids = ((chunks, H, B),) + (((-(-N * P // PASS_THREADS), H, B),) if state_pass else ()) \
        + ((out_blocks * chunks, H, B),)
    state_floats = B * H * chunks * N * P
    planes_at = -(-(state_floats + B * H * (chunks + S)) // 4) * 4
    return SSDPlan(chunks, out_blocks, grids, state_floats,
                   planes_at + (state_floats if bf16 else 0))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                   return_final_state: bool = False):
    """Plain PyTorch version of the kernel: the same chunked dual form in
    fp32, all (batch, head) rows and every chunk at once — a few large ops,
    which autograd differentiates in a few more (the training backward,
    ``ops.ssd_scan_bwd``, recomputes through it).  → y (B,S,H,P) in x's
    dtype, and with ``return_final_state`` also the fp32 state after step
    S, (B,H,P,N).

    S is padded to whole chunks with dt = 0: a step that neither decays
    nor adds, so the padding is inert (and causal).  Within a chunk y =
    ((C·Bᵀ) ⊙ L ⊙ dtᵀ)·x with L = exp(cum_i − cum_j) for j ≤ i; each chunk's
    own end state from its steps; the state entering chunk c is
    Σ_{z<c} exp(T_{z+1} + … + T_{c−1}) · state_z for the chunk totals
    T = Σ dt·A, the sums taken by a masked cumsum (no difference of large
    running sums), then read through exp(cum)·(C·S)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, dtf = x.float(), dt.float()
    Bf = Bm.float().repeat_interleave(H // G, dim=2)
    Cf = Cm.float().repeat_interleave(H // G, dim=2)
    if pad:
        xf, dtf, Bf, Cf = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                           for t in (xf, dtf, Bf, Cf))
    xc = xf.reshape(B, nc, Q, H, P)
    Bc, Cc = Bf.reshape(B, nc, Q, H, N), Cf.reshape(B, nc, Q, H, N)
    d = dtf.reshape(B, nc, Q, H).permute(0, 3, 1, 2)            # (B,H,nc,Q)
    cum = torch.cumsum(d * A.float()[None, :, None, None], dim=-1)
    later = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu(1)
    # exp(cum_i − cum_j) only for j ≤ i; above the diagonal exp(−inf) = 0
    L = (cum[..., :, None] - cum[..., None, :]).masked_fill(later, -torch.inf).exp()
    scores = torch.einsum("bcihn,bcjhn->bhcij", Cc, Bc) * L * d[..., None, :]
    y = torch.einsum("bhcij,bcjhp->bcihp", scores, xc)
    # each chunk's end state from its own steps, (B,nc,H,N,P)
    w = torch.exp(cum[..., -1:] - cum) * d
    states = torch.einsum("bhcj,bcjhn,bcjhp->bchnp", w, Bc, xc)
    # the states entering chunks 0..nc (the last: the final state): a zero
    # state, then the chunks' own, carried by exp of the chunk totals' sums
    T = torch.nn.functional.pad(cum[..., -1], (1, 0))          # (B,H,nc+1)
    tril = torch.ones(nc + 1, nc + 1, dtype=torch.bool, device=x.device).tril
    seg = T[..., :, None].expand(*T.shape, nc + 1).masked_fill(~tril(-1), 0.0)
    seg = torch.cumsum(seg, dim=-2).masked_fill(~tril(0), -torch.inf)
    carried = torch.einsum("bhzc,bchnp->bzhnp", seg.exp(),
                           torch.cat([torch.zeros_like(states[:, :1]), states], dim=1))
    y = y + torch.einsum("bcihn,bchnp,bhci->bcihp", Cc, carried[:, :nc], torch.exp(cum))
    y = y.reshape(B, nc * Q, H, P)[:, :S].to(x.dtype)
    if return_final_state:
        return y, carried[:, nc].transpose(-1, -2).contiguous()
    return y


def check_ssd_args(what: str, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> Tuple[int, int]:
    """The kernel's dtype and shape rules, on tensors of any device; → the
    dtype codes of x and of dt.  x, Bm and Cm share a dtype the kernels
    take; dt is in it or fp32 (the only mix: fp32 x takes fp32 dt); A is
    fp32."""
    codes = _build.DTYPES
    if x.dtype not in codes or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"{what}: x, Bm, Cm have dtypes {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}; expected one of {list(codes)}, shared")
    if dt.dtype not in (x.dtype, torch.float32) or A.dtype != torch.float32:
        raise TypeError(f"{what}: dt has dtype {dt.dtype} (x's {x.dtype} or "
                        f"float32), A {A.dtype} (float32)")
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"{what}: bad shapes x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or Bm.shape[:2] != (B, S) or H % G != 0:
        raise ValueError(f"{what}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)} do not fit together")
    if not 1 <= chunk <= MAX_CHUNK or not 1 <= N <= MAX_N or not 1 <= P <= MAX_P \
            or B > MAX_GRID_YZ or H > MAX_GRID_YZ or S == 0:
        raise ValueError(f"{what}: chunk {chunk} (1–{MAX_CHUNK}), N {N} (1–{MAX_N}), "
                         f"P {P} (1–{MAX_P}), batch {B} or heads {H} (≤ {MAX_GRID_YZ}) "
                         f"out of range")
    return codes[x.dtype], codes[dt.dtype]


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                 return_final_state: bool = False):
    """Launch the CUDA kernel on PyTorch's current stream.  x (B,S,H,P) and
    Bm/Cm (B,S,G,N) in one dtype, dt (B,S,H) in it or fp32, A (H,) fp32,
    all contiguous on one CUDA device; 1 ≤ chunk ≤ 256, N and P at most
    128 (:func:`check_ssd_args`).  → y, or (y, final fp32 (B,H,P,N) state)
    with ``return_final_state``."""
    what = "ssd_scan_fwd"
    code, dt_code = check_ssd_args(what, x, dt, A, Bm, Cm, chunk)
    _build.check_tensors(what, x, (("x", x), ("dt", dt), ("A", A), ("Bm", Bm),
                                   ("Cm", Cm)))
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    plan = ssd_plan(B, S, H, P, N, chunk, x.dtype == torch.bfloat16, return_final_state)
    y = torch.empty_like(x)
    final = (torch.empty(B, H, P, N, dtype=torch.float32, device=x.device)
             if return_final_state else None)
    _build.launch("repro_ssd_scan_fwd", what, x, x.data_ptr(), dt.data_ptr(),
                  A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), _build.WORKSPACE,
                  y.data_ptr(), None if final is None else final.data_ptr(),
                  B, S, H, P, G, N, chunk, plan.chunks, code, dt_code,
                  ws_floats=plan.ws_floats)
    return y if final is None else (y, final)
