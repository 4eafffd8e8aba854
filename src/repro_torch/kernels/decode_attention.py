"""Paged decode attention: the Hopper kernel's launcher and its plain
PyTorch version.

The kernel (``csrc/paged_decode_attention.cu``) replaces the reference's
TPU kernel ``repro/kernels/decode_attention.py::paged_decode_attention_fwd``:
each query token attends over its request's page list in a block pool
k/v_pages (P, page, KV, Dh), with an fp32 online softmax over the pages
whose start lies below ``lengths[b]``.  Positions at or past the length
are masked with −1e30; the output is acc / max(l, 1e-20) in q's dtype.
Query head h of request b uses KV head h // G, as the reference's
KV-major row order does.

The TPU file's dense ``decode_attention_fwd`` is not on the port's path
yet and waits for a later slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_PAGE = 64        # csrc: two tokens per lane
MAX_GROUP = 128      # csrc: 32 warps of 4 query rows
SMEM_BYTES = 232448  # dynamic shared memory one block may use on Hopper


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, page_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather every listed page, mask past the
    length with −1e30, softmax in fp32.  q: (B,H,Dh) → (B,H,Dh)."""
    B, H, Dh = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    maxp = page_table.shape[1]
    idx = page_table.reshape(-1).long()
    kc = k_pages.index_select(0, idx).reshape(B, maxp * page, KV, Dh).float()
    vc = v_pages.index_select(0, idx).reshape(B, maxp * page, KV, Dh).float()
    qf = q.float().reshape(B, KV, G, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf, kc) * (1.0 / math.sqrt(Dh))
    valid = (torch.arange(maxp * page, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).clamp_min(1e-20)
    o = torch.einsum("bkgt,btkd->bkgd", p, vc) / l[..., None]
    return o.reshape(B, H, Dh).to(q.dtype)


def check_inputs(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 page_table: torch.Tensor, lengths: torch.Tensor) -> None:
    """Raise on anything the kernel does not take.  The page table's
    entries are not read here (that would wait for the device): they must
    be valid pool indices, which the serving cache guarantees."""
    named = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("page_table", page_table), ("lengths", lengths))
    for name, t in named:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_decode_attention_fwd: {name} must be on "
                             f"q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention_fwd: {name} must be "
                             f"contiguous")
    for name, t in named[:3]:
        if t.dtype not in _build.DTYPES or t.dtype != q.dtype:
            raise TypeError(f"paged_decode_attention_fwd: {name} has dtype "
                            f"{t.dtype}; q and the pools must share float32 "
                            f"or bfloat16")
    for name, t in named[3:]:
        if t.dtype != torch.int32:
            raise TypeError(f"paged_decode_attention_fwd: {name} must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode_attention_fwd: bad shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pages.shape)}")
    B, H, Dh = q.shape
    _, page, KV, Dk = k_pages.shape
    if Dk != Dh or H % KV != 0 or page_table.dim() != 2 \
            or page_table.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_decode_attention_fwd: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pages.shape)}, page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not fit together")
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"paged_decode_attention_fwd: head_dim {Dh} not in "
                         f"{_build.HEAD_DIMS}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode_attention_fwd: the pools must be "
                         "16-byte aligned (the kernel copies 16-byte chunks)")
    G = H // KV
    smem = 4 * G * Dh + 2 * page * (2 * Dh * k_pages.element_size() + 16)
    if page > MAX_PAGE or G > MAX_GROUP or smem > SMEM_BYTES:
        raise ValueError(f"paged_decode_attention_fwd: page {page} (max "
                         f"{MAX_PAGE}), group {G} (max {MAX_GROUP}) or shared "
                         f"memory {smem} B (max {SMEM_BYTES}) out of range")


def paged_decode_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.
    q: (B,H,Dh); k/v_pages: (P,page,KV,Dh); page_table (B,maxp) and
    lengths (B,) int32; all contiguous on one CUDA device."""
    check_inputs(q, k_pages, v_pages, page_table, lengths)
    B, H, Dh = q.shape
    _, page, KV, _ = k_pages.shape
    lib = _build.library()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_decode_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            B, H, KV, Dh, page, page_table.shape[1], _build.DTYPES[q.dtype], stream)
    _build.check(err, "paged_decode_attention_fwd")
    return o
