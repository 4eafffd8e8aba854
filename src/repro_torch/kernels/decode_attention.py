"""Decode attention, dense and paged: the Hopper kernels' launchers and
their plain PyTorch versions.

Both kernels replace the reference's TPU kernels in
``repro/kernels/decode_attention.py``: one query token per head attends
over its request's cache with an fp32 online softmax over the tiles whose
start lies below the request's length.  Positions at or past the length
are masked with −1e30; the output is acc / max(l, 1e-20) in q's dtype, so
a request of length 0 gives zeros, as the TPU kernel does.  Query head h
of request b uses KV head h // G, as the reference's KV-major row order
does.

* ``csrc/decode_attention.cu`` replaces ``decode_attention_fwd``: a dense
  cache k/v (B, T, KV, Dh) and a length that is an int, a 0-d tensor or a
  (B,) tensor, clamped to T.
* ``csrc/paged_decode_attention.cu`` replaces
  ``paged_decode_attention_fwd``: a block pool k/v_pages (P, page, KV, Dh)
  walked through each request's row of a page table.

Both share one block body, ``csrc/decode_attention.cuh``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_PAGE = 64        # csrc: two tokens per lane
MAX_GROUP = 128      # csrc: 32 warps of 4 query rows


def lengths_for(length, B: int, T: int, device: torch.device) -> torch.Tensor:
    """``length`` (int, 0-d or (B,) tensor) as (B,) int32 on ``device``,
    clamped to T as the reference's wrapper does."""
    lens = torch.as_tensor(length, device=device)
    if lens.dim() > 1 or (lens.dim() == 1 and lens.shape[0] != B):
        raise ValueError(f"decode_attention: length of shape {tuple(lens.shape)} is "
                         f"neither a scalar nor ({B},)")
    return lens.clamp(max=T).to(torch.int32).expand(B).contiguous()


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel (same −1e30 mask, same
    final division, zeros for a row of length 0).
    q: (B,H,Dh), k/v: (B,T,KV,Dh) → (B,H,Dh)."""
    B, H, Dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    lens = lengths_for(length, B, T, q.device).long()
    qf = q.float().reshape(B, KV, G, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k.float()) * (1.0 / math.sqrt(Dh))
    valid = (torch.arange(T, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    # × valid: a row with no valid position sums no p (exp(−1e30 − m) is
    # already 0 wherever one position is valid)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    l = p.sum(dim=-1).clamp_min(1e-20)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float()) / l[..., None]
    return o.reshape(B, H, Dh).to(q.dtype)


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, page_table: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel: gather every listed page
    into a dense cache and attend as :func:`decode_attention_plain`.
    q: (B,H,Dh) → (B,H,Dh)."""
    B = q.shape[0]
    _, page, KV, Dh = k_pages.shape
    maxp = page_table.shape[1]
    idx = page_table.reshape(-1).long()
    k = k_pages.index_select(0, idx).reshape(B, maxp * page, KV, Dh)
    v = v_pages.index_select(0, idx).reshape(B, maxp * page, KV, Dh)
    return decode_attention_plain(q, k, v, lengths)


def _check_heads(what: str, q: torch.Tensor, KV: int, Dh: int) -> None:
    H = q.shape[1]
    if q.shape[2] != Dh or H % KV != 0:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit {KV} kv heads "
                         f"of head_dim {Dh}")
    if Dh not in _build.HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {Dh} not in {_build.HEAD_DIMS}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"{what}: group {H // KV} above {MAX_GROUP}")


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length) -> torch.Tensor:
    """Launch the dense CUDA kernel on PyTorch's current stream.
    q: (B,H,Dh), k/v: (B,T,KV,Dh), contiguous on one CUDA device; length:
    int, 0-d or (B,) tensor."""
    what = "decode_attention_fwd"
    _build.check_tensors(what, q, (("q", q), ("k", k), ("v", v)), q.dtype)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    _check_heads(what, q, KV, k.shape[3])
    if T == 0 or B > 65535 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{what}: empty cache, batch {B} above 65535, or k/v "
                         f"not 16-byte aligned (the kernel copies 16-byte chunks)")
    lens = lengths_for(length, B, T, q.device)
    o = torch.empty_like(q)
    _build.launch("repro_decode_attention_fwd", what, q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), lens.data_ptr(), o.data_ptr(), B, T, H, KV, Dh,
                  _build.DTYPES[q.dtype])
    return o


def check_paged_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor) -> None:
    """Raise on anything the paged kernel does not take, but for shared
    memory: the launch itself raises where a page of K/V does not fit.  The
    page table's entries are not read here (that would wait for the
    device): they must be valid pool indices, which the serving cache
    guarantees."""
    what = "paged_decode_attention_fwd"
    _build.check_tensors(what, q, (("q", q), ("k_pages", k_pages),
                                   ("v_pages", v_pages)), q.dtype)
    _build.check_tensors(what, q, (("page_table", page_table),
                                   ("lengths", lengths)), torch.int32)
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}")
    B = q.shape[0]
    _, page, KV, Dk = k_pages.shape
    _check_heads(what, q, KV, Dk)
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"{what}: q {tuple(q.shape)}, page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not fit together")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{what}: the pools must be 16-byte aligned (the kernel "
                         f"copies 16-byte chunks)")
    if page > MAX_PAGE:
        raise ValueError(f"{what}: page {page} above {MAX_PAGE}")


def paged_decode_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Launch the paged CUDA kernel on PyTorch's current stream.
    q: (B,H,Dh); k/v_pages: (P,page,KV,Dh); page_table (B,maxp) and
    lengths (B,) int32; all contiguous on one CUDA device."""
    check_paged_inputs(q, k_pages, v_pages, page_table, lengths)
    B, H, Dh = q.shape
    _, page, KV, _ = k_pages.shape
    o = torch.empty_like(q)
    _build.launch("repro_paged_decode_attention_fwd", "paged_decode_attention_fwd",
                  q, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  page_table.data_ptr(), lengths.data_ptr(), o.data_ptr(), B, H, KV,
                  Dh, page, page_table.shape[1], _build.DTYPES[q.dtype])
    return o
