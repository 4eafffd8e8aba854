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

Both share one body, ``csrc/decode_attention.cuh``.  At serving shapes it
is not bound by memory: a B=8 step reads a few MB of K/V, under a
microsecond of HBM time, and one block per (request, KV head) would leave
most of the 132 SMs idle while each block walked its request alone.  So
the body splits each request's walk across blocks (flash-decoding): the
grid is (KV heads × m-tiles of 16 query heads, B, splits), each block
scores one contiguous range of whole tiles on the tensor cores (bf16), and
a second kernel combines the blocks' fp32 partials (m, l, acc) by
log-sum-exp in split order.  :func:`decode_splits` chooses the split count
from static shapes only — never from the lengths, which would wait for
the device — and :func:`split_plan` memoizes it with the cut per shape;
the partials live in ``_build.workspace``, a ``torch.empty`` kept per
(device, stream, thread), so a call in the decode loop makes no allocator
call and no sync.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 128      # csrc: query heads per KV head, 8 m-tiles of 16
DENSE_TILE = 64      # csrc: the dense cache's split granule (tokens)
CHUNK = 64           # csrc: tokens a block scores per step (4 warps × 16)
BLOCKS_PER_SM = 2    # the split chooser's aim


def decode_splits(B: int, KV: int, extent_tiles: int, sm_count: int, tile: int,
                  group: int) -> int:
    """How many blocks share one request's walk over ``extent_tiles`` tiles
    of ``tile`` tokens (pages, or ``DENSE_TILE`` tokens of a dense cache).

    From static shapes only: about ``BLOCKS_PER_SM`` blocks per SM over the
    grid of B × KV × ⌈group / 16⌉ blocks per split (``group``: query heads
    per KV head), no split shorter than one chunk of ``CHUNK`` tokens where
    the extent allows, and no split left empty by the extent (see
    :func:`split_ranges`)."""
    blocks = B * KV * -(-group // 16)
    want = max(1, BLOCKS_PER_SM * sm_count // blocks)
    most = max(1, extent_tiles // -(-CHUNK // tile))
    splits = min(want, most)
    return -(-extent_tiles // tiles_per_split(extent_tiles, splits))


def tiles_per_split(extent_tiles: int, splits: int) -> int:
    """The split cut: ⌈extent / splits⌉ tiles per split, the last split what
    is left.  The launchers pass it to the kernel, which has no cut of its
    own."""
    return -(-extent_tiles // splits)


def split_ranges(extent_tiles: int, splits: int) -> List[Tuple[int, int]]:
    """The tile range [start, end) each split walks."""
    tps = tiles_per_split(extent_tiles, splits)
    return [(s * tps, min((s + 1) * tps, extent_tiles)) for s in range(splits)]


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of a CUDA device (what :func:`decode_splits` is given)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def split_plan(B: int, KV: int, extent_tiles: int, tile: int, group: int,
               device_index: int) -> Tuple[int, int]:
    """(splits, tiles per split) of a launch on CUDA device ``device_index``,
    memoized per static shape: a call in the decode loop does no split
    arithmetic and no device query."""
    splits = decode_splits(B, KV, extent_tiles, sm_count(device_index), tile, group)
    return splits, tiles_per_split(extent_tiles, splits)


def _workspace_arg(splits: int):
    """The partials' scratch pointer (:data:`_build.WORKSPACE`), or a null
    pointer for one split, which writes the output itself."""
    return _build.WORKSPACE if splits > 1 else None


def _workspace_floats(B: int, H: int, Dh: int, splits: int) -> int:
    """The splits' fp32 partials: acc (Dh) and (m, l) per (row, split)."""
    return B * H * splits * (Dh + 2) if splits > 1 else 0


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
    lens = length
    if not (torch.is_tensor(length) and length.dtype == torch.int32
            and tuple(length.shape) == (B,) and length.device == q.device
            and length.is_contiguous()):
        lens = lengths_for(length, B, T, q.device)
    # else as it is, with no clamp kernel: the kernel clamps to T itself
    splits, tps = split_plan(B, KV, -(-T // DENSE_TILE), DENSE_TILE, H // KV,
                             q.get_device())
    o = torch.empty_like(q)
    _build.launch("repro_decode_attention_fwd", what, q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), lens.data_ptr(), _workspace_arg(splits), o.data_ptr(),
                  B, T, H, KV, Dh, splits, tps, _build.DTYPES[q.dtype],
                  ws_floats=_workspace_floats(B, H, Dh, splits))
    return o


def check_paged_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor) -> None:
    """Raise on anything the paged kernel does not take.  The page table's
    entries are not read here (that would wait for the device): they must
    be valid pool indices, which the serving cache guarantees."""
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
    if B > 65535 or page_table.shape[1] == 0 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError(f"{what}: batch {B} above 65535, an empty page table, or "
                         f"pools not 16-byte aligned (the kernel copies 16-byte "
                         f"chunks)")


def paged_decode_attention_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Launch the paged CUDA kernel on PyTorch's current stream.
    q: (B,H,Dh); k/v_pages: (P,page,KV,Dh); page_table (B,maxp) and
    lengths (B,) int32; all contiguous on one CUDA device."""
    check_paged_inputs(q, k_pages, v_pages, page_table, lengths)
    B, H, Dh = q.shape
    _, page, KV, _ = k_pages.shape
    maxp = page_table.shape[1]
    splits, tps = split_plan(B, KV, maxp, page, H // KV, q.get_device())
    o = torch.empty_like(q)
    _build.launch("repro_paged_decode_attention_fwd", "paged_decode_attention_fwd", q,
                  q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  page_table.data_ptr(), lengths.data_ptr(), _workspace_arg(splits),
                  o.data_ptr(), B, H, KV, Dh, page, maxp, splits, tps,
                  _build.DTYPES[q.dtype], ws_floats=_workspace_floats(B, H, Dh, splits))
    return o
