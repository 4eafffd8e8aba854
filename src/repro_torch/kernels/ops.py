"""Public wrappers around the kernels: the port's counterpart of the
reference's single-source kernel API, ``repro.kernels.ops``.

Each of the six kernels is a torch op under the ``repro_torch::``
namespace (``torch.ops.repro_torch.flash_attention`` …), defined through
``torch.library.Library``, the counterpart of the abstract evaluation a
``pallas_call`` has in JAX.  Each op has

- a CUDA implementation: the hand-written Hopper kernel, which counts its
  launch (:func:`launch_counts`);
- a CPU implementation: the kernel's plain PyTorch version, not counted;
- a fake implementation (``register_fake``): output shapes and dtypes
  only, so a step traces under ``FakeTensorMode`` (``launch/dryrun.py``)
  with no kernel launched and no count moved;
- a FLOP formula (``torch.utils.flop_counter``, :data:`FLOP_FORMULAS`)
  that counts what the kernel table's bounds count: flash the unmasked
  (causal, windowed) pairs, all S² without a mask; the decode kernels the
  live K/V rows (every row of the extent where the lengths are fake); the
  SSD the least of its three ways (:func:`ssd_flops`).

Torch's dispatch picks the implementation by device, so any other device
raises and there is no fallback from one to the other.

Gradients: a kernel writes its output from outside autograd, so no
wrapper of a bare kernel may be differentiated.  Each raises a
``RuntimeError`` naming the missing backward when grad mode is on and an
input requires grad — on both devices, so the CPU (whose plain versions
autograd could differentiate) and the card never disagree.  Training goes
through the ``*_trainable`` ops, each a ``torch.autograd.Function`` whose
forward is the op:
:func:`flash_attention_trainable` with
:func:`~repro_torch.kernels.flash_attention.flash_attention_bwd`,
:func:`ssd_scan_trainable`, whose backward differentiates the plain
chunked form, and :func:`rglru_scan_trainable`, whose backward is the
same recurrence run in reverse through the kernel again.

The wrappers keep the reference's shapes and semantics but drop its TPU
tile arguments (``block_q``, ``block_k``, ``block_s``, ``block_w``,
``block``) and ``interpret``: the tiles never changed a result, and the
kernels here choose their own.

Every entry point takes plain tensors only: a DTensor raises on either
device, since a kernel reads raw device pointers and the plain version
would otherwise run as distributed math.  Mesh code reaches a kernel
through ``local_map``, with each rank's local shard
(``models/layers.py::on_shards``).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                  decode_attention_plain, lengths_for,
                                                  paged_decode_attention_fwd,
                                                  paged_decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd,
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


def _plain_only(what: str, *tensors: torch.Tensor) -> None:
    """A DTensor has no ``data_ptr``, and its plain-version ops would run
    as distributed math: each kernel takes plain (local) tensors only.
    Mesh code calls a kernel through ``local_map`` (``models/layers.py``).
    A tensor on neither the card nor the CPU (a meta tensor) has no
    implementation to run either: it raises rather than reach the op's
    fake implementation, which only ``FakeTensorMode`` uses."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what} takes plain tensors; a DTensor reaches a "
                        f"kernel only through local_map, as its local shard")
    dev = tensors[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no kernel for device {dev}")


def _no_backward(what: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would differentiate a kernel that has no
    backward (its output would carry no gradient on the card)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: its kernel writes the output outside "
            f"autograd, so the gradient would be lost; call it under "
            f"torch.no_grad() or torch.inference_mode()")


# ------------------------------------------------------------------ the ops
# Defined through ``torch.library.Library``: the dispatcher calls each
# implementation directly.  ``torch.library.custom_op`` adds a Python
# layer a call, which cost the host-bound paged decode step of phase 5
# ~12 ms on the card (``chip_pair.py --serve``; PERF.md §6).
_LIB = torch.library.Library("repro_torch", "DEF")


def _define(schema: str, cpu, cuda, fake):
    """Define ``repro_torch::<schema>`` with its CPU (plain version), CUDA
    (the kernel, counted) and fake (shapes only) implementations; → the
    op overload."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    return getattr(torch.ops.repro_torch, name).default


def _flash_cuda(q, k, v, causal, window, valid_len):
    o = flash_attention_fwd(q, k, v, causal=causal, window=window, valid_len=valid_len)
    _count("flash_attention")
    return o


_flash_op = _define(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window, "
    "int valid_len) -> Tensor",
    lambda q, k, v, causal, window, valid_len: flash_attention_plain(
        q, k, v, causal=causal, window=window, valid_len=valid_len),
    _flash_cuda, lambda q, k, v, causal, window, valid_len: torch.empty_like(q))


def _decode_cuda(q, k, v, lengths):
    o = decode_attention_fwd(q, k, v, lengths)
    _count("decode_attention")
    return o


_decode_op = _define(
    "decode_attention(Tensor q, Tensor k, Tensor v, Tensor lengths) -> Tensor",
    decode_attention_plain, _decode_cuda, lambda q, k, v, lengths: torch.empty_like(q))


def _paged_cuda(q, k_pages, v_pages, page_table, lengths):
    o = paged_decode_attention_fwd(q, k_pages, v_pages, page_table, lengths)
    _count("paged_decode_attention")
    return o


_paged_op = _define(
    "paged_decode_attention(Tensor q, Tensor k_pages, Tensor v_pages, "
    "Tensor page_table, Tensor lengths) -> Tensor",
    paged_decode_attention_plain, _paged_cuda, lambda q, *_: torch.empty_like(q))


def _no_state(x: torch.Tensor) -> torch.Tensor:
    """The SSD op's second output where no final state was asked for."""
    return x.new_empty((0,), dtype=torch.float32)


def _ssd_cpu(x, dt, A, Bm, Cm, chunk, return_final_state):
    out = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                         return_final_state=return_final_state)
    return out if return_final_state else (out, _no_state(x))


def _ssd_cuda(x, dt, A, Bm, Cm, chunk, return_final_state):
    out = ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=return_final_state)
    _count("ssd_scan")
    return out if return_final_state else (out, _no_state(x))


def _ssd_fake(x, dt, A, Bm, Cm, chunk, return_final_state):
    B, _, H, P = x.shape
    state = (x.new_empty((B, H, P, Bm.shape[3]), dtype=torch.float32)
             if return_final_state else _no_state(x))
    return torch.empty_like(x), state


_ssd_op = _define(
    "ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, int chunk, "
    "bool return_final_state) -> (Tensor, Tensor)", _ssd_cpu, _ssd_cuda, _ssd_fake)


def _rglru_cuda(a, b):
    h = rglru_scan_fwd(a, b)
    _count("rglru_scan")
    return h


_rglru_op = _define("rglru_scan(Tensor a, Tensor b) -> Tensor", rglru_scan_plain,
                    _rglru_cuda, lambda a, b: torch.empty_like(a))


def _triad_cuda(a, b, alpha):
    o = stream_triad_fwd(a, b, alpha)
    _count("stream_triad")
    return o


_triad_op = _define("stream_triad(Tensor a, Tensor b, float alpha) -> Tensor",
                    stream_triad_plain, _triad_cuda, lambda a, b, alpha: torch.empty_like(a))


# ---------------------------------------------------------- FLOP formulas
def flash_pairs(S: int, causal: bool, window: int = 0, valid_len: int = 0) -> int:
    """The (query, key) pairs flash attention leaves unmasked: every key
    below ``valid_len`` (0 means S), at or before the query when causal,
    and after ``query − window`` when windowed (the kernel's masks)."""
    K = valid_len if 0 < valid_len < S else S
    if window <= 0 and K == S:
        return S * (S + 1) // 2 if causal else S * S
    if window <= 0 and not causal:
        return S * K
    return sum(max(0, (min(i + 1, K) if causal else K)
                   - (max(0, i - window + 1) if window > 0 else 0)) for i in range(S))


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int, dtype: str,
              final: bool = False) -> Tuple[Dict[str, int], Dict[str, Dict[str, int]]]:
    """The SSD's operations, {dtype: flops}, by the cheapest of three ways
    to compute it at the H100's peak rates (bf16 989e12, fp32 67e12), and
    all three.  The recurrence: per step and head, decay the fp32 (N, P)
    state, add dt·x ⊗ B and read C·state: 5·N·P flops, fp32.  The chunked
    dual form: C·Bᵀ over j ≤ i in the input dtype, then scores·x, the
    carried state's C·S (no chunk but the first has one) and the state
    update (no chunk but the last feeds one) in fp32.  The kernel's: the
    same products, an operand split into bf16 hi + lo counting twice.
    ``final``: the call also returns the state after step S."""
    recurrence = {"float32": 5 * N * P * S * H * B}
    cb = sx = cs = st = 0
    starts = range(0, S, chunk)
    for c, t0 in enumerate(starts):
        q = min(chunk, S - t0)
        cb += q * (q + 1) // 2 * N * 2
        sx += q * (q + 1) // 2 * P * 2
        cs += q * N * P * 2 if c > 0 else 0
        st += q * N * P * 2 if final or c < len(starts) - 1 else 0
    dual = {dtype: B * H * cb}
    dual["float32"] = dual.get("float32", 0) + B * H * (sx + cs + st)
    split = 2 if dtype == "bfloat16" else 1
    kernel = {dtype: B * H * (cb + split * (sx + cs + st))}
    ways = {"recurrence": recurrence, "chunked": dual, "kernel": kernel}
    peak = {"bfloat16": 989e12, "float32": 67e12, "float16": 989e12}
    return (min(ways.values(), key=lambda f: sum(n / peak[d] for d, n in f.items())),
            ways)


def _live_rows(lengths: torch.Tensor, extent: int) -> int:
    """Σ min(length, extent) over the rows, or every row's whole extent
    where the lengths have no data (a fake or meta tensor)."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(lengths) or lengths.device.type == "meta":
        return lengths.numel() * extent
    return int(lengths.long().clamp(0, extent).sum())


def _flash_flops(q, k, v, causal, window, valid_len, *_, out_shape=None, **__):
    B, S, H, Dh = q
    return int(4 * Dh * H * B * flash_pairs(S, causal, window, valid_len))


def _decode_flops(q, k, v, lengths, *_, out_val=None, **__):
    B, H, Dh = q.shape
    return 4 * Dh * H * _live_rows(lengths, k.shape[1])


def _paged_flops(q, k_pages, v_pages, page_table, lengths, *_, out_val=None, **__):
    B, H, Dh = q.shape
    return 4 * Dh * H * _live_rows(lengths, page_table.shape[1] * k_pages.shape[1])


def _ssd_op_flops(x, dt, A, Bm, Cm, chunk, return_final_state, *_, out_val=None, **__):
    """Raw (tensor) arguments, so that the count follows x's dtype: an fp32
    call's C·Bᵀ is fp32 work, as phase 3's bounds count it."""
    B, S, H, P = x.shape
    flops, _ways = ssd_flops(B, S, H, P, Bm.shape[3], min(chunk, S),
                             str(x.dtype).removeprefix("torch."), final=return_final_state)
    return int(sum(flops.values()))


def _rglru_flops(a, b, *_, out_shape=None, **__):
    return 2 * math.prod(a)


def _triad_flops(a, b, alpha, *_, out_shape=None, **__):
    return 2 * math.prod(a)


FLOP_FORMULAS = {
    "flash_attention": register_flop_formula(torch.ops.repro_torch.flash_attention)(
        _flash_flops),
    "decode_attention": register_flop_formula(torch.ops.repro_torch.decode_attention,
                                              get_raw=True)(_decode_flops),
    "paged_decode_attention": register_flop_formula(
        torch.ops.repro_torch.paged_decode_attention, get_raw=True)(_paged_flops),
    "ssd_scan": register_flop_formula(torch.ops.repro_torch.ssd_scan,
                                      get_raw=True)(_ssd_op_flops),
    "rglru_scan": register_flop_formula(torch.ops.repro_torch.rglru_scan)(_rglru_flops),
    "stream_triad": register_flop_formula(torch.ops.repro_torch.stream_triad)(_triad_flops),
}
"""{kernel: its op's FLOP formula}, as ``FlopCounterMode`` calls it."""

OPS = {"flash_attention": _flash_op, "decode_attention": _decode_op,
       "paged_decode_attention": _paged_op, "ssd_scan": _ssd_op, "rglru_scan": _rglru_op,
       "stream_triad": _triad_op}
"""{kernel: its ``repro_torch::`` op overload}."""


# ----------------------------------------------------------------- wrappers
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    valid_len: int = 0) -> torch.Tensor:
    """q: (B,S,H,Dh), k/v: (B,S,KV,Dh) → (B,S,H,Dh). GQA via H % KV == 0.
    ``valid_len`` (0 means S) masks K positions at or past it.  Forward
    only: :func:`flash_attention_trainable` is the differentiable op."""
    _plain_only("flash_attention", q, k, v)
    _no_backward("flash_attention (use flash_attention_trainable)", q, k, v)
    return _flash_op(q, k, v, causal, window, valid_len)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length) -> torch.Tensor:
    """One-token decode over a dense cache.

    q: (B,H,Dh), k/v: (B,T,KV,Dh) → (B,H,Dh).  ``length`` is the valid
    cache prefix: an int or 0-d tensor (uniform fill) or a (B,) tensor
    (every slot at its own depth), clamped to T.  A slot of length 0 gives
    zeros, as the reference's kernel does.  The kernel reads each K/V head
    once for its G query heads; nothing is repeated or padded."""
    _plain_only("decode_attention", q, k, v)
    _no_backward("decode_attention", q, k, v)
    B, T = q.shape[0], k.shape[1]
    if not (torch.is_tensor(length) and length.dtype == torch.int32
            and tuple(length.shape) == (B,) and length.device == q.device):
        length = lengths_for(length, B, T, q.device)
    return _decode_op(q, k, v, length)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Paged decode over a block-pool KV cache.

    q: (B,H,Dh); k_pages/v_pages: (P, page, KV, Dh); page_table: (B, maxp)
    int32 (entries past the fill must be valid pool indices, e.g. 0);
    lengths: (B,) int32 → (B,H,Dh).  The kernel walks each request's own
    page list; no dense gather."""
    _plain_only("paged_decode_attention", q, k_pages, v_pages, page_table, lengths)
    _no_backward("paged_decode_attention", q, k_pages, v_pages)
    return _paged_op(q, k_pages, v_pages, page_table, lengths)


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
    _plain_only("ssd_scan", x, dt, A, Bm, Cm)
    _no_backward("ssd_scan", x, dt, A, Bm, Cm)
    y, state = _ssd_op(x, dt, A, Bm, Cm, min(chunk, x.shape[1]), return_final_state)
    return (y, state) if return_final_state else y


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t from h_0 = 0, fp32 carry.
    a/b: (B,S,W) → (B,S,W) in a's dtype."""
    _plain_only("rglru_scan", a, b)
    _no_backward("rglru_scan", a, b)
    return _rglru_op(a, b)


def stream_triad(a: torch.Tensor, b: torch.Tensor, alpha: float = 3.0) -> torch.Tensor:
    """STREAM triad a + alpha·b over (N,), rounded as ``a + alpha * b``."""
    _plain_only("stream_triad", a, b)
    _no_backward("stream_triad", a, b)
    return _triad_op(a, b, float(alpha))


class _FlashTrainable(torch.autograd.Function):
    """The flash kernel forward (counted as a launch) with
    :func:`flash_attention_bwd` as its backward; saves only q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, do, ctx.causal, ctx.window),
                None, None)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Training-path flash attention: the kernel forward (the plain version
    on CPU tensors, as :func:`flash_attention`) and an exact backward that
    recomputes P, as the reference's ``flash_attention_trainable``.
    q: (B,S,H,Dh), k/v: (B,S,KV,Dh) → (B,S,H,Dh).  Outside grad mode it
    records nothing, so serving pays nothing for it."""
    _plain_only("flash_attention_trainable", q, k, v)
    return _FlashTrainable.apply(q, k, v, causal, window)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, dy: torch.Tensor, chunk: int = 256,
                 needs=(True,) * 5) -> Tuple[Optional[torch.Tensor], ...]:
    """The SSD scan's backward: (dx, ddt, dA, dBm, dCm) for the cotangent
    ``dy`` of y, by autograd through :func:`ssd_scan_plain` (the chunked
    dual form, every chunk at once) recomputed from the inputs, as the
    reference differentiates its jnp ``ssd_chunked``.  PyTorch math on
    either device (the reference has no backward kernel); ``needs`` picks
    the gradients to take (the others come back None)."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip((x, dt, A, Bm, Cm), needs)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        y = ssd_scan_plain(*inputs, chunk=min(chunk, x.shape[1]))
        got = iter(torch.autograd.grad(y, wanted, dy))
    return tuple(next(got) if t.requires_grad else None for t in inputs)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU scan's backward: (da, db) for the cotangent ``dh`` of
    h_t = a_t·h_{t−1} + b_t, from a and the forward's h.  The cotangent
    g_t = dh_t + a_{t+1}·g_{t+1} is the same recurrence over the flipped
    sequence with a shifted by one step (0 past the end), so it is one more
    :func:`rglru_scan` (a launch on the card); then db = g and
    da_t = g_t·h_{t−1}."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = rglru_scan(a_next.flip(1), dh.to(a.dtype).flip(1)).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


class _SSDTrainable(torch.autograd.Function):
    """The SSD kernel forward (counted) with :func:`ssd_scan_bwd`; saves
    the inputs.  The final state is an output without a gradient:
    training never reads it."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, return_final_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        out = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                       return_final_state=return_final_state)
        if return_final_state:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, dy, *_):
        return (*ssd_scan_bwd(*ctx.saved_tensors, dy, ctx.chunk,
                              needs=ctx.needs_input_grad[:5]), None, None)


def ssd_scan_trainable(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                       return_final_state: bool = False):
    """Training-path SSD scan: :func:`ssd_scan`'s shapes and results, with
    a backward for x, dt, A, Bm and Cm (the final state carries none)."""
    _plain_only("ssd_scan_trainable", x, dt, A, Bm, Cm)
    return _SSDTrainable.apply(x, dt, A, Bm, Cm, chunk, return_final_state)


class _RGLRUTrainable(torch.autograd.Function):
    """The RG-LRU kernel forward (counted) with :func:`rglru_scan_bwd`;
    saves a and h."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        return rglru_scan_bwd(*ctx.saved_tensors, dh)


def rglru_scan_trainable(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Training-path RG-LRU scan: :func:`rglru_scan`'s shapes and result,
    with a backward for a and b."""
    _plain_only("rglru_scan_trainable", a, b)
    return _RGLRUTrainable.apply(a, b)


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
