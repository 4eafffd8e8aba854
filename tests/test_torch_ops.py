"""The port's dense decode, SSD scan, RG-LRU scan and STREAM triad (their
plain versions, as ``repro_torch.kernels.ops`` runs them for CPU tensors)
against the reference's ``repro.kernels.ops`` in interpret mode and its
oracles ``repro.kernels.ref``, over the sweeps of ``test_kernels.py``; and
the scan kernels' plans (``ssd_plan``, ``rglru_plan``) and their passes,
written out in plain PyTorch as the plans cut them, against the same
oracles.

Inputs are drawn with numpy from a seed and handed to both packages; bf16
inputs are rounded from the same fp32 draws on both sides.  Tolerances
are those of ``test_kernels.py`` (``_tol``: 2e-5 fp32, 2e-2 bf16):
``_tol`` × 4 for decode attention and the RG-LRU scan, ``_tol`` × 8 with
rtol 1e-2 for the SSD scan (other summation orders, outputs rounded to
bf16 on each side), ``_tol`` for the triad in fp32, and bit equality for
the triad in bf16 (both sides round the product, then the sum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rglru_scan import CHUNK as RGLRU_CHUNK
from repro_torch.kernels.rglru_scan import THREADS as RGLRU_THREADS
from repro_torch.kernels.rglru_scan import rglru_plan
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.ssd_scan import (MAX_GRID_YZ, PASS_THREADS, ROW_TILE, check_ssd_args,
                                          ssd_plan, ssd_scan_plain)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def _pair(x: np.ndarray, name: str):
    jd, td = DTYPES[name]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(port: torch.Tensor, want, atol: float, rtol: float = 0.0):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _decode_inputs(B, T, H, KV, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s, np.float32), dtype)
            for s in ((B, H, Dh), (B, T, KV, Dh), (B, T, KV, Dh))]


# ------------------------------------------------------------ dense decode
@pytest.mark.parametrize("B,T,H,KV,Dh,length", [
    (2, 512, 4, 2, 64, 300),
    (1, 1024, 8, 8, 32, 1024),
    (3, 300, 4, 1, 64, 17),   # the reference pads T; MQA, short fill
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(B, T, H, KV, Dh, length, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(B, T, H, KV, Dh, dtype, 2)
    o = ops.decode_attention(qt, kt, vt, torch.tensor(length))
    assert o.shape == (B, H, Dh) and o.dtype == qt.dtype
    _close(o, rops.decode_attention(qj, kj, vj, jnp.asarray(length)), _tol(dtype) * 4)
    _close(o, rref.decode_mha(qj, kj, vj, length=length), _tol(dtype) * 4)
    # an int length is the same scalar
    assert torch.equal(ops.decode_attention(qt, kt, vt, length), o)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_per_row_lengths(dtype):
    """A (B,) length masks each row at its own depth, as the reference's
    per-row fix does; the scalar at max(lens) differs on short rows."""
    B, T, H, KV, Dh = 4, 256, 4, 2, 64
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(B, T, H, KV, Dh, dtype, 7)
    lens = np.asarray([1, 17, 100, 256], np.int32)
    o = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    _close(o, rops.decode_attention(qj, kj, vj, jnp.asarray(lens)), _tol(dtype) * 4)
    _close(o, rref.decode_mha(qj, kj, vj, length=jnp.asarray(lens)), _tol(dtype) * 4)
    o_scalar = ops.decode_attention(qt, kt, vt, torch.tensor(256))
    assert not np.allclose(o.float().numpy()[0], o_scalar.float().numpy()[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_length_zero_gives_zeros(dtype):
    """A row of length 0 gives zeros, as the reference's kernel does (no
    block passes k_start < length, and acc / max(l, 1e-20) = 0); the
    oracle ``ref.decode_mha`` would give NaN there."""
    B, T, H, KV, Dh = 3, 256, 4, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(B, T, H, KV, Dh, dtype, 11)
    lens = np.asarray([0, 5, 256], np.int32)
    o = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    want = rops.decode_attention(qj, kj, vj, jnp.asarray(lens))
    assert np.all(np.asarray(want[0], np.float32) == 0)
    assert torch.all(o[0] == 0)
    _close(o, want, _tol(dtype) * 4)


@pytest.mark.parametrize("length", [301, 2000])
def test_decode_attention_length_above_cache_is_clamped(length):
    B, T, H, KV, Dh = 2, 300, 4, 1, 64
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(B, T, H, KV, Dh, "float32", 12)
    o = ops.decode_attention(qt, kt, vt, length)
    _close(o, rops.decode_attention(qj, kj, vj, jnp.asarray(length)), 2e-5 * 4)
    assert torch.equal(o, ops.decode_attention(qt, kt, vt, T))
    lens = torch.tensor([length, 7], dtype=torch.int32)
    _close(ops.decode_attention(qt, kt, vt, lens),
           rops.decode_attention(qj, kj, vj, jnp.asarray(lens.numpy())), 2e-5 * 4)


# ---------------------------------------------------------------- SSD scan
def _ssd_inputs(B, S, H, P, G, N, dtype, seed, steep=False, dt_fp32=False):
    """``dt_fp32``: dt in fp32 whatever the dtype, as the Mamba-2 block
    feeds it (a softplus in fp32 beside bf16 x, B and C)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), np.float32)))
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    if steep:  # dt·A in [−65, −55] at every step
        dt = 55.0 + 10.0 * rng.random((B, S, H), np.float32)
        A = -np.ones(H, np.float32)
    Bm = rng.standard_normal((B, S, G, N), np.float32) * 0.3
    Cm = rng.standard_normal((B, S, G, N), np.float32) * 0.3
    return (_pair(x, dtype), _pair(dt.astype(np.float32), "float32" if dt_fp32 else dtype),
            (jnp.asarray(A), torch.from_numpy(A)), _pair(Bm, dtype), _pair(Cm, dtype))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 128, 2, 16, 1, 16, 32),
    (2, 96, 4, 16, 2, 32, 32),   # groups of heads
    (1, 100, 2, 8, 2, 16, 64),   # ragged last chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_reference(B, S, H, P, G, N, chunk, dtype):
    args = _ssd_inputs(B, S, H, P, G, N, dtype, 3)
    jx, tx = zip(*args)
    y = ops.ssd_scan(*tx, chunk=chunk)
    assert y.shape == (B, S, H, P) and y.dtype == tx[0].dtype
    tol = dict(atol=_tol(dtype) * 8, rtol=1e-2)
    _close(y, rops.ssd_scan(*jx, chunk=chunk), **tol)
    want, want_state = rref.ssd(*jx)
    _close(y, want, **tol)
    # the port's sequential oracle, final state included
    got, got_state = ref.ssd(*tx)
    _close(got, want, **tol)
    _close(got_state, want_state, **tol)


def test_ssd_scan_steep_decay_stays_finite():
    """dt·A ≈ −60 per step: exp(cum_i − cum_j) for j > i would overflow;
    the scan must form it only for j ≤ i and stay finite."""
    B, S, H, P, G, N = 1, 128, 2, 16, 1, 16
    jx, tx = zip(*_ssd_inputs(B, S, H, P, G, N, "float32", 13, steep=True))
    y = ops.ssd_scan(*tx, chunk=64)
    assert torch.isfinite(y).all()
    _close(y, rops.ssd_scan(*jx, chunk=64), atol=2e-5 * 8, rtol=1e-2)
    _close(y, rref.ssd(*jx)[0], atol=2e-5 * 8, rtol=1e-2)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 512, 4, 64, 128, 256),     # S on a chunk edge
    (1, 511, 4, 64, 128, 256),     # ... and one off it on either side
    (1, 513, 4, 64, 128, 256),
    (1, 100, 2, 8, 16, 256),       # S < chunk: one chunk, no state pass
    (2, 300, 48, 64, 128, 40),     # B > 1; a chunk off 16, a ragged last chunk
    (3, 2048, 48, 64, 128, 256),   # mamba2_780m's widths, B = 3
    (1, 8192, 48, 64, 128, 256),   # 32 chunks through the state pass
])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_ssd_plan_covers_every_step(B, S, H, P, N, chunk, bf16, final):
    """``ssd_plan`` against the kernel's cut: the chunks cover S once (the
    last one ragged, never empty); the state pass covers every (n, p); the
    output blocks cover every row of every chunk once (fp32: 64-row tiles,
    heavy first; bf16: one block a chunk whose 8 warps take the 16-row
    tiles in pairs (w, 15 − w), none walking more than 17 column tiles);
    and the scratch holds the states, cum_end, cum and (bf16) S_in's hi and
    lo planes from a 16-byte boundary.  With the final state the state pass
    runs for one chunk too."""
    plan = ssd_plan(B, S, H, P, N, chunk, bf16, final)
    C = plan.chunks
    steps = [t for c in range(C) for t in range(c * chunk, min((c + 1) * chunk, S))]
    assert steps == list(range(S)) and 0 < S - (C - 1) * chunk <= chunk
    assert plan.grids[0] == (C, H, B) and plan.grids[-1][1:] == (H, B)
    assert len(plan.grids) == (3 if C > 1 or final else 2)
    if C > 1 or final:
        blocks = plan.grids[1][0]
        assert plan.grids[1][1:] == (H, B)
        assert blocks * PASS_THREADS >= N * P > (blocks - 1) * PASS_THREADS
    assert all(g[1] <= MAX_GRID_YZ and g[2] <= MAX_GRID_YZ for g in plan.grids)
    assert plan.grids[-1][0] == plan.out_blocks * C
    for c in range(C):
        Qc = min(chunk, S - c * chunk)
        rows = []
        if bf16:
            assert plan.out_blocks == 1 and Qc <= 16 * 16
            for w in range(8):
                tiles = [t for t in (w, 15 - w) if 16 * t < Qc]
                assert sum(t + 1 for t in tiles) <= 17  # column tiles j ≤ i walked
                rows += [i for t in tiles for i in range(16 * t, min(16 * t + 16, Qc))]
        else:
            tiles = plan.out_blocks
            for x in range(c * tiles, (c + 1) * tiles):  # blockIdx.x → (chunk, row tile)
                assert x // tiles == c
                rt = tiles - 1 - x % tiles
                rows += list(range(ROW_TILE * rt, min(ROW_TILE * rt + ROW_TILE, Qc)))
        assert sorted(rows) == list(range(Qc))
    assert plan.state_floats == B * H * C * N * P
    planes_at = -(-(plan.state_floats + B * H * (C + S)) // 4) * 4
    assert planes_at % 4 == 0
    assert plan.ws_floats == planes_at + (plan.state_floats if bf16 else 0)


def _ssd_three_passes(x, dt, A, Bm, Cm, chunk, final=False):
    """The kernel's three passes in plain PyTorch, fp32, as ``ssd_plan``
    cuts them: every chunk's cumsum and local state, the walk that turns
    them into the states entering each chunk, then every chunk's outputs
    with exp(cum_i − cum_j) formed for j ≤ i only.  ``final``: also the
    final state as the state pass forms it, S_in(last)·exp(cum_end(last))
    + s(last), with cum_end at the last real step, as (B, H, P, N)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    plan = ssd_plan(B, S, H, P, N, chunk, x.dtype == torch.bfloat16)
    heads = torch.arange(H) // (H // G)  # the group of each head
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float()[:, :, heads], Cm.float()[:, :, heads]
    cuts = [slice(c * chunk, min((c + 1) * chunk, S)) for c in range(plan.chunks)]
    cums, local = [], []
    for sl in cuts:  # pass 1
        cum = torch.cumsum(dtf[:, sl] * A[None, None, :], dim=1)   # (B, Qc, H)
        w = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]
        cums.append(cum)
        local.append(torch.einsum("bjh,bjhn,bjhp->bhnp", w, Bf[:, sl], xf[:, sl]))
    s_in = [torch.zeros(B, H, N, P)]  # pass 2: chunk c reads the state entering it
    for c in range(1, plan.chunks):
        s_in.append(s_in[-1] * torch.exp(cums[c - 1][:, -1])[..., None, None] + local[c - 1])
    ys = []
    for sl, cum, s in zip(cuts, cums, s_in):  # pass 3
        Qc = cum.shape[1]
        below = torch.ones(Qc, Qc, dtype=torch.bool).tril()[None, :, :, None]  # j ≤ i
        diff = cum[:, :, None, :] - cum[:, None, :, :]                        # (B, i, j, H)
        decay = torch.where(below, diff, torch.tensor(-torch.inf)).exp()
        scores = torch.einsum("bihn,bjhn->bijh", Cf[:, sl], Bf[:, sl]) * decay \
            * dtf[:, sl][:, None]
        ys.append(torch.einsum("bijh,bjhp->bihp", scores, xf[:, sl])
                  + torch.exp(cum)[..., None] * torch.einsum("bihn,bhnp->bihp", Cf[:, sl], s))
    y = torch.cat(ys, dim=1).to(x.dtype)
    if not final:
        return y
    last = s_in[-1] * torch.exp(cums[-1][:, -1])[..., None, None] + local[-1]
    return y, last.transpose(-1, -2)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,steep", [
    (1, 128, 2, 16, 1, 16, 32, False),   # 4 chunks, S on their edge
    (1, 127, 2, 16, 1, 16, 32, False),   # ... and one off it on either side
    (1, 129, 2, 16, 1, 16, 32, False),
    (2, 100, 4, 8, 2, 16, 40, False),    # B > 1, G = 2, chunk off 16, ragged end
    (1, 20, 2, 8, 1, 16, 32, False),     # S < chunk
    (1, 96, 2, 16, 1, 16, 32, True),     # dt·A ≈ −60 a step, across 3 chunks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_three_passes_match_reference(B, S, H, P, G, N, chunk, steep, dtype):
    args = _ssd_inputs(B, S, H, P, G, N, dtype, 21, steep=steep)
    jx, tx = zip(*args)
    y = _ssd_three_passes(*tx, chunk=chunk)
    assert torch.isfinite(y).all() and y.dtype == tx[0].dtype
    tol = dict(atol=_tol(dtype) * 8, rtol=1e-2)
    _close(y, rref.ssd(*jx)[0], **tol)
    _close(y, ssd_scan_plain(*tx, chunk=chunk).float(), **tol)


# ------------------------------------- SSD: the model's dtype mix, final state
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 128, 2, 16, 1, 16, 32),
    (2, 100, 4, 16, 2, 32, 32),   # groups of heads, ragged last chunk
    (1, 70, 2, 8, 1, 16, 64),
])
def test_ssd_scan_bf16_with_fp32_dt_matches_reference(B, S, H, P, G, N, chunk):
    """The Mamba-2 block's mix: bf16 x, B and C with an fp32 dt.  The scan
    takes dt as it lies (no rounding to bf16) and writes y in bf16, as the
    reference's kernel, which casts each input to fp32."""
    args = _ssd_inputs(B, S, H, P, G, N, "bfloat16", 5, dt_fp32=True)
    jx, tx = zip(*args)
    assert tx[0].dtype == torch.bfloat16 and tx[1].dtype == torch.float32
    y = ops.ssd_scan(*tx, chunk=chunk)
    assert y.shape == (B, S, H, P) and y.dtype == torch.bfloat16
    tol = dict(atol=_tol("bfloat16") * 8, rtol=1e-2)
    _close(y, rops.ssd_scan(*jx, chunk=chunk), **tol)
    _close(y, rref.ssd(*jx)[0], **tol)


@pytest.mark.parametrize("S,chunk", [
    (128, 32),   # S on a chunk edge
    (127, 32),   # ... and one off it on either side
    (129, 32),
    (100, 64),   # a ragged last chunk
    (20, 64),    # S < chunk: one chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_final_state_matches_ssd_chunked(S, chunk, dtype):
    """``return_final_state=True`` gives the fp32 (B, H, P, N) state after
    step S, as the reference model's ``ssd_chunked`` returns it (the
    ragged tail adds nothing); y is the same as without it.  The three
    passes written out as the kernel forms the final state agree too."""
    from repro.models.ssm import ssd_chunked

    B, H, P, G, N = 2, 4, 16, 2, 16
    args = _ssd_inputs(B, S, H, P, G, N, dtype, 9, dt_fp32=True)
    jx, tx = zip(*args)
    y, state = ops.ssd_scan(*tx, chunk=chunk, return_final_state=True)
    assert state.shape == (B, H, P, N) and state.dtype == torch.float32
    assert torch.equal(y, ops.ssd_scan(*tx, chunk=chunk))
    ry, rstate = ssd_chunked(*jx, chunk)
    tol = dict(atol=_tol(dtype) * 8, rtol=1e-2)
    _close(y, ry, **tol)
    _close(state, rstate, **tol)
    _close(state, rref.ssd(*jx)[1], **tol)
    y3, state3 = _ssd_three_passes(*tx, chunk=min(chunk, S), final=True)
    _close(y3, ry, **tol)
    _close(state3, rstate, **tol)


def test_ssd_arg_check_takes_fp32_dt_with_bf16_x(monkeypatch):
    """The argument rules ``ssd_scan_fwd`` applies to CUDA tensors, in pure
    Python: bf16 x/B/C take an fp32 dt and launch with both dtype codes;
    dt in x's dtype stays accepted; other mixes raise.  Meta tensors stand
    in for the card's, with the device check and the launch replaced by a
    record of the call."""
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, H, P, G, N = 1, 40, 4, 16, 1, 32

    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def args(xd, dd, ad=f32):
        return (t((B, S, H, P), xd), t((B, S, H), dd), t((H,), ad),
                t((B, S, G, N), xd), t((B, S, G, N), xd))

    codes = {f32: 0, bf16: 1}
    for xd, dd in ((bf16, f32), (bf16, bf16), (f32, f32)):
        assert check_ssd_args("t", *args(xd, dd), 32) == (codes[xd], codes[dd])
    for bad in (args(f32, bf16), args(bf16, torch.float16), args(bf16, f32, bf16),
                args(torch.float16, torch.float16)):
        with pytest.raises(TypeError):
            check_ssd_args("t", *bad, 32)
    with pytest.raises(TypeError):
        tssd.ssd_scan_fwd(*args(f32, bf16), chunk=32)

    calls = []
    monkeypatch.setattr(tssd._build, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(tssd._build, "launch", lambda *a, **k: calls.append((a, k)))
    y, state = tssd.ssd_scan_fwd(*args(bf16, f32), chunk=32, return_final_state=True)
    assert y.dtype == bf16 and state.shape == (B, H, P, N) and state.dtype == f32
    (a, k), = calls
    assert a[0] == "repro_ssd_scan_fwd" and a[-2:] == (1, 0)  # x bf16, dt fp32
    assert k["ws_floats"] == ssd_plan(B, S, H, P, N, 32, True, True).ws_floats


# -------------------------------------------------------------- RG-LRU scan
@pytest.mark.parametrize("B,S,W", [(1, 256, 128), (2, 130, 100), (1, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_matches_reference(B, S, W, dtype):
    rng = np.random.default_rng(4)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W), np.float32)))
    b = rng.standard_normal((B, S, W), np.float32) * 0.1
    (aj, at), (bj, bt) = _pair(a.astype(np.float32), dtype), _pair(b, dtype)
    h = ops.rglru_scan(at, bt)
    assert h.shape == (B, S, W) and h.dtype == at.dtype
    _close(h, rops.rglru_scan(aj, bj), _tol(dtype) * 4)
    _close(h, rref.rglru(aj, bj), _tol(dtype) * 4)


@pytest.mark.parametrize("B,S,W", [
    (1, 2048, 2560),   # recurrentgemma_2b: S on a chunk edge
    (1, 2047, 2560),   # ... and one off it on either side
    (1, 2049, 2561),   # ragged W too
    (1, 63, 100),      # S < CHUNK: the replay alone
    (1, 64, 128),
    (1, 65, 128),
    (4, 130, 100),     # B > 1
    (1, 16384, 2560),  # 256 chunks through the carry pass
])
def test_rglru_plan_covers_every_step(B, S, W):
    """``rglru_plan`` against the kernel's cut: the chunks cover S once
    (the last ragged, never empty), the blocks every channel, and the
    scratch holds (Π a, carry) per (batch, chunk, channel) when there is
    more than one chunk."""
    plan = rglru_plan(B, S, W)
    C = plan.chunks
    steps = [t for c in range(C) for t in range(c * RGLRU_CHUNK, min((c + 1) * RGLRU_CHUNK, S))]
    assert steps == list(range(S)) and 0 < S - (C - 1) * RGLRU_CHUNK <= RGLRU_CHUNK
    wb, chunks, batch = plan.grid
    assert (chunks, batch) == (C, B) and wb * RGLRU_THREADS >= W > (wb - 1) * RGLRU_THREADS
    assert plan.ws_floats == (2 * B * C * W if C > 1 else 0)


def _rglru_chunked(a, b):
    """The kernel's three passes in plain PyTorch, as ``rglru_plan`` cuts
    them: each chunk's map h ↦ (Π a)·h + h_local from h = 0, the carries
    composed across chunks, then each chunk replayed from its carry; every
    step a rounded product, then a rounded sum, in fp32."""
    B, S, W = a.shape
    plan = rglru_plan(B, S, W)
    af, bf = a.float(), b.float()
    cuts = [range(c * RGLRU_CHUNK, min((c + 1) * RGLRU_CHUNK, S)) for c in range(plan.chunks)]
    maps = []
    for steps in cuts[:-1]:  # pass 1: the last chunk's map is never needed
        p, h = torch.ones(B, W), torch.zeros(B, W)
        for t in steps:
            h = af[:, t] * h + bf[:, t]
            p = p * af[:, t]
        maps.append((p, h))
    carry = [torch.zeros(B, W)]  # pass 2
    for p, h in maps:
        carry.append(p * carry[-1] + h)
    out = torch.empty_like(a)  # pass 3
    for steps, h in zip(cuts, carry):
        for t in steps:
            h = af[:, t] * h + bf[:, t]
            out[:, t] = h
    return out


@pytest.mark.parametrize("B,S,W,slow", [
    (1, 130, 100, False),  # 3 chunks, ragged W
    (1, 63, 32, False),    # one chunk: the serial chain itself
    (1, 65, 32, True),     # a chunk edge one step in
    (2, 192, 64, True),    # B > 1, S on a chunk edge, a slow decay
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_chunked_scan_matches_reference(B, S, W, slow, dtype):
    """``slow``: a in (0.9, 1), so the carry at a chunk edge lives on for
    ~100 steps; a = sigmoid(N(0, 1)) forgets it in ~30."""
    rng = np.random.default_rng(22)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W), np.float32)))
    if slow:
        a = 0.9 + 0.1 * a
    b = rng.standard_normal((B, S, W), np.float32) * 0.1
    (aj, at), (bj, bt) = _pair(a.astype(np.float32), dtype), _pair(b, dtype)
    h = _rglru_chunked(at, bt)
    assert h.dtype == at.dtype
    _close(h, rref.rglru(aj, bj), _tol(dtype) * 4)
    _close(h, ops.rglru_scan(at, bt).float(), _tol(dtype) * 4)
    if S <= RGLRU_CHUNK:  # one chunk: bit for bit the serial chain
        assert torch.equal(h, ops.rglru_scan(at, bt))


# ------------------------------------------------------------------- triad
@pytest.mark.parametrize("N", [1000, 65536, 70000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_triad_matches_reference(N, dtype):
    rng = np.random.default_rng(5)
    (aj, at), (bj, bt) = (_pair(rng.standard_normal(N, np.float32), dtype)
                          for _ in range(2))
    o = ops.stream_triad(at, bt, 3.0)
    assert o.shape == (N,) and o.dtype == at.dtype
    want = np.asarray(rops.stream_triad(aj, bj, 3.0), np.float32)
    _close(o, want, _tol(dtype))
    _close(o, rref.triad(aj, bj, 3.0), _tol(dtype))
    if dtype == "bfloat16":  # the product rounded, then the sum, on both sides
        np.testing.assert_array_equal(o.float().numpy(), want)


# ------------------------------------------------ no silent loss of gradients
def _calls(x):
    """One call of each wrapper of a bare kernel on (1, 16, 2, 16) ``x``."""
    i32 = torch.int32
    return {
        "flash_attention": lambda: ops.flash_attention(x, x, x),
        "decode_attention": lambda: ops.decode_attention(x[:, 0], x, x, 3),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            x[:, 0], x, x, torch.zeros(1, 1, dtype=i32), torch.ones(1, dtype=i32)),
        "ssd_scan": lambda: ops.ssd_scan(x, x[..., 0], torch.zeros(2), x, x),
        "rglru_scan": lambda: ops.rglru_scan(x[0], x[0]),
        "stream_triad": lambda: ops.stream_triad(x[0, 0, 0], x[0, 0, 0]),
    }


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_wrapper_without_backward_raises_under_autograd(name):
    """Each kernel writes its output outside autograd; its wrapper refuses
    an input that requires grad in grad mode (on the CPU too, where the
    plain version could be differentiated), and runs outside grad mode."""
    x = torch.rand(1, 16, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"{name}.* has no backward"):
        _calls(x)[name]()
    with torch.no_grad():
        _calls(x)[name]()
    _calls(x.detach())[name]()  # no input requires grad


def test_attention_gradient_reaches_the_projections():
    """Lx.attention goes through the trainable flash op: the gradient of
    its output reaches wq, wk, wv and the biases."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import layers as Lx
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import layer_params

    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32")
    lp = {k: v.requires_grad_() for k, v in layer_params(Model(cfg, "cpu").init(0), 0).items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    out = Lx.attention(cfg, x, lp, "", torch.arange(12, dtype=torch.int32))
    names = ["wq", "wk", "wv", "bq", "bk", "bv"]
    grads = torch.autograd.grad(out.square().sum(), [lp[n] for n in names])
    for n, g in zip(names, grads):
        assert g.abs().max() > 0, n


# -------------------------------------------------- the scans' trainable ops
def _grads(fn, inputs, w):
    """Gradients of Σ w·fn(inputs) wrt every input, fp32, detached."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return [g.float() for g in torch.autograd.grad((out.float() * w).sum(), leaves)]


def _rglru_draw(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    w = rng.standard_normal((B, S, W)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(w)


@pytest.mark.parametrize("B,S,W", [(1, 1, 8), (2, 5, 16), (1, RGLRU_CHUNK + 7, 33), (3, 200, 4)])
def test_rglru_scan_trainable_backward_matches_autograd(B, S, W):
    """The reversed-scan backward (g_t = dh_t + a_{t+1}·g_{t+1}; db = g,
    da_t = g_t·h_{t−1}) against autograd through the plain sequential
    version, and the reference's jax.grad of its associative scan; the
    forward equals ops.rglru_scan."""
    import jax

    from repro.models import rglru as RR

    a, b, w = _rglru_draw(B, S, W, S)
    with torch.no_grad():
        torch.testing.assert_close(ops.rglru_scan_trainable(a, b), ops.rglru_scan(a, b),
                                   atol=0, rtol=0)
    got = _grads(ops.rglru_scan_trainable, (a, b), w)
    want = _grads(ref.rglru, (a, b), w)
    jwant = jax.grad(lambda a_, b_: (RR.rglru_scan(a_, b_) * jnp.asarray(w.numpy())).sum(),
                     argnums=(0, 1))(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    for g, e, j in zip(got, want, jwant):
        _close(g, e.numpy(), 1e-5, 1e-5)
        _close(g, j, 1e-4, 1e-5)


def _ssd_draw(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    w = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, dt, A, Bm, Cm)], torch.from_numpy(w)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [(1, 16, 2, 8, 1, 4, 16),
                                               (2, 37, 4, 8, 2, 8, 16),
                                               (1, 5, 3, 4, 1, 8, 8)])
def test_ssd_scan_trainable_backward_matches_autograd(B, S, H, P, G, N, chunk):
    """The backward (autograd through the plain chunked form, recomputed)
    against autograd through the sequential oracle and the reference's
    jax.grad of its ``ssd_chunked``, for x, dt, A, Bm and Cm; with the
    final state asked for, it comes back without a gradient."""
    import jax

    from repro.models import ssm as RS

    inputs, w = _ssd_draw(B, S, H, P, G, N, S)
    scan = lambda *t: ops.ssd_scan_trainable(*t, chunk=chunk)  # noqa: E731
    got = _grads(scan, inputs, w)
    want = _grads(lambda *t: ref.ssd(*t)[0], inputs, w)
    jwant = jax.grad(lambda *t: (RS.ssd_chunked(*t, chunk)[0] * jnp.asarray(w.numpy())).sum(),
                     argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(t.numpy()) for t in inputs))
    for g, e, j in zip(got, want, jwant):
        scale = float(e.abs().max())
        _close(g, e.numpy(), 1e-5 * scale)
        _close(g, j, 1e-5 * scale)
    leaves = [t.clone().requires_grad_() for t in inputs]
    y, state = ops.ssd_scan_trainable(*leaves, chunk=chunk, return_final_state=True)
    assert y.requires_grad and not state.requires_grad
    with torch.no_grad():
        y0, s0 = ops.ssd_scan(*inputs, chunk=chunk, return_final_state=True)
    torch.testing.assert_close(y.detach(), y0, atol=0, rtol=0)
    torch.testing.assert_close(state, s0, atol=0, rtol=0)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,steep", [(1, 16, 2, 8, 1, 4, 16, False),
                                                     (2, 37, 4, 8, 2, 8, 16, False),
                                                     (1, 5, 3, 4, 1, 8, 8, False),
                                                     (1, 300, 6, 16, 2, 8, 64, False),
                                                     (1, 100, 2, 4, 1, 4, 16, True)])
def test_ssd_scan_plain_pads_and_carries_like_the_oracle(B, S, H, P, G, N, chunk, steep):
    """The plain version takes every chunk at once: S on a chunk edge,
    ragged (padded with inert dt = 0 steps) and below one chunk; the state
    carried across chunks by exp of summed chunk totals, also where every
    step decays by e⁻⁶⁰ (the totals reach −960 a chunk).  y and the final
    state against the sequential oracle."""
    inputs, _ = _ssd_draw(B, S, H, P, G, N, S + 1)
    if steep:
        inputs[1] = torch.full_like(inputs[1], 60.0)
        inputs[2] = -torch.ones_like(inputs[2])
    y, state = ssd_scan_plain(*inputs, chunk=chunk, return_final_state=True)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    want_y, want_state = ref.ssd(*inputs)
    _close(y, want_y.numpy(), 2e-5, 1e-5)
    _close(state, want_state.numpy(), 2e-5, 1e-5)


# ------------------------------------------------ the ops' fake implementations
def _op_cases():
    """Per kernel: its wrapper's call on CPU tensors (the plain version)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    bf = torch.bfloat16
    q, k = r(2, 24, 4, 16, dtype=bf), r(2, 24, 2, 16, dtype=bf)
    pages, pt = r(6, 8, 2, 16, dtype=bf), torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    x, dt_, A, Bm = r(2, 24, 4, 8, dtype=bf), r(2, 24, 4), -r(4).abs(), r(2, 24, 1, 16, dtype=bf)
    return {
        "flash_attention": lambda: ops.flash_attention(q, k, k),
        "decode_attention": lambda: ops.decode_attention(
            q[:, 0], k, k, torch.tensor([5, 24], dtype=torch.int32)),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q[:, 0], pages, pages, pt, torch.tensor([20, 9], dtype=torch.int32)),
        "ssd_scan": lambda: ops.ssd_scan(x, dt_, A, Bm, Bm, chunk=8, return_final_state=True),
        "rglru_scan": lambda: ops.rglru_scan(r(2, 24, 32), r(2, 24, 32)),
        "stream_triad": lambda: ops.stream_triad(r(1000, dtype=bf), r(1000, dtype=bf)),
    }


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_op_fake_implementation_gives_plain_shapes_and_dtypes(name):
    """Under FakeTensorMode each ``repro_torch::`` op runs its fake
    implementation: the plain version's output shapes and dtypes, no data,
    no launch counted; the op is registered under the namespace."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert ops.OPS[name] is getattr(torch.ops.repro_torch, name).default
    call = _op_cases()[name]
    want = call()
    with FakeTensorMode(allow_non_fake_inputs=True):
        got = call()
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert ops.launch_counts()[name] == 0


@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_op_flop_formula_counts_the_kernel_tables_bound(name):
    """``FlopCounterMode`` counts each op by its formula: flash 4·Dh·H·B
    over the causal pairs, the decode kernels 4·Dh·H over the live K/V
    rows, the SSD the least of its three ways (recurrence, chunked dual
    form, the kernel's split products), the RG-LRU 2·B·S·W, the triad 2·N."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        _op_cases()[name]()
    flops, ways = ops.ssd_flops(2, 24, 4, 8, 16, 8, "bfloat16", final=True)
    want = {
        "flash_attention": 4 * 16 * 4 * 2 * (24 * 25 // 2),
        "decode_attention": 4 * 16 * 4 * (5 + 24),
        "paged_decode_attention": 4 * 16 * 4 * (20 + 9),
        "ssd_scan": sum(flops.values()),
        "rglru_scan": 2 * 2 * 24 * 32,
        "stream_triad": 2 * 1000,
    }[name]
    assert fc.get_total_flops() == want
    if name == "ssd_scan":
        assert flops in ways.values() and ways["recurrence"] == {"float32": 5 * 16 * 8 * 24 * 4 * 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_flop_formula_counts_by_the_input_dtype(dtype):
    """The SSD op's formula reads x's dtype: an fp32 call counts
    ``ssd_flops(..., "float32")`` (its C·Bᵀ at the fp32 rate), a bf16 one
    ``"bfloat16"``, through ``FlopCounterMode`` and through the dry run's
    traced record (``hlo_analysis.record_flops``) alike."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist import hlo_analysis

    g = torch.Generator().manual_seed(3)
    x, dt_ = torch.randn(2, 24, 4, 8, generator=g).to(dtype), torch.rand(2, 24, 4, generator=g)
    A, Bm = -torch.rand(4, generator=g), torch.randn(2, 24, 1, 16, generator=g).to(dtype)
    name = str(dtype)[6:]
    want, _ways = ops.ssd_flops(2, 24, 4, 8, 16, 8, name, final=True)
    with FlopCounterMode(display=False) as fc:
        ops.ssd_scan(x, dt_, A, Bm, Bm, chunk=8, return_final_state=True)
    assert fc.get_total_flops() == sum(want.values())
    rec = {"op": "repro_torch::ssd_scan",
           "args": [hlo_analysis._arg(t) for t in (x, dt_, A, Bm, Bm)] + [8, True]}
    assert hlo_analysis.record_flops(rec) == sum(want.values())


def test_flash_pairs_count_the_unmasked_pairs():
    """Causal, windowed and valid_len masks, against a brute count."""
    for S in (1, 5, 17):
        for causal in (True, False):
            for window in (0, 3):
                for valid_len in (0, 4):
                    K = valid_len if 0 < valid_len < S else S
                    want = sum((j <= i or not causal) and (window <= 0 or j > i - window)
                               for i in range(S) for j in range(K))
                    assert ops.flash_pairs(S, causal, window, valid_len) == want
