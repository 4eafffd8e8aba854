"""The port's dense decode, SSD scan, RG-LRU scan and STREAM triad (their
plain versions, as ``repro_torch.kernels.ops`` runs them for CPU tensors)
against the reference's ``repro.kernels.ops`` in interpret mode and its
oracles ``repro.kernels.ref``, over the sweeps of ``test_kernels.py``.

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
def _ssd_inputs(B, S, H, P, G, N, dtype, seed, steep=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), np.float32)))
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    if steep:  # dt·A in [−65, −55] at every step
        dt = 55.0 + 10.0 * rng.random((B, S, H), np.float32)
        A = -np.ones(H, np.float32)
    Bm = rng.standard_normal((B, S, G, N), np.float32) * 0.3
    Cm = rng.standard_normal((B, S, G, N), np.float32) * 0.3
    return (_pair(x, dtype), _pair(dt.astype(np.float32), dtype),
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
