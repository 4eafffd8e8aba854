"""The port's Mamba-2 model (``repro_torch.models.ssm`` / ``ssm_lm``) against
the reference at the mamba2_780m smoke config, on the reference's own
params carried across by ``from_reference``: the scan identities of
``test_scan_math.py`` on the port's functions, one SSD block, the LM's
prefill (logits and caches) and decode steps, and greedy tokens through
the port's dense-slot engine against the reference engine's.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: the scan identities keep ``test_scan_math.py``'s (2e-4 for the
SSD, 1e-5 for the RG-LRU), in fp32; the block, logits and caches 1e-4 in
fp32 — the same math in another summation order (the chunked scan against
the reference's ``ssd_chunked``, ``F.conv1d`` against a sum of shifted
products).  The block in bf16 is held against the reference's block in
fp32 within 5e-2 plus 2e-2 relative (its outputs reach |5|, where bf16's
spacing is 2⁻⁵, and the SSD and the out-projection carry the rounding of
their bf16 inputs), and against the reference's bf16 block within 1e-1:
both sides round to bf16 after each product, norm and activation, at
other points (the reference sums the conv's shifted products in bf16, one
``F.conv1d`` in fp32), and the reference's bf16 block itself lies ~8e-2
from its fp32 one.  Greedy tokens are exact: both sides run fp32 and take
the first maximal index.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.dist.plan import get_plan
from repro.kernels import ref as rref
from repro.models import rglru as RR
from repro.models import ssm as RS
from repro.models import ssm_lm as RLM
from repro.models.model import build_model as ref_build
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import ssm_lm as TLM
from repro_torch.models.model import Model
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import Engine, ServeConfig

PLAN = get_plan("futurized")
SEEDS = [0, 1, 2, 3, 4]
LOGIT_ATOL = 1e-4
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}   # against the reference in fp32
RTOL = {"float32": 0.0, "bfloat16": 2e-2}
BF16_PAIR_ATOL = 1e-1                        # bf16 against the reference's bf16


def _close(port: torch.Tensor, want, atol: float, rtol: float = 0.0):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _ssd_draw(rng, B, S, H, P, G, N):
    x = rng.standard_normal((B, S, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), np.float32)))
    A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    Bm = rng.standard_normal((B, S, G, N), np.float32) * 0.3
    Cm = rng.standard_normal((B, S, G, N), np.float32) * 0.3
    return x, dt.astype(np.float32), A, Bm, Cm


def _both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


# ------------------------------------------------- test_scan_math.py, ported
@pytest.mark.parametrize("seed", SEEDS)
def test_ssd_chunked_matches_sequential(seed):
    rng = np.random.default_rng(seed)
    B, nq, G = int(rng.integers(1, 4)), int(rng.integers(2, 7)), int(rng.integers(1, 3))
    S, H, P, N = nq * 16, 2 * G, 8, 16
    jx, tx = _both(_ssd_draw(rng, B, S, H, P, G, N))
    y, h = TS.ssd_chunked(*tx, chunk=16)
    y_ref, h_ref = rref.ssd(*jx)
    _close(y, y_ref, 2e-4)
    _close(h, h_ref, 2e-4)
    y_port, h_port = ref.ssd(*tx)  # the port's own oracle
    _close(y, y_port.numpy(), 2e-4)
    _close(h, h_port.numpy(), 2e-4)


@pytest.mark.parametrize("seed", SEEDS)
def test_ssd_decode_continues_prefill_state(seed):
    """prefill state + one recurrent step == sequential over S+1."""
    B, S, H, P, G, N = 1, 32, 2, 8, 1, 16
    rng = np.random.default_rng(seed)
    jx, (x, dt, A, Bm, Cm) = _both(_ssd_draw(rng, B, S + 1, H, P, G, N))
    _, h_prefill = TS.ssd_chunked(x[:, :S], dt[:, :S], A, Bm[:, :S], Cm[:, :S], chunk=16)
    y1, h1 = TS.ssd_decode_step(h_prefill, x[:, S], dt[:, S], A, Bm[:, S], Cm[:, S])
    y_ref, h_ref = rref.ssd(*jx)
    _close(y1, np.asarray(y_ref)[:, S], 2e-4)
    _close(h1, h_ref, 2e-4)


@pytest.mark.parametrize("seed", SEEDS)
def test_rglru_scan_matches_sequential(seed):
    rng = np.random.default_rng(seed)
    B, S, W = int(rng.integers(1, 4)), int(rng.integers(3, 66)), 16
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, W), np.float32)))
    b = rng.standard_normal((B, S, W), np.float32) * 0.2
    h = TR.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(h, rref.rglru(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    _close(h, RR.rglru_scan(jnp.asarray(a), jnp.asarray(b)), 1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_rglru_h0_fold(seed):
    """Scan with initial state == sequential continuation."""
    B, S, W = 1, 20, 8
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, 2 * S, W))))).astype(np.float32)
    b = (rng.standard_normal((B, 2 * S, W)) * 0.2).astype(np.float32)
    full = np.asarray(rref.rglru(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    second = TR.rglru_scan(ta[:, S:], tb[:, S:], h0=torch.from_numpy(full[:, S - 1].copy()))
    _close(second, full[:, S:], 1e-5)
    assert torch.equal(tb, torch.from_numpy(b))  # the fold does not write the caller's b


# ------------------------------------------------------------ model parity
@pytest.fixture(scope="module")
def mamba():
    """The reference's and the port's mamba2_780m smoke model in fp32 on
    the same params."""
    rcfg = replace(ref_config("mamba2_780m", smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, PLAN)
    rparams = rmodel.init(jax.random.PRNGKey(1))
    cfg = replace(get_config("mamba2_780m", smoke=True), dtype="float32")
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    return rcfg, rmodel, rparams, cfg, model, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 33])  # shorter than the conv; one past a chunk
def test_ssm_block_matches(mamba, dtype, S):
    rcfg, _, rparams, cfg, _, params = mamba
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S, cfg.d_model), np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    rlp = {k[4:]: v[0] for k, v in rparams.items() if k.startswith("blk/")}
    tlp = {k[4:]: v[0] for k, v in params.items() if k.startswith("blk/")}
    want = RS.ssm_block(rcfg, PLAN, jnp.asarray(x), rlp, "")  # fp32
    got = TS.ssm_block(replace(cfg, dtype=dtype), torch.from_numpy(x).to(td), tlp, "")
    assert got.dtype == td
    _close(got, want, ATOL[dtype], RTOL[dtype])
    if dtype == "bfloat16":
        want16 = RS.ssm_block(replace(rcfg, dtype=dtype), PLAN, jnp.asarray(x, jd), rlp, "")
        _close(got, want16, BF16_PAIR_ATOL)


@pytest.mark.parametrize("S", [2, 3, 32, 45])  # S < K − 1, = K − 1, a chunk edge, ragged
def test_prefill_and_decode_match(mamba, S):
    rcfg, rmodel, rparams, cfg, model, params = mamba
    rng = np.random.default_rng(S)
    toks = rng.integers(1, cfg.vocab_size, size=(2, S))
    rlog, rcache = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tlog, tcache = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    V = cfg.vocab_size
    _close(tlog[:, :V], np.asarray(rlog)[:, :V], LOGIT_ATOL)
    assert set(tcache) == set(rcache)
    for k in rcache:
        assert tuple(tcache[k].shape) == rcache[k].shape, k
        _close(tcache[k], rcache[k], ATOL["float32"])
    for step in range(4):
        tok = np.asarray(rlog).argmax(-1)[:, None]
        rlog, rcache = rmodel.decode(rparams, rcache, jnp.asarray(tok, jnp.int32))
        tlog, tcache = model.decode(params, tcache, torch.from_numpy(tok))
        _close(tlog[:, :V], np.asarray(rlog)[:, :V], LOGIT_ATOL)
        for k in rcache:
            _close(tcache[k], rcache[k], ATOL["float32"])
    # the whole sequence's forward agrees with the prefill's last logits
    full, _ = TLM.forward(cfg, params, torch.from_numpy(toks))
    rfull, _ = RLM.forward(rcfg, PLAN, rparams, jnp.asarray(toks, jnp.int32))
    _close(full[..., :V], np.asarray(rfull)[..., :V], LOGIT_ATOL)


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def test_dense_slot_engine_matches_reference_engine(rt, port_rt, mamba):
    """Greedy tokens through the port's engine (the ssm family takes the
    dense-slot backend) equal the reference engine's, with more requests
    than slots and prompts shorter than the conv width."""
    _, rmodel, rparams, _, model, params = mamba
    prompts = [[5, 6, 7, 8], [100, 3, 50, 2, 9, 11], [42], [7, 8], list(range(1, 40))]
    kw = dict(max_batch=2, cache_len=64, max_new_tokens=5)
    reng = RefEngine(rmodel, rparams, RefServeConfig(**kw, name="ref-ssm"))
    want = [f.get(timeout=300) for f in [reng.submit(p) for p in prompts]]
    eng = Engine(model, params, ServeConfig(**kw, paged=False, name="port-ssm"), device="cpu")
    assert not eng.paged
    got = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    assert got == want
