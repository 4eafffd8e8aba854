"""The port's RecurrentGemma hybrid (``repro_torch.models.rglru`` /
``hybrid``) against the reference at the recurrentgemma_2b smoke config
(window 32), on the reference's own params carried across by
``from_reference``: one recurrent block, the LM's prefill (logits and
caches: rec states and the window ring) and decode steps, decoding past
the window (the ring wraps) against the full forward, and greedy tokens
through the port's dense-slot engine against the reference engine's.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: fp32 1e-4 on the block, logits and caches — the same math in
another summation order (the chunked RG-LRU scan against the reference's
associative scan, ``F.conv1d`` against a sum of shifted products, the
dense decode against the reference's masked einsum).  The block in bf16
is held against the reference's fp32 block within 5e-2 plus 2e-2
relative (bf16 rounds each product, norm and activation; outputs reach
|4|, where bf16's spacing is 2⁻⁵) and against the reference's bf16 block
within 1e-1, since both round at other points.  The ring-buffer test
keeps the reference's own 5e-2 against the full forward.  Greedy tokens
are exact: both sides run fp32 and take the first maximal index.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.dist.plan import get_plan
from repro.models import hybrid as RH
from repro.models import rglru as RR
from repro.models.model import build_model as ref_build
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs import get_config
from repro_torch.models import hybrid as TH
from repro_torch.models import rglru as TR
from repro_torch.models.model import Model
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import Engine, ServeConfig

PLAN = get_plan("futurized")
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}   # against the reference in fp32
RTOL = {"float32": 0.0, "bfloat16": 2e-2}
BF16_PAIR_ATOL = 1e-1                        # bf16 against the reference's bf16


def _close(port: torch.Tensor, want, atol: float, rtol: float = 0.0):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def griffin():
    """The reference's and the port's recurrentgemma_2b smoke model in fp32
    on the same params: one (rec, rec, attn) group and two tail layers."""
    rcfg = replace(ref_config("recurrentgemma_2b", smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, PLAN)
    rparams = rmodel.init(jax.random.PRNGKey(1))
    cfg = replace(get_config("recurrentgemma_2b", smoke=True), dtype="float32")
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    return rcfg, rmodel, rparams, cfg, model, params


def test_param_layout(griffin):
    """Groups ``grp/{ra,rb,at}/`` plus ``tail/``, as the reference lays
    them out; the gates' weights stay fp32 in the compute copy."""
    rcfg, _, rparams, cfg, model, params = griffin
    assert set(model.param_specs()) == set(rparams)
    assert {k.split("/")[0] for k in params} == {"tok_embed", "final_ln", "grp", "tail"}
    cp = model.compute_params(params)
    c16 = Model(replace(cfg, dtype="bfloat16"), device="cpu").compute_params(params)
    for k in ("grp/ra/w_a", "grp/rb/w_i", "tail/b_a", "tail/lam", "grp/at/ln1", "final_ln"):
        assert c16[k].dtype == torch.float32 and cp[k] is params[k], k
    for k in ("grp/ra/w_x", "grp/at/wq", "tail/rec_out", "tail/conv_w", "tok_embed"):
        assert c16[k].dtype == torch.bfloat16, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 40])  # shorter than the conv; past a 32-step chunk
def test_rec_block_matches(griffin, dtype, S):
    rcfg, _, rparams, cfg, _, params = griffin
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, S, cfg.d_model), np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    rlp = {k[5:]: v[0] for k, v in rparams.items() if k.startswith("tail/")}
    tlp = {k[5:]: v[0] for k, v in params.items() if k.startswith("tail/")}
    want = RR.rec_block(rcfg, PLAN, jnp.asarray(x), rlp, "")  # fp32
    got = TR.rec_block(replace(cfg, dtype=dtype), torch.from_numpy(x).to(td), tlp, "")
    assert got.dtype == td
    _close(got, want, ATOL[dtype], RTOL[dtype])
    if dtype == "bfloat16":
        want16 = RR.rec_block(replace(rcfg, dtype=dtype), PLAN, jnp.asarray(x, jd), rlp, "")
        _close(got, want16, BF16_PAIR_ATOL)


@pytest.mark.parametrize("S", [2, 20, 32, 45])  # S < K − 1, < window, = window, > window
def test_prefill_and_decode_match(griffin, S):
    rcfg, rmodel, rparams, cfg, model, params = griffin
    rng = np.random.default_rng(S)
    toks = rng.integers(1, cfg.vocab_size, size=(2, S))
    rlog, rcache = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    tlog, tcache = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    V = cfg.vocab_size
    _close(tlog[:, :V], np.asarray(rlog)[:, :V], ATOL["float32"])
    assert set(tcache) == set(rcache)
    for k in rcache:
        assert tuple(tcache[k].shape) == rcache[k].shape, k
        _close(tcache[k], rcache[k], ATOL["float32"])
    for step in range(4):
        tok = np.asarray(rlog).argmax(-1)[:, None]
        rlog, rcache = rmodel.decode(rparams, rcache, jnp.asarray(tok, jnp.int32))
        tlog, tcache = model.decode(params, tcache, torch.from_numpy(tok))
        _close(tlog[:, :V], np.asarray(rlog)[:, :V], ATOL["float32"])
        for k in rcache:
            _close(tcache[k], rcache[k], ATOL["float32"])
    full, _ = TH.forward(cfg, params, torch.from_numpy(toks))
    rfull, _ = RH.forward(rcfg, PLAN, rparams, jnp.asarray(toks, jnp.int32))
    _close(full[..., :V], np.asarray(rfull)[..., :V], ATOL["float32"])


def test_windowed_decode_ring_buffer(griffin):
    """test_models_consistency.py's ring-buffer test on the port: decoding
    past the window wraps the ring and still matches the full forward
    (which sees the same effective window); the per-row lengths given to
    the dense decode kernel are clamped to the window once it wraps."""
    _, _, _, cfg, model, params = griffin
    B, S, N = 1, 32, 6  # prefill exactly one window, then wrap
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S + N)))
    _, cache = model.prefill(params, {"tokens": tokens[:, :S]})
    for t in range(N):
        logits, cache = model.decode(params, cache, tokens[:, S + t:S + t + 1])
        full, _ = TH.forward(cfg, params, tokens[:, :S + t + 1])
        err = (logits - full[:, -1]).abs().max().item()
        assert err < 0.05, f"wrap step {t}: {err}"
    assert int(cache["pos"][0]) == S + N


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def test_dense_slot_engine_matches_reference_engine(rt, port_rt, griffin):
    """Greedy tokens through the port's engine (the hybrid family takes the
    dense-slot backend) equal the reference engine's, with more requests
    than slots, a prompt shorter than the conv width and one whose decode
    wraps the 32-slot ring."""
    _, rmodel, rparams, _, model, params = griffin
    prompts = [[5, 6, 7, 8], [100, 3, 50, 2, 9, 11], [42], list(range(1, 30)), [7, 8]]
    kw = dict(max_batch=2, cache_len=64, max_new_tokens=6)
    reng = RefEngine(rmodel, rparams, RefServeConfig(**kw, name="ref-hybrid"))
    want = [f.get(timeout=300) for f in [reng.submit(p) for p in prompts]]
    eng = Engine(model, params, ServeConfig(**kw, paged=False, name="port-hybrid"), device="cpu")
    assert not eng.paged
    got = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    assert got == want
