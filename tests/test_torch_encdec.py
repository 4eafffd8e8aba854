"""The port's encoder-decoder family (``repro_torch.models.encdec``) against
the reference at the whisper_small smoke config, on the reference's own
params carried across by ``from_reference`` (norm scales and biases made
non-trivial): the sinusoidal positions, the decoder's cross-attention in
decode (through the dense decode kernel's plain version) and over full
sequences, the forward and loss, prefill and decode steps, and greedy
tokens through the port's dense-slot engine against the reference
engine's.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances are those of ``test_torch_models.py``: fp32 1e-4 — the same
math in another summation order, fp32 softmax on both sides; bf16 5e-2 on
activations — each side rounds to bf16 after every product and norm, at
other points.  Greedy tokens are exact.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.dist.plan import get_plan
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models.model import build_model as ref_build
from repro.serve.router import build_engine
from repro_torch.configs import get_config
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.model import Model
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.router import default_extra_inputs

PLAN = get_plan("futurized")
DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOGIT_ATOL = 1e-4
NORMS = ("ln1", "ln2", "lnx", "final_ln")
BIASES = ("bq", "bk", "bv", "xbq", "xbk", "xbv")


def _cfgs(dtype="float32", **kw):
    return (replace(ref_config("whisper_small", smoke=True), dtype=dtype, **kw),
            replace(get_config("whisper_small", smoke=True), dtype=dtype, **kw))


@pytest.fixture(scope="module")
def flat():
    """The reference's fp32 params, norm scales and biases non-trivial."""
    rcfg, _ = _cfgs()
    params = ref_build(rcfg, PLAN).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    out = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for k, v in out.items():
        if k.split("/")[-1] in NORMS:
            out[k] = 1.0 + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        elif k.split("/")[-1] in BIASES:
            out[k] = 0.1 * rng.standard_normal(v.shape).astype(np.float32)
    return out


def _both(flat, tcfg):
    return ({k: jnp.asarray(v) for k, v in flat.items()},
            from_reference(flat, tcfg, "cpu"))


def _dec_layer0(params):
    return {k[4:]: v[0] for k, v in params.items()
            if k.startswith("dec/") and k != "dec/final_ln"}


def _close(t: torch.Tensor, j, atol: float):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol)


def _act(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("n,d", [(1500, 768), (64, 64), (7, 16), (3, 2), (1, 3)])
def test_sinusoidal_positions_equal_reference(n, d):
    got = TL.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, 2 * (d // 2))
    np.testing.assert_array_equal(got.numpy(), RL.sinusoidal_positions(n, d))


def test_param_layout_matches_reference(flat):
    _, tcfg = _cfgs()
    tp = from_reference(flat, tcfg, "cpu")
    assert set(tp) == set(TE.encdec_param_specs(tcfg)) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(tp[k].numpy(), v)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_decode_attention_matches(flat, dtype, rope):
    """One decoder token against the fixed encoder cache: every row over
    all T positions (the dense decode kernel's plain version at lengths
    T), RoPE on q alone where the config has it, the caches untouched."""
    rcfg, tcfg = _cfgs(dtype, rope=rope)
    rp, tp = _both(flat, tcfg)
    rng = np.random.default_rng(11)
    B, T, KV, Dh = 3, 37, tcfg.num_kv_heads, tcfg.head_dim
    xj, xt = _act(rng, (B, 1, tcfg.d_model), dtype)
    kj, kt = _act(rng, (B, T, KV, Dh), dtype)
    vj, vt = _act(rng, (B, T, KV, Dh), dtype)
    k0, v0 = kt.clone(), vt.clone()
    pos = np.asarray([0, 5, 90], np.int32)
    ro, _, _ = RL.decode_attention(rcfg, PLAN, xj, _dec_layer0(rp), "x", kj, vj,
                                   jnp.asarray(pos), cross=True)
    to, tk, tv = TL.decode_attention(tcfg, xt, _dec_layer0(tp), "x", kt, vt,
                                     torch.from_numpy(pos), cross=True)
    assert tk is kt and tv is vt
    assert torch.equal(kt, k0) and torch.equal(vt, v0)  # no cache write
    _close(to, ro, ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_full_sequence_matches(flat, dtype):
    """The plain full-sequence cross-attention (training and prefill)
    against the reference's ``_sdpa`` path, with the K/V it makes."""
    rcfg, tcfg = _cfgs(dtype)
    rp, tp = _both(flat, tcfg)
    rng = np.random.default_rng(12)
    xj, xt = _act(rng, (2, 9, tcfg.d_model), dtype)
    yj, yt = _act(rng, (2, 21, tcfg.d_model), dtype)
    ro = RE._cross_attention(rcfg, PLAN, xj, _dec_layer0(rp), yj)
    lp = _dec_layer0(tp)
    to = TE._cross_attention(tcfg, xt, lp, *TE._cross_kv(tcfg, lp, yt))
    assert to.dtype == getattr(torch, dtype)
    _close(to, ro, ATOL[dtype])


def _inputs(seed, tcfg, B=2, Se=24, Sd=11):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, Se, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(1, tcfg.vocab_size, size=(B, Sd)).astype(np.int32)
    return enc, toks


def test_forward_and_loss_match(flat):
    rcfg, tcfg = _cfgs()
    rp, tp = _both(flat, tcfg)
    enc, toks = _inputs(0, tcfg, Sd=13)
    rl, _ = RE.forward(rcfg, PLAN, rp, jnp.asarray(enc), jnp.asarray(toks))
    tl, aux = TE.forward(tcfg, tp, torch.from_numpy(enc), torch.from_numpy(toks))
    V = tcfg.vocab_size
    assert tl.shape == (2, 13, tcfg.padded_vocab) and float(aux) == 0.0
    _close(tl[..., :V], np.asarray(rl)[..., :V], LOGIT_ATOL)
    batch = {"enc": enc, "tokens": toks}
    rloss = ref_build(rcfg, PLAN).loss(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = Model(tcfg, device="cpu").loss(tp, {k: torch.from_numpy(v)
                                                for k, v in batch.items()})
    assert abs(float(tloss) - float(rloss)) <= LOGIT_ATOL, (float(tloss), float(rloss))


@pytest.mark.parametrize("Sd", [1, 11])
def test_prefill_and_decode_steps_match(flat, Sd):
    """Encoder + decoder prefill into a cache longer than the prompt,
    then 5 greedy decode steps: logits within 1e-4, the caches (self K/V
    written in place, cross K/V fixed) and positions equal, greedy tokens
    equal."""
    rcfg, tcfg = _cfgs()
    rp, tp = _both(flat, tcfg)
    enc, toks = _inputs(1, tcfg, Sd=Sd)
    T = Sd + 8
    rlog, rc = RE.prefill(rcfg, PLAN, rp, jnp.asarray(enc), jnp.asarray(toks), cache_len=T)
    tlog, tc = TE.prefill(tcfg, tp, torch.from_numpy(enc), torch.from_numpy(toks),
                          cache_len=T)
    assert set(tc) == set(rc) == set(TE.init_cache_specs(tcfg, 2, T, enc.shape[1]))
    for k in rc:
        assert tuple(tc[k].shape) == rc[k].shape, k
        _close(tc[k], rc[k], LOGIT_ATOL)
    V = tcfg.vocab_size
    for _ in range(5):
        _close(tlog[:, :V], np.asarray(rlog)[:, :V], LOGIT_ATOL)
        tok = np.asarray(rlog)[:, :V].argmax(-1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(tlog[:, :V].argmax(-1).numpy(), tok[:, 0])
        k_before = tc["k"]
        rlog, rc = RE.decode_step(rcfg, PLAN, rp, rc, jnp.asarray(tok))
        tlog, tc = TE.decode_step(tcfg, tp, tc, torch.from_numpy(tok))
        assert tc["k"] is k_before  # written in place
        for k in rc:
            _close(tc[k], rc[k], LOGIT_ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_facade_serves_the_family(flat, dtype):
    """``Model.prefill`` takes ``enc`` beside the tokens and refuses
    ``valid_len``; ``cache_specs`` sizes the cross cache by ``enc_len``;
    compute_params keeps ``dec/lnx`` and the final norms in fp32 and
    casts ``pos_embed`` and the cross weights, bit-identical to casting
    at every use."""
    _, tcfg = _cfgs(dtype)
    model = Model(tcfg, device="cpu")
    tp = from_reference(flat, tcfg, "cpu")
    cp = model.compute_params(tp)
    dt = getattr(torch, dtype)
    for k, v in cp.items():
        fp32 = k.split("/")[-1] in ("ln1", "ln2", "lnx", "final_ln", "unembed")
        assert v.dtype == (torch.float32 if fp32 else dt), k
    enc, toks = _inputs(2, tcfg, B=1, Se=30, Sd=6)
    inputs = {"enc": torch.from_numpy(enc), "tokens": torch.from_numpy(toks)}
    with torch.inference_mode():
        a, ca = model.prefill(tp, inputs, cache_len=16)
        b, cb = model.prefill(cp, inputs, cache_len=16)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    specs = model.cache_specs(1, 16, enc_len=30)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cb.items()} == \
        {k: (s.shape, s.dtype) for k, s in specs.items()}
    assert model.cache_specs(1, 16)["xk"].shape[2] == 16  # enc_len defaults to cache_len
    with pytest.raises(ValueError, match="valid_len"):
        model.prefill(cp, inputs, cache_len=16, valid_len=torch.tensor([3]))
    assert not model.supports_paged


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_reference_engine(rt, port_rt, paged):
    """Greedy tokens through the port's engine equal those of the
    reference's ``build_engine("whisper_small", smoke=True, ...)`` on its
    own params and side inputs (64 zero encoder frames): dense slots,
    also when pages are asked for (the encdec family falls back to dense
    slots on both sides); more requests than slots."""
    kw = dict(max_batch=2, cache_len=64, max_new_tokens=6, paged=paged)
    reng = build_engine("whisper_small", True, "futurized", {**kw, "name": f"ref-ed-{paged}"})
    assert not reng.paged
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (1, 5, 17, 3, 30)]
    want = [f.get(timeout=300) for f in [reng.submit(p) for p in prompts]]
    cfg = get_config("whisper_small", smoke=True)
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in reng.params.items()}, cfg, "cpu")
    eng = Engine(model, params, ServeConfig(**kw, name=f"port-ed-{paged}"),
                 extra_inputs=default_extra_inputs(cfg, "cpu"), device="cpu")
    assert not eng.paged and not eng._bucketed
    assert tuple(eng.backend.cache["xk"].shape) == (cfg.dec_layers, 2, 64, cfg.num_kv_heads,
                                                    cfg.head_dim)
    got = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    assert got == want


def test_default_extra_inputs_match_reference():
    from repro.serve.router import default_extra_inputs as ref_extra

    cfg = get_config("whisper_small", smoke=True)
    got, want = default_extra_inputs(cfg, "cpu"), ref_extra(cfg)
    assert got.keys() == want.keys() and got["enc_len"] == want["enc_len"] == 64
    assert got["enc"].dtype == torch.bfloat16 and got["enc"].device.type == "cpu"
    np.testing.assert_array_equal(got["enc"].float().numpy(),
                                  np.asarray(want["enc"], np.float32))
