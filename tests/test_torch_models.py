"""The port's dense decoder against the reference at the starcoder2_3b
smoke config, on the reference's own params carried across by
``from_reference``.  The reference runs once with ``attn_impl="pallas"``
(its flash/paged kernels in interpret mode) and once with ``"xla"``.
For every ported smoke config, the full forward and the loss are held
against the reference's in fp32, and the ports of
``test_models_smoke.py``'s shape test and ``test_models_consistency.py``'s
prefill/decode-vs-forward tests hold the port against its own full
forward.

Tolerances: fp32 1e-4 — the same math in another summation order, with
fp32 softmax on both sides (the xla path's own fp32 einsums differ from
the kernels' by less than that).  bf16 5e-2 on activations and 1e-1 on
logits — each side rounds to bf16 after every matmul, norm and
activation, at slightly different points (e.g. the xla path casts the
softmax to bf16 before P·V; torch's bf16 GELU computes in fp32), and the
logits carry that through two layers and the unembedding.
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
from repro.models import hybrid as RH
from repro.models import layers as RL
from repro.models import ssm_lm as RS
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import encdec as TE
from repro_torch.models import hybrid as TH
from repro_torch.models import layers as TL
from repro_torch.models import ssm_lm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.models.params import from_reference

PLAN = get_plan("futurized")
IMPLS = ["pallas", "xla"]
DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOGIT_ATOL = {"float32": 1e-4, "bfloat16": 1e-1}


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_config("starcoder2_3b", smoke=True)
    params = ref_build(cfg, PLAN).init(jax.random.PRNGKey(1))
    # non-trivial norm scales and biases (the init makes them ones/zeros)
    rng = np.random.default_rng(3)
    flat = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for k in flat:
        if k.endswith(("ln1", "ln2", "final_ln")):
            flat[k] = 1.0 + 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
        elif k.split("/")[-1] in ("bq", "bk", "bv"):
            flat[k] = 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
    return flat


def _cfgs(impl: str, dtype: str):
    rcfg = replace(ref_config("starcoder2_3b", smoke=True), attn_impl=impl, dtype=dtype)
    tcfg = replace(get_config("starcoder2_3b", smoke=True), dtype=dtype)
    return rcfg, tcfg


def _both(flat, cfg_t):
    return ({k: jnp.asarray(v) for k, v in flat.items()},
            from_reference(flat, cfg_t, "cpu"))


def _layer0(params):
    return {k[4:]: v[0] for k, v in params.items() if k.startswith("blk/")}


def _close(t: torch.Tensor, j, atol: float):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol)


def _act(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def test_from_reference_is_one_to_one(ref_params):
    _, tcfg = _cfgs("xla", "float32")
    tp = from_reference(ref_params, tcfg, "cpu")
    assert set(tp) == set(TT.decoder_param_specs(tcfg)) == set(ref_params)
    for k, v in ref_params.items():
        assert tuple(tp[k].shape) == v.shape and tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), v)
    with pytest.raises(KeyError):
        from_reference({k: v for k, v in ref_params.items() if k != "lm_head"},
                       tcfg, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_rope_mlp_match(ref_params, dtype):
    rcfg, tcfg = _cfgs("xla", dtype)
    rp, tp = _both(ref_params, tcfg)
    rl, tl = _layer0(rp), _layer0(tp)
    rng = np.random.default_rng(0)
    B, S, D = 2, 12, tcfg.d_model
    xj, xt = _act(rng, (B, S, D), dtype)
    _close(TL.norm(tcfg, xt, tl["ln1"]), RL.norm(rcfg, xj, rl["ln1"]), ATOL[dtype])
    bias = rng.standard_normal(D).astype(np.float32)
    _close(TL.norm(tcfg, xt, tl["ln1"], torch.from_numpy(bias)),
           RL.norm(rcfg, xj, rl["ln1"], jnp.asarray(bias)), ATOL[dtype])
    _close(TL.mlp(tcfg, xt, tl, ""), RL.mlp(rcfg, PLAN, xj, rl, ""), ATOL[dtype])
    H, Dh = tcfg.num_heads, tcfg.head_dim
    hj, ht = _act(rng, (B, S, H, Dh), dtype)
    pos = np.arange(S, dtype=np.int32) + 37
    cj, sj = RL.rope_tables(rcfg, jnp.asarray(pos), Dh)
    ct, st = TL.rope_tables(tcfg, torch.from_numpy(pos), Dh)
    _close(ct, cj, 1e-5)
    _close(st, sj, 1e-5)
    _close(TL.apply_rope(ht, ct, st), RL.apply_rope(hj, cj, sj), ATOL[dtype])
    pb = np.asarray([3, 90], np.int32)
    _close(TL._rope_single(tcfg, ht[:, 0], torch.from_numpy(pb)),
           RL._rope_single(rcfg, hj[:, 0], jnp.asarray(pb)), ATOL[dtype])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_matches(ref_params, impl, dtype):
    rcfg, tcfg = _cfgs(impl, dtype)
    rp, tp = _both(ref_params, tcfg)
    rng = np.random.default_rng(1)
    B, S = 2, 20
    xj, xt = _act(rng, (B, S, tcfg.d_model), dtype)
    pos = np.arange(S, dtype=np.int32)
    ro, (rk, rv) = RL.attention(rcfg, PLAN, xj, _layer0(rp), "", jnp.asarray(pos),
                                return_kv=True)
    to, (tk, tv) = TL.attention(tcfg, xt, _layer0(tp), "", torch.from_numpy(pos),
                                return_kv=True)
    _close(to, ro, ATOL[dtype])
    _close(tk, rk, ATOL[dtype])
    _close(tv, rv, ATOL[dtype])


def _paged_state(tcfg, rng, B=3, page=16, maxp=4):
    KV, Dh = tcfg.num_kv_heads, tcfg.head_dim
    P = B * maxp + 2
    kp = rng.standard_normal((P, page, KV, Dh)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, Dh)).astype(np.float32)
    pt = (1 + rng.permutation(P - 1)[: B * maxp].reshape(B, maxp)).astype(np.int32)
    pos = np.asarray([0, 17, 63], np.int32)[:B]
    return kp, vp, pt, pos


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_matches(ref_params, impl, dtype):
    rcfg, tcfg = _cfgs(impl, dtype)
    rp, tp = _both(ref_params, tcfg)
    rng = np.random.default_rng(2)
    kp, vp, pt, pos = _paged_state(tcfg, rng)
    xj, xt = _act(rng, (3, 1, tcfg.d_model), dtype)
    kpj, kpt = _act(np.random.default_rng(5), kp.shape, dtype)
    vpj, vpt = _act(np.random.default_rng(6), vp.shape, dtype)
    ro, rk, rv = RL.paged_decode_attention(rcfg, PLAN, xj, _layer0(rp), "", kpj, vpj,
                                           jnp.asarray(pt), jnp.asarray(pos))
    to, tk, tv = TL.paged_decode_attention(tcfg, xt, _layer0(tp), "", kpt, vpt,
                                           torch.from_numpy(pt), torch.from_numpy(pos))
    assert tk is kpt and tv is vpt  # written in place
    _close(to, ro, ATOL[dtype])
    _close(tk, rk, ATOL[dtype])
    _close(tv, rv, ATOL[dtype])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_prefill_decode_match(ref_params, impl, dtype):
    rcfg, tcfg = _cfgs(impl, dtype)
    rp, tp = _both(ref_params, tcfg)
    rng = np.random.default_rng(4)
    B, S = 2, 24
    toks = rng.integers(1, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    # forward
    rl, _ = RT.forward(rcfg, PLAN, rp, jnp.asarray(toks))
    tl, _ = TT.forward(tcfg, tp, torch.from_numpy(toks))
    assert tl.shape == (B, S, tcfg.padded_vocab) and tl.dtype == torch.float32
    _close(tl[..., : tcfg.vocab_size], rl[..., : tcfg.vocab_size], LOGIT_ATOL[dtype])
    # prefill of right-padded prompts with valid_len
    vl = np.asarray([S, 13], np.int32)
    rlog, rc = RT.prefill(rcfg, PLAN, rp, jnp.asarray(toks), cache_len=32,
                          valid_len=jnp.asarray(vl))
    tlog, tc = TT.prefill(tcfg, tp, torch.from_numpy(toks), cache_len=32,
                          valid_len=torch.from_numpy(vl))
    _close(tlog[:, : tcfg.vocab_size], rlog[:, : tcfg.vocab_size], LOGIT_ATOL[dtype])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
    assert tuple(tc["k"].shape) == rc["k"].shape
    _close(tc["k"], rc["k"], ATOL[dtype])
    _close(tc["v"], rc["v"], ATOL[dtype])
    # one paged decode step against the same pools
    L, page, maxp = tcfg.num_layers, 16, 4
    kp, vp, pt, pos = _paged_state(tcfg, rng, B=2, maxp=maxp)
    pools = rng.standard_normal((2, L) + kp.shape).astype(np.float32)
    tok = rng.integers(1, tcfg.vocab_size, size=(2, 1)).astype(np.int32)
    rcache = {"k": jnp.asarray(pools[0], rcfg.dtype), "v": jnp.asarray(pools[1], rcfg.dtype),
              "page_table": jnp.asarray(pt), "pos": jnp.asarray(pos)}
    # the port writes the new K/V into its pools in place: its own copies,
    # since jnp.asarray may share the numpy buffer with the reference's step
    tcache = {"k": torch.from_numpy(pools[0].copy()).to(getattr(torch, dtype)),
              "v": torch.from_numpy(pools[1].copy()).to(getattr(torch, dtype)),
              "page_table": torch.from_numpy(pt), "pos": torch.from_numpy(pos)}
    rlog, rnew = RT.decode_step_paged(rcfg, PLAN, rp, rcache, jnp.asarray(tok))
    tlog, tnew = TT.decode_step_paged(tcfg, tp, tcache, torch.from_numpy(tok))
    _close(tlog[:, : tcfg.vocab_size], rlog[:, : tcfg.vocab_size], LOGIT_ATOL[dtype])
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(rnew["pos"]))
    _close(tnew["k"], rnew["k"], ATOL[dtype])
    _close(tnew["v"], rnew["v"], ATOL[dtype])


def test_compute_params_cast_all_but_norms(ref_params):
    _, tcfg = _cfgs("xla", "bfloat16")
    tp = from_reference(ref_params, tcfg, "cpu")
    cp = TT.compute_params(tcfg, tp)
    assert set(cp) == set(tp) | {"unembed"}
    for k, v in cp.items():
        fp32 = k.endswith(("ln1", "ln2", "final_ln", "unembed"))
        assert v.dtype == (torch.float32 if fp32 else torch.bfloat16), k
    # the unembedding: the bf16 table's values, held in fp32, as (D, Vp)
    table = cp["tok_embed"] if tcfg.tie_embeddings else cp["lm_head"].t()
    torch.testing.assert_close(cp["unembed"], table.float().t(), rtol=0, atol=0)
    # idempotent (the router converts, then the engine converts again)
    again = TT.compute_params(tcfg, cp)
    assert all(again[k] is cp[k] for k in cp)
    toks = torch.randint(1, tcfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(0))
    a, _ = TT.forward(tcfg, tp, toks)
    b, _ = TT.forward(tcfg, cp, toks)
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # bit-identical


@pytest.mark.parametrize("window", [0, 32])  # plain cache (clamped), ring buffer
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_decode_attention_matches(ref_params, window, impl, dtype):
    """One token against the dense (B, T, KV, Dh) cache: the write to slot
    pos mod T (ring) or min(pos, T − 1), and the dense decode kernel's
    plain version over lengths min(pos + 1, T), against the reference's
    mask; rows before, on and past the ring's wrap (or the cache's end)."""
    rcfg, tcfg = _cfgs(impl, dtype)
    rp, tp = _both(ref_params, tcfg)
    rng = np.random.default_rng(8)
    B, T, KV, Dh = 4, 32, tcfg.num_kv_heads, tcfg.head_dim
    pos = np.asarray([0, T - 1, T, 2 * T + 5], np.int32)
    xj, xt = _act(rng, (B, 1, tcfg.d_model), dtype)
    kj, kt = _act(rng, (B, T, KV, Dh), dtype)
    vj, vt = _act(rng, (B, T, KV, Dh), dtype)
    ro, rk, rv = RL.decode_attention(rcfg, PLAN, xj, _layer0(rp), "", kj, vj,
                                     jnp.asarray(pos), window=window)
    to, tk, tv = TL.decode_attention(tcfg, xt, _layer0(tp), "", kt, vt,
                                     torch.from_numpy(pos), window=window)
    assert tk is kt and tv is vt  # written in place
    _close(to, ro, ATOL[dtype])
    _close(tk, rk, ATOL[dtype])
    _close(tv, rv, ATOL[dtype])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_cache_decode_step_matches(ref_params, impl, dtype):
    """The seed baseline's cache: prefill at cache_len, then decode steps
    against the dense (L, B, T, KV, Dh) cache, against the reference."""
    rcfg, tcfg = _cfgs(impl, dtype)
    rp, tp = _both(ref_params, tcfg)
    rng = np.random.default_rng(9)
    B, S, T = 2, 11, 16
    toks = rng.integers(1, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    rlog, rc = RT.prefill(rcfg, PLAN, rp, jnp.asarray(toks), cache_len=T)
    tlog, tc = TT.prefill(tcfg, tp, torch.from_numpy(toks), cache_len=T)
    assert set(tc) == set(TT.init_cache_specs(tcfg, B, T)) == set(rc)
    V = tcfg.vocab_size
    for _ in range(7):  # up to and past the cache's end (clamped)
        tok = np.asarray(rlog).argmax(-1)[:, None].astype(np.int32)
        rlog, rc = RT.decode_step(rcfg, PLAN, rp, rc, jnp.asarray(tok))
        tlog, tc = TT.decode_step(tcfg, tp, tc, torch.from_numpy(tok))
        _close(tlog[:, :V], rlog[:, :V], LOGIT_ATOL[dtype])
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
        _close(tc["k"], rc["k"], ATOL[dtype])
        _close(tc["v"], rc["v"], ATOL[dtype])


def _side_inputs(cfg, rng, B, S):
    """The side inputs of ``cfg``'s family as numpy fp32, the way the
    reference's ``test_models_consistency.py`` draws them: the vlm
    family's patches (B, n_patches, D), the encdec family's frames
    (B, S, D)."""
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"enc": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    return {}


def _port_inputs(side):
    """The side inputs as the port's bf16 tensors (the reference draws them
    in bf16)."""
    return {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in side.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_prefill_decode_shapes(arch):
    """test_models_smoke.py's shape test for each ported architecture: the
    smoke config in its compute dtype (bf16), prefill then one decode
    step, finite logits over the padded vocab, argmax inside the vocab
    (the vlm and encdec families with their side inputs)."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.compute_params(model.init(0))
    B, S = 2, 16
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S)))
    side = _port_inputs(_side_inputs(cfg, rng, B, S))
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": toks, **side}, cache_len=S + 4)
        assert logits.shape == (B, cfg.padded_vocab) and torch.isfinite(logits).all()
        specs = model.cache_specs(B, S + 4, enc_len=S)
        assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == \
            {k: (s.shape, s.dtype) for k, s in specs.items()}
        logits2, cache2 = model.decode(params, cache, torch.zeros(B, 1, dtype=torch.long))
    assert logits2.shape == (B, cfg.padded_vocab) and torch.isfinite(logits2).all()
    # padded vocab columns are masked: argmax must stay within real vocab
    assert int(logits2.argmax(-1).max()) < cfg.vocab_size
    assert cache2["pos"].tolist() == [S + 1] * B


def _forward(cfg, params, tokens, side=None):
    """The port's full forward of ``cfg``'s family → logits (B, S, V);
    ``side``: the family's side inputs (``_port_inputs``)."""
    side = side or {}
    with torch.inference_mode():
        if cfg.family == "encdec":
            return TE.forward(cfg, params, side["enc"], tokens)[0]
        if cfg.family == "vlm":
            return TT.forward(cfg, params, tokens, patches=side["patches"])[0]
        mod = {"ssm": TS, "hybrid": TH}.get(cfg.family, TT)
        return mod.forward(cfg, params, tokens)[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_matches_forward(arch):
    """test_models_consistency.py: prefill + one decode step reproduce the
    full forward's next-token logits, for every ported smoke config in its
    compute dtype (bf16) and the reference's limit 0.05.  The MoE configs
    run with capacity 64, so that nothing drops: capacity drops are the
    one legitimate divergence (test_torch_moe.py).  The vlm family's
    patches and the encdec family's frames (S of them) as the reference's
    test draws them."""
    cfg = get_config(arch, smoke=True)
    if cfg.is_moe:
        cfg = replace(cfg, capacity_factor=64.0)
    model = build_model(cfg, device="cpu")
    params = model.compute_params(model.init(0))
    B, S = 2, 32
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S + 1)))
    side = _port_inputs(_side_inputs(cfg, rng, B, S))
    with torch.inference_mode():
        logits_p, cache = model.prefill(params, {"tokens": tokens[:, :S], **side},
                                        cache_len=S + 8)
        err_p = float((logits_p - _forward(cfg, params, tokens[:, :S], side)[:, -1]).abs().max())
        assert err_p < 0.05, f"{arch} prefill mismatch {err_p}"
        logits_d, _ = model.decode(params, cache, tokens[:, S:S + 1])
        err_d = float((logits_d - _forward(cfg, params, tokens, side)[:, -1]).abs().max())
    assert err_d < 0.05, f"{arch} decode mismatch {err_d}"


def test_multi_step_decode_matches_forward():
    """test_models_consistency.py: 4 tokens decoded one at a time equal the
    forward over the grown sequence (qwen25_3b: GQA with QKV bias)."""
    cfg = get_config("qwen25_3b", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.compute_params(model.init(0))
    B, S, N = 2, 16, 4
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, S + N)))
    with torch.inference_mode():
        _, cache = model.prefill(params, {"tokens": tokens[:, :S]}, cache_len=S + N + 2)
        for t in range(N):
            logits, cache = model.decode(params, cache, tokens[:, S + t:S + t + 1])
            full = _forward(cfg, params, tokens[:, :S + t + 1])[:, -1]
            err = float((logits - full).abs().max())
            assert err < 0.05, f"step {t}: {err}"


NORM_SCALES = ("ln1", "ln2", "lnx", "ln", "gate_ln", "final_ln")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_forward_and_loss_match_reference(arch):
    """Every ported smoke config's logits and loss against the reference's,
    fp32, on the reference's params carried across by ``from_reference``
    (norm scales and QKV biases made non-trivial): granite_34b's single KV
    head, qwen25_3b's QKV bias with RMSNorm, SwiGLU and RoPE theta 1e6,
    the MoE configs' routing, drops and aux loss among them, whisper_small's
    encoder and cross-attention over its frames and internvl2_2b's patches
    and masked image positions.  Limit 1e-4, as the dense decoder's above."""
    rcfg = replace(ref_config(arch, smoke=True), dtype="float32")
    tcfg = replace(get_config(arch, smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, PLAN)
    rng = np.random.default_rng(5)
    flat = {k: np.asarray(v, np.float32) for k, v in rmodel.init(jax.random.PRNGKey(1)).items()}
    for k, v in flat.items():
        if k.split("/")[-1] in NORM_SCALES:
            flat[k] = 1.0 + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        elif k.split("/")[-1] in ("bq", "bk", "bv", "xbq", "xbk", "xbv"):
            flat[k] = 0.1 * rng.standard_normal(v.shape).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in flat.items()}
    tp = from_reference(flat, tcfg, "cpu")
    toks = rng.integers(0, tcfg.vocab_size, size=(2, 25)).astype(np.int32)
    side = _side_inputs(tcfg, rng, 2, 24)
    rside = {k: jnp.asarray(v) for k, v in side.items()}
    tside = {k: torch.from_numpy(v) for k, v in side.items()}
    if rcfg.family == "encdec":
        rl = RE.forward(rcfg, PLAN, rp, rside["enc"], jnp.asarray(toks[:, :-1]))[0]
    elif rcfg.family == "vlm":
        rl = RT.forward(rcfg, PLAN, rp, jnp.asarray(toks[:, :-1]),
                        patches=rside["patches"])[0]
    else:
        rmod = {"ssm": RS, "hybrid": RH}.get(rcfg.family, RT)
        rl = rmod.forward(rcfg, PLAN, rp, jnp.asarray(toks[:, :-1]))[0]
    tl = _forward(tcfg, tp, torch.from_numpy(toks[:, :-1]), tside)
    V = tcfg.vocab_size
    assert tl.shape == (2, 24, tcfg.padded_vocab) and tl.dtype == torch.float32
    _close(tl[..., :V], rl[..., :V], LOGIT_ATOL["float32"])
    rloss = rmodel.loss(rp, {"tokens": jnp.asarray(toks), **rside})
    with torch.inference_mode():
        tloss = build_model(tcfg, device="cpu").loss(tp, {"tokens": torch.from_numpy(toks),
                                                          **tside})
    assert abs(float(tloss) - float(rloss)) <= ATOL["float32"], (float(tloss), float(rloss))
