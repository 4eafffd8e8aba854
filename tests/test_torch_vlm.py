"""The port's VLM family (the dense decoder with patch embeddings spliced
over its first ``n_patches`` positions) against the reference at the
internvl2_2b smoke config, on the reference's own params carried across
by ``from_reference`` (norm scales made non-trivial): the splice and the
loss mask, a bucketed prefill with ``valid_len`` and patches, paged decode
steps after it, and greedy tokens through the port's paged engine against
the reference engine's.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances are those of ``test_torch_models.py``: fp32 1e-4 — the same
math in another summation order.  Greedy tokens are exact.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.dist.plan import get_plan
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.router import build_engine
from repro.serve.router import default_extra_inputs as ref_extra_inputs
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.router import default_extra_inputs

PLAN = get_plan("futurized")
ATOL = 1e-4
NORMS = ("ln1", "ln2", "final_ln")


def _cfgs(dtype="float32"):
    return (replace(ref_config("internvl2_2b", smoke=True), dtype=dtype),
            replace(get_config("internvl2_2b", smoke=True), dtype=dtype))


@pytest.fixture(scope="module")
def vlm():
    rcfg, tcfg = _cfgs()
    params = ref_build(rcfg, PLAN).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    flat = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for k, v in flat.items():
        if k.split("/")[-1] in NORMS:
            flat[k] = 1.0 + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
    return rcfg, tcfg, {k: jnp.asarray(v) for k, v in flat.items()}, \
        from_reference(flat, tcfg, "cpu")


def _close(t: torch.Tensor, j, atol: float = ATOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol)


def _draw(seed, cfg, B, S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return toks, patches


def test_splice_and_loss_mask_match(vlm):
    """The forward with patches over the first n_patches positions, and the
    loss that skips those positions' labels, against the reference; the
    token ids under the patches do not matter."""
    rcfg, tcfg, rp, tp = vlm
    toks, patches = _draw(0, tcfg, 2, 21)
    rl, _ = RT.forward(rcfg, PLAN, rp, jnp.asarray(toks), patches=jnp.asarray(patches))
    tl, _ = TT.forward(tcfg, tp, torch.from_numpy(toks), patches=torch.from_numpy(patches))
    V = tcfg.vocab_size
    _close(tl[..., :V], np.asarray(rl)[..., :V])
    other = toks.copy()
    other[:, : tcfg.n_patches] = 1
    tl2, _ = TT.forward(tcfg, tp, torch.from_numpy(other), patches=torch.from_numpy(patches))
    torch.testing.assert_close(tl2, tl, rtol=0, atol=0)
    batch = {"tokens": toks, "patches": patches}
    rloss = ref_build(rcfg, PLAN).loss(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = Model(tcfg, device="cpu").loss(tp, {k: torch.from_numpy(v)
                                                for k, v in batch.items()})
    assert abs(float(tloss) - float(rloss)) <= ATOL, (float(tloss), float(rloss))
    # the mask: the unmasked mean differs, the masked one is the mean over
    # the labels from position n_patches on
    lg = tl[:, :-1, :]
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, torch.from_numpy(toks[:, 1:]).long()[..., None])[..., 0]
    want = nll[:, tcfg.n_patches:].mean()
    assert abs(float(tloss) - float(want)) <= 1e-5
    assert abs(float(nll.mean()) - float(want)) > 1e-3


def test_forward_needs_patches(vlm):
    _, tcfg, _, tp = vlm
    with pytest.raises(ValueError, match="patch"):
        TT.forward(tcfg, tp, torch.ones(1, 12, dtype=torch.long))


def test_bucketed_prefill_with_patches_then_paged_decode_match(vlm):
    """Two prompts right-padded into one bucket with valid_len and patches
    (the engine's admission), then 3 paged decode steps against the same
    pools: logits, caches and positions against the reference."""
    rcfg, tcfg, rp, tp = vlm
    B, S, T = 2, 24, 32
    toks, patches = _draw(1, tcfg, B, S)
    vl = np.asarray([S, 13], np.int32)
    rlog, rc = RT.prefill(rcfg, PLAN, rp, jnp.asarray(toks), patches=jnp.asarray(patches),
                          cache_len=T, valid_len=jnp.asarray(vl))
    model = Model(tcfg, device="cpu")
    tlog, tc = model.prefill(tp, {"tokens": torch.from_numpy(toks),
                                  "patches": torch.from_numpy(patches)},
                             cache_len=T, valid_len=torch.from_numpy(vl))
    V = tcfg.vocab_size
    _close(tlog[:, :V], np.asarray(rlog)[:, :V])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
    for k in ("k", "v"):
        _close(tc[k], rc[k])
    # the pools: each request's prefill K/V in its own pages
    page, maxp, L = 16, 4, tcfg.num_layers
    KV, Dh = tcfg.num_kv_heads, tcfg.head_dim
    P = B * maxp + 1
    pt = (1 + np.arange(B * maxp)).reshape(B, maxp).astype(np.int32)
    pools = np.zeros((2, L, P, page, KV, Dh), np.float32)
    for n, name in enumerate(("k", "v")):
        dense = np.asarray(rc[name])  # (L, B, T, KV, Dh)
        for b in range(B):
            for j in range(T // page):
                pools[n, :, pt[b, j]] = dense[:, b, j * page:(j + 1) * page]
    rcache = {"k": jnp.asarray(pools[0]), "v": jnp.asarray(pools[1]),
              "page_table": jnp.asarray(pt), "pos": jnp.asarray(vl)}
    tcache = {"k": torch.from_numpy(pools[0].copy()), "v": torch.from_numpy(pools[1].copy()),
              "page_table": torch.from_numpy(pt), "pos": torch.from_numpy(vl.copy())}
    for _ in range(3):
        tok = np.asarray(rlog)[:, :V].argmax(-1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(tlog[:, :V].argmax(-1).numpy(), tok[:, 0])
        rlog, rcache = RT.decode_step_paged(rcfg, PLAN, rp, rcache, jnp.asarray(tok))
        tlog, tcache = model.decode_paged(tp, tcache, torch.from_numpy(tok))
        _close(tlog[:, :V], np.asarray(rlog)[:, :V])
        np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(rcache["pos"]))
        _close(tcache["k"], rcache["k"])


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def _engines(kw, tag, dtype="bfloat16"):
    """The reference's engine as ``build_engine("internvl2_2b", smoke=True,
    ...)`` makes it (params from PRNGKey(0), its default side inputs), in
    ``dtype``, and the port's on the same params and side inputs."""
    if dtype == "bfloat16":
        reng = build_engine("internvl2_2b", True, "futurized", {**kw, "name": f"ref-{tag}"})
    else:
        rcfg = replace(ref_config("internvl2_2b", smoke=True), dtype=dtype)
        rmodel = ref_build(rcfg, PLAN)
        reng = RefEngine(rmodel, rmodel.init(jax.random.PRNGKey(0)),
                         RefServeConfig(**kw, name=f"ref-{tag}"),
                         extra_inputs=ref_extra_inputs(rcfg))
    cfg = replace(get_config("internvl2_2b", smoke=True), dtype=dtype)
    params = from_reference({k: np.asarray(v) for k, v in reng.params.items()}, cfg, "cpu")
    eng = Engine(Model(cfg, device="cpu"), params, ServeConfig(**kw, name=f"port-{tag}"),
                 extra_inputs=default_extra_inputs(cfg, "cpu"), device="cpu")
    return reng, eng, cfg


def test_paged_engine_matches_reference_engine(rt, port_rt):
    """Greedy tokens of the port's paged engine with bucketed admission
    (prompts of 8–40 tokens: buckets 16, 32 and 64, the zero patches over
    the first 8 positions) equal those of the reference's engine as
    ``build_engine("internvl2_2b", smoke=True, ...)`` makes it, in fp32;
    more requests than slots.  In bf16 (build_engine's own dtype) the two
    sides round at other points, and on this draw one request's fourth
    token has its top three logits within 0.01, well inside the bf16
    logit limit of ``test_torch_models.py`` (1e-1): a near-tie that bf16
    rounding decides either way, so token equality holds in fp32."""
    kw = dict(max_batch=2, cache_len=96, max_new_tokens=6)
    reng, eng, cfg = _engines(kw, "vlm", dtype="float32")
    assert reng.paged and eng.paged and eng._bucketed
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (8, 20, 40, 9, 33)]
    want = [f.get(timeout=300) for f in [reng.submit(p) for p in prompts]]
    got = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    assert got == want


def test_short_prompt_raises(rt, port_rt):
    """A prompt shorter than n_patches fails its request with ValueError,
    as in the reference; the engine goes on serving the others."""
    kw = dict(max_batch=2, cache_len=64, max_new_tokens=3)
    reng, eng, cfg = _engines(kw, "vlm-short")
    for e in (reng, eng):
        bad = e.submit([5] * (cfg.n_patches - 1))
        good = e.submit([5] * cfg.n_patches)
        with pytest.raises(ValueError, match="vlm prompt"):
            bad.get(timeout=300)
        assert len(good.get(timeout=300)) == 4


def test_default_extra_inputs_match_reference():
    cfg = get_config("internvl2_2b", smoke=True)
    got, want = default_extra_inputs(cfg, "cpu"), ref_extra_inputs(cfg)
    assert got.keys() == want.keys() == {"patches"}
    assert got["patches"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["patches"].float().numpy(),
                                  np.asarray(want["patches"], np.float32))
