"""The port's MoE family (``repro_torch.models.moe`` and the MoE decoder in
``transformer``) against the reference at the deepseek_moe_16b smoke config
(a leading dense layer, 2 shared + 8 routed experts, top-2) and the
granite_moe_3b_a800m smoke config (5 experts, top-2, tied embeddings), on
the reference's own params carried across by ``from_reference``: the MoE
layer with and without capacity drops, the ports of ``test_moe.py``'s
three invariants, the models' logits and loss, greedy tokens through the
paged engine (and the dense-slot seed baseline) against the reference
engine's, and the one-tensor-at-a-time serving params.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: fp32 ``test_kernels.py::_tol`` (2e-5) on the MoE layer — the
same routing and the same fp32 products in another summation order; 1e-4
on logits and loss (``test_torch_models.py``'s fp32 limit: two layers and
the unembedding).  Routing takes a discrete top-k, so a near-tie could
flip it; the inputs here leave every top-k margin far above fp32's
rounding, which each test asserts.  ``test_moe.py``'s dense-expert
check runs the layer in bf16 against an fp32 oracle, so its bf16 router
can flip a near-tie there: the port's version leaves out tokens whose
top-k margin is below bf16 resolution (2⁻⁸ of the probability).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.dist.plan import get_plan
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build
from repro.models.params import init_params as ref_init_params
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs import get_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import Engine, ServeConfig

PLAN = get_plan("futurized")
ARCHS = ["deepseek_moe_16b", "granite_moe_3b_a800m"]
MOE_ATOL = 2e-5
MODEL_ATOL = 1e-4
BF16_MARGIN = 2.0 ** -8


def _cfgs(arch, dtype="float32", **kw):
    return (replace(ref_config(arch, smoke=True), dtype=dtype, **kw),
            replace(get_config(arch, smoke=True), dtype=dtype, **kw))


def _layer(cfg, seed):
    """One MoE layer's reference params (the layers dim dropped), numpy."""
    p = ref_init_params(RM.moe_param_specs(cfg, 1, ""), jax.random.PRNGKey(seed))
    return {k: np.asarray(v[0], np.float32) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _drops(cfg, x, router):
    """Assignments the port sends to the trap row, and the smallest fp32
    top-k margin (the k-th probability over the (k+1)-th, relative)."""
    xt, router = torch.from_numpy(x.reshape(-1, cfg.d_model).copy()), torch.from_numpy(router.copy())
    _, gate_i, _ = TM.route(cfg, xt, router)
    C = TM.capacity(cfg, gate_i.numel())
    slots = TM.dispatch_slots(cfg, gate_i, C)
    probs = torch.softmax(xt @ router, -1).sort(-1, descending=True).values
    margin = (probs[:, cfg.top_k - 1] - probs[:, cfg.top_k]) / probs[:, cfg.top_k - 1]
    return int((slots == cfg.n_experts * C).sum()), float(margin.min())


# ------------------------------------------------------------------ the layer
@pytest.mark.parametrize("capacity_factor", [None, 64.0])  # drops / none
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, capacity_factor):
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    rcfg, tcfg = _cfgs(arch, **kw)
    p = _layer(rcfg, 2)
    rng = np.random.default_rng(7)
    # a direction shared by every token skews the routing, so that the
    # default capacity drops
    x = (rng.standard_normal((4, 48, rcfg.d_model))
         + rng.standard_normal(rcfg.d_model)).astype(np.float32)
    drops, margin = _drops(tcfg, x, p["router"])
    assert (drops > 0) == (capacity_factor is None), drops
    assert margin > 1e-4  # no near-tie in fp32
    ry, raux = RM.moe_ffn(rcfg, PLAN, jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    ty, taux = TM.moe_ffn(tcfg, torch.from_numpy(x.copy()), _torch(p))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=MOE_ATOL)
    assert abs(float(taux) - float(raux)) <= MOE_ATOL


def test_capacity_and_slots_follow_the_reference_rule():
    """C = max(int(cf·A/E), min(A, 16), 1); ranks in token order, the
    overflow of an expert to the trap row E·C."""
    _, cfg = _cfgs("granite_moe_3b_a800m")
    assert [TM.capacity(cfg, a) for a in (1, 8, 16, 64, 256)] == [1, 8, 16, 16, 64]
    assert TM.capacity(replace(cfg, capacity_factor=1e-6), 4) == 4
    gate_i = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]])  # expert 0 four times
    slots = TM.dispatch_slots(cfg, gate_i, 3)
    E, C = cfg.n_experts, 3
    assert slots.tolist() == [0, 3, 1, 6, 2, 4, 9, E * C]


@pytest.mark.parametrize("seed,B", [(0, 1), (1, 2), (2, 3), (47867, 2)])
def test_moe_matches_dense_expert_computation(seed, B):
    """test_moe.py: with no drops, dispatch → GEMMs → combine equals the
    direct per-token mixture Σ_k w_k·expert_k(x), computed densely in fp32
    (tokens whose top-k margin is below bf16 resolution left out)."""
    _, cfg = _cfgs("deepseek_moe_16b", dtype="bfloat16", capacity_factor=64.0,
                   n_shared_experts=0)
    p = _layer(cfg, seed)
    S, D = 8, cfg.d_model
    x = (np.random.default_rng(seed).standard_normal((B, S, D)) * 0.3).astype(np.float32)
    y, aux = TM.moe_ffn(cfg, torch.from_numpy(x), _torch(p))

    xt = torch.from_numpy(x.reshape(-1, D))
    probs = torch.softmax(xt @ torch.from_numpy(p["router"].copy()), -1)
    srt = probs.sort(-1, descending=True).values
    keep = (srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]) > BF16_MARGIN * srt[:, cfg.top_k - 1]
    assert keep.sum() >= keep.numel() // 2
    w, idx = torch.topk(probs, cfg.top_k, -1)
    w = w / w.sum(-1, keepdim=True)
    tp = _torch(p)
    dense = torch.stack([(torch.nn.functional.silu(xt @ tp["w_gate"][e]) * (xt @ tp["w_in"][e]))
                         @ tp["w_out"][e] for e in range(cfg.n_experts)], 1)  # (T, E, D)
    mix = torch.einsum("tk,tkd->td", w, dense.gather(1, idx[..., None].expand(-1, -1, D)))
    np.testing.assert_allclose(y.reshape(-1, D).float()[keep].numpy(), mix[keep].numpy(),
                               atol=5e-2, rtol=5e-2)
    # E·Σ f_e·P_e ≈ 1 near balance; top-k vs softmax skew keeps it positive
    assert 0.3 < float(aux) < float(cfg.n_experts)


def test_capacity_drops_are_bounded():
    """test_moe.py: with cf → 0 the layer drops (does not corrupt) the
    overflow; the capacity floor min(A, 16) keeps some outputs non-zero."""
    _, cfg = _cfgs("granite_moe_3b_a800m", dtype="bfloat16", capacity_factor=1e-6)
    p = _layer(cfg, 0)
    x = np.random.default_rng(0).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    drops, _ = _drops(cfg, x, p["router"])
    assert drops > 0
    y, _ = TM.moe_ffn(cfg, torch.from_numpy(x), _torch(p))
    assert torch.isfinite(y).all() and float(y.abs().max()) > 0


def test_shared_experts_always_contribute():
    """test_moe.py: the shared experts add to every token, drops or not."""
    _, cfg = _cfgs("deepseek_moe_16b", dtype="bfloat16", capacity_factor=1e-6)
    p = _torch(_layer(cfg, 0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, cfg.d_model)).astype(np.float32))
    y_with, _ = TM.moe_ffn(cfg, x, p)
    y_without, _ = TM.moe_ffn(cfg, x, {**p, "shared_w_out": torch.zeros_like(p["shared_w_out"])})
    assert float((y_with - y_without).abs().max()) > 1e-4


# ------------------------------------------------------------------ the model
@pytest.fixture(scope="module", params=ARCHS)
def moe_model(request):
    """The reference's and the port's MoE smoke model in fp32 on the same
    params (non-trivial norm scales)."""
    rcfg, tcfg = _cfgs(request.param)
    rmodel = ref_build(rcfg, PLAN)
    rng = np.random.default_rng(3)
    flat = {k: np.asarray(v, np.float32) for k, v in rmodel.init(jax.random.PRNGKey(1)).items()}
    for k in flat:
        if k.endswith(("ln1", "ln2", "final_ln")):
            flat[k] = 1.0 + 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
    model = Model(tcfg, device="cpu")
    return rmodel, flat, model, from_reference(flat, tcfg, "cpu")


def test_param_layout_matches_reference(moe_model):
    rmodel, flat, model, params = moe_model
    assert {k: tuple(s.shape) for k, s in model.param_specs().items()} == \
        {k: tuple(s.shape) for k, s in rmodel.param_specs().items()}
    fd = model.cfg.first_dense
    assert any(k.startswith("d0/") for k in params) == (fd > 0)
    assert params["blk/moe/w_in"].shape[0] == model.cfg.moe_layer_count


def test_forward_and_loss_match_reference(moe_model):
    rmodel, flat, model, params = moe_model
    rcfg, cfg = rmodel.cfg, model.cfg
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    rp = {k: jnp.asarray(v) for k, v in flat.items()}
    rl, raux = RT.forward(rcfg, PLAN, rp, jnp.asarray(toks[:, :-1]))
    with torch.no_grad():
        tl, taux = TT.forward(cfg, params, torch.from_numpy(toks[:, :-1]))
        tloss = model.loss(params, {"tokens": torch.from_numpy(toks)})
    V = cfg.vocab_size
    np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(rl)[..., :V], atol=MODEL_ATOL)
    assert float(taux) > 0 and abs(float(taux) - float(raux)) <= MODEL_ATOL
    rloss = rmodel.loss(rp, {"tokens": jnp.asarray(toks)})
    assert abs(float(tloss) - float(rloss)) <= MODEL_ATOL


def test_prefill_and_paged_decode_match_reference(moe_model):
    """Right-padded prefill (valid_len) into the dense cache, then one paged
    decode step on pools holding the prefill's K/V; the d0/ stack keeps
    its own k0/v0."""
    rmodel, flat, model, params = moe_model
    rcfg, cfg = rmodel.cfg, model.cfg
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    vl = np.array([16, 11], np.int32)
    rp = {k: jnp.asarray(v) for k, v in flat.items()}
    rlog, rc = RT.prefill(rcfg, PLAN, rp, jnp.asarray(toks), cache_len=32,
                          valid_len=jnp.asarray(vl))
    with torch.inference_mode():
        tlog, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache_len=32,
                                 valid_len=torch.from_numpy(vl))
    V = cfg.vocab_size
    np.testing.assert_allclose(tlog[:, :V].numpy(), np.asarray(rlog)[:, :V], atol=MODEL_ATOL)
    assert set(tc) == set(rc)
    for k in tc:
        np.testing.assert_allclose(tc[k].float().numpy(), np.asarray(rc[k], np.float32),
                                   atol=MODEL_ATOL, err_msg=k)
    # the prefill's K/V in pages 1.. (page 0 is scratch), one decode step
    page, maxp = 8, 4
    pools = {k: np.zeros((v.shape[0], 1 + 2 * maxp, page) + v.shape[3:], np.float32)
             for k, v in tc.items() if k != "pos"}
    pt = np.zeros((2, maxp), np.int32)
    for b in range(2):
        pt[b] = 1 + b * maxp + np.arange(maxp)
        for k in pools:
            pools[k][:, pt[b]] = tc[k][:, b].numpy().reshape(-1, maxp, page, *pools[k].shape[3:])
    tok = rng.integers(1, V, size=(2, 1)).astype(np.int32)
    rcache = {**{k: jnp.asarray(v) for k, v in pools.items()},
              "page_table": jnp.asarray(pt), "pos": jnp.asarray(vl)}
    tcache = {**{k: torch.from_numpy(v.copy()) for k, v in pools.items()},
              "page_table": torch.from_numpy(pt), "pos": torch.from_numpy(vl.copy())}
    rlog2, rnew = RT.decode_step_paged(rcfg, PLAN, rp, rcache, jnp.asarray(tok))
    with torch.inference_mode():
        tlog2, tnew = model.decode_paged(params, tcache, torch.from_numpy(tok))
    np.testing.assert_allclose(tlog2[:, :V].numpy(), np.asarray(rlog2)[:, :V], atol=MODEL_ATOL)
    for k in pools:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(rnew[k]), atol=MODEL_ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(tnew["pos"].numpy(), np.asarray(rnew["pos"]))


# ----------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def test_paged_engine_matches_reference_engine(rt, port_rt):
    """Greedy tokens of deepseek_moe_16b smoke through the port's paged
    engine with pipelined, bucketed (right-padded) admission equal the
    reference engine's: the pad tokens route and take capacity on both
    sides (prompts of 4–40 tokens: buckets 16, 32 and 64), with more
    requests than slots."""
    rcfg, cfg = _cfgs("deepseek_moe_16b")
    rmodel = ref_build(rcfg, PLAN)
    rparams = rmodel.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (4, 20, 40, 9, 33)]
    kw = dict(max_batch=2, cache_len=96, max_new_tokens=6)
    reng = RefEngine(rmodel, rparams, RefServeConfig(**kw, name="ref-moe"))
    want = [f.get(timeout=300) for f in [reng.submit(p) for p in prompts]]
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    eng = Engine(model, params, ServeConfig(**kw, name="port-moe"), device="cpu")
    assert eng.paged and eng._bucketed
    got = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    assert got == want
    assert set(eng.kv.pools) == {"k", "v", "k0", "v0"}


def test_dense_slot_engine_matches_reference_engine(rt, port_rt):
    """The seed baseline for the MoE family (dense per-slot cache with
    ``k0``/``v0``, inline prefill at the exact prompt length): the port's
    greedy tokens equal the reference engine's in the same mode."""
    rcfg, cfg = _cfgs("deepseek_moe_16b")
    rmodel = ref_build(rcfg, PLAN)
    rparams = rmodel.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (3, 17, 30)]
    kw = dict(max_batch=2, cache_len=64, max_new_tokens=5, paged=False,
              pipeline_admission=False)
    reng = RefEngine(rmodel, rparams, RefServeConfig(**kw, name="ref-moe-dense"))
    want = [f.get(timeout=300) for f in [reng.submit(p) for p in prompts]]
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    eng = Engine(model, params, ServeConfig(**kw, name="port-moe-dense"), device="cpu")
    assert not eng.paged and set(eng.backend.cache) == {"k", "v", "k0", "v0", "pos"}
    got = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    assert got == want


# ------------------------------------------------------------- serving params
@pytest.mark.parametrize("arch,dtype", [("deepseek_moe_16b", "bfloat16"),
                                        ("granite_moe_3b_a800m", "bfloat16"),
                                        ("mamba2_780m", "bfloat16"),
                                        ("starcoder2_3b", "float32"),
                                        ("whisper_small", "bfloat16"),
                                        ("internvl2_2b", "bfloat16")])
def test_init_compute_equals_compute_params_of_init(arch, dtype):
    """The serving params drawn one tensor at a time are
    ``compute_params(init(seed))`` bit for bit."""
    model = Model(replace(get_config(arch, smoke=True), dtype=dtype), device="cpu")
    want = model.compute_params(model.init(3))
    got = model.init_compute(3)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
