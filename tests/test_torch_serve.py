"""The port's paged continuous-batching serving stack on the CPU: greedy
token lists equal to the reference's manual greedy decode (fp32, params
carried across by ``from_reference``), admission churn, per-slot
divergence, streaming, sampling by its properties, routing and counters.

Greedy parity is exact (token for token): both sides run fp32 and
``argmax`` takes the first maximal index in both frameworks.  Sampled
decoding cannot match the reference's ``jax.random`` draws and is checked
by its properties instead.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.dist.plan import get_plan
from repro.models.model import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.core import counters
from repro_torch.core.future import ChannelClosed
from repro_torch.models.model import Model
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import (Engine, SamplingParams, ServeConfig,
                                      sample_logits)
from repro_torch.serve.router import Router


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


@pytest.fixture(scope="module")
def served():
    rcfg = replace(ref_config("starcoder2_3b", smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, get_plan("futurized"))
    rparams = rmodel.init(jax.random.PRNGKey(1))
    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32")
    model = Model(cfg, device="cpu")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    cache = {}

    def ref_greedy(prompt, n):
        """The reference's manual greedy decode (test_serve.py)."""
        key = (tuple(prompt), n)
        if key not in cache:
            pin = {"tokens": jnp.asarray(prompt, jnp.int32)[None, :]}
            logits, c = jax.jit(rmodel.prefill, static_argnames=("cache_len",))(
                rparams, pin, cache_len=96)
            out = [int(jnp.argmax(logits, -1)[0])]
            dec = jax.jit(rmodel.decode)
            for _ in range(n):
                logits, c = dec(rparams, c, jnp.asarray([[out[-1]]], jnp.int32))
                out.append(int(jnp.argmax(logits, -1)[0]))
            cache[key] = out
        return cache[key]

    return cfg, model, params, ref_greedy


def _engine(model, params, **kw):
    return Engine(model, params, ServeConfig(**kw), device="cpu")


def test_engine_matches_reference_greedy(port_rt, served):
    cfg, model, params, ref_greedy = served
    prompts = [[5, 6, 7, 8], [100, 3, 50, 2, 9, 11], [42]]
    n = 6
    eng = _engine(model, params, max_batch=2, cache_len=96, max_new_tokens=n)
    outs = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    for p, o in zip(prompts, outs):
        assert o == ref_greedy(p, n), f"prompt {p}"


@pytest.mark.parametrize("arch", ["qwen25_3b", "starcoder2_15b", "granite_34b"])
def test_paged_engine_matches_reference_greedy_on_dense_configs(port_rt, arch):
    """The three dense configs not otherwise served here, each a head layout
    of its own: qwen25_3b (GQA with QKV bias, SwiGLU, RMSNorm),
    starcoder2_15b (GQA, a non-gated GELU MLP, LayerNorm, QKV bias) and
    granite_34b (MQA, one KV head): the paged engine's greedy tokens equal
    the reference's manual prefill-and-decode loop, fp32, the reference's
    params carried across by ``from_reference``."""
    rcfg = replace(ref_config(arch, smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, get_plan("futurized"))
    rparams = rmodel.init(jax.random.PRNGKey(1))
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    params = from_reference({k: np.asarray(v) for k, v in rparams.items()}, cfg, "cpu")
    prefill = jax.jit(rmodel.prefill, static_argnames=("cache_len",))
    dec = jax.jit(rmodel.decode)
    prompts = [[5, 6, 7, 8], [100, 3, 50, 2, 9, 11], [42]]
    n = 6
    eng = _engine(Model(cfg, device="cpu"), params, max_batch=2, cache_len=96,
                  max_new_tokens=n, name=f"{arch}#0")
    outs = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    eng.close()
    for p, o in zip(prompts, outs):
        logits, c = prefill(rparams, {"tokens": jnp.asarray(p, jnp.int32)[None, :]},
                            cache_len=96)
        want = [int(jnp.argmax(logits, -1)[0])]
        for _ in range(n):
            logits, c = dec(rparams, c, jnp.asarray([[want[-1]]], jnp.int32))
            want.append(int(jnp.argmax(logits, -1)[0]))
        assert o == want, f"{arch} prompt {p}"
    assert cfg.num_heads // cfg.num_kv_heads == {"qwen25_3b": 2, "starcoder2_15b": 3,
                                                 "granite_34b": 4}[arch]


def test_engine_more_requests_than_slots(port_rt, served):
    cfg, model, params, ref_greedy = served
    eng = _engine(model, params, max_batch=2, cache_len=64, max_new_tokens=3,
                  name="slots#0")
    futs = [eng.submit([i + 1, i + 2]) for i in range(7)]
    outs = [f.get(timeout=300) for f in futs]
    assert all(len(o) == 4 for o in outs)
    assert outs[3] == ref_greedy([4, 5], 3)


def test_per_slot_length_divergence(port_rt, served):
    """Requests with different max_new share the batch; every slot matches
    its own reference decode (per-row lengths in the paged kernel)."""
    cfg, model, params, ref_greedy = served
    prompts = [[5, 6, 7, 8], [100, 3, 50, 2, 9, 11], [42, 7]]
    new = [2, 7, 4]
    eng = _engine(model, params, max_batch=2, cache_len=96, max_new_tokens=8)
    futs = [eng.submit(p, max_new=n) for p, n in zip(prompts, new)]
    for p, n, f in zip(prompts, new, futs):
        assert f.get(timeout=300) == ref_greedy(p, n), (p, n)


def test_per_slot_eos_divergence(port_rt, served):
    """EOS ends one slot early while its batch-mate continues exactly."""
    cfg, model, params, ref_greedy = served
    pa, pb = [5, 6, 7, 8], [100, 3, 50, 2, 9, 11]
    n = 6
    ra, rb = ref_greedy(pa, n), ref_greedy(pb, n)
    k = next(i for i in range(1, n) if ra[i] not in ra[:i])
    eos = ra[k]

    def cut(toks):
        return toks[: toks.index(eos) + 1] if eos in toks else toks

    eng = _engine(model, params, max_batch=2, cache_len=96, max_new_tokens=n,
                  eos_id=eos)
    fa, fb = eng.submit(pa), eng.submit(pb)
    assert fa.get(timeout=300) == cut(ra)
    assert fb.get(timeout=300) == cut(rb)
    assert len(fa.get()) == k + 1 < n + 1


def test_paged_free_list_reuse_under_churn(port_rt, served):
    """Admission churn cycles pages through the LIFO free list: cumulative
    allocations exceed pool capacity (reuse) and everything returns."""
    cfg, model, params, _ = served
    eng = _engine(model, params, max_batch=2, cache_len=64, max_new_tokens=3,
                  page_size=16, name="churn#0")
    kv = eng.kv
    outs = [f.get(timeout=300)
            for f in [eng.submit(list(range(1, 2 + i % 17))) for i in range(9)]]
    assert all(len(o) == 4 for o in outs)
    assert kv.pages_in_use() == 0 and kv.free_pages() == kv.num_pages - 1
    assert eng.load() == 0
    assert counters.get_value("/serve{churn#0}/pages/allocated") > kv.num_pages - 1
    assert (counters.get_value("/serve{churn#0}/pages/allocated")
            == counters.get_value("/serve{churn#0}/pages/freed"))
    assert (kv.page_table == 0).all() and (kv.pos == 0).all()


def test_stream_channel_order_and_close(port_rt, served):
    """Streamed tokens arrive in generation order, the first before the
    request completes, and the channel closes on finish."""
    cfg, model, params, _ = served
    eng = _engine(model, params, max_batch=2, cache_len=96, max_new_tokens=48)
    ch, fut = eng.submit_stream([5, 6, 7, 8])
    first = ch.get(timeout=300)
    assert not fut.is_ready(), "first token must stream before completion"
    rest = list(ch)
    assert [first] + rest == fut.get(timeout=300)
    with pytest.raises(ChannelClosed):
        ch.get(timeout=1)


def test_greedy_sampling_equivalence_and_top_k(port_rt, served):
    """temperature=0 is exact argmax whatever top-k/top-p say; top_k=1 is
    the greedy sequence at any temperature; hot sampling stays in vocab."""
    cfg, model, params, ref_greedy = served
    eng = _engine(model, params, max_batch=2, cache_len=96, max_new_tokens=4)
    p = [5, 6, 7, 8]
    want = ref_greedy(p, 4)
    assert eng.submit(p, sampling=SamplingParams(0.0, 7, 0.5)).get(timeout=300) == want
    assert eng.submit(p, sampling=SamplingParams(0.7, 1)).get(timeout=300) == want
    hot = eng.submit(p, sampling=SamplingParams(1.2, 20)).get(timeout=300)
    assert len(hot) == 5 and all(0 <= t < cfg.vocab_size for t in hot)


def test_sample_logits_properties():
    """Per-row controls: greedy rows are argmax, top-k rows draw only from
    their k largest logits, tiny top-p keeps only the argmax."""
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    B, V, k = 4, 300, 5
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    temp = torch.tensor([0.0, 1.5, 1.5, 1.0])
    topk = torch.tensor([3, k, 0, 0])
    topp = torch.tensor([1.0, 1.0, 1.0, 1e-6])
    topset = set(torch.topk(logits[1], k).indices.tolist())
    seen = set()
    for _ in range(200):
        s = sample_logits(logits, gen, temp, topk, topp)
        assert int(s[0]) == int(logits[0].argmax())
        assert int(s[1]) in topset
        assert int(s[3]) == int(logits[3].argmax())
        seen.add(int(s[1]))
    assert len(seen) > 1  # it does sample
    assert torch.equal(sample_logits(logits, gen, torch.zeros(B), topk, topp),
                       logits.argmax(-1))


def test_router_least_loaded_dispatch(port_rt, served):
    cfg, model, params, ref_greedy = served
    router = Router.replicate(model, params,
                              ServeConfig(max_batch=2, cache_len=64, max_new_tokens=2),
                              2, device="cpu")
    e0, e1 = router.engines
    assert [e.scfg.name for e in router.engines] == ["engine#0", "engine#1"]
    assert e0.params is not params and e0.params["blk/wq"] is e1.params["blk/wq"]
    before = counters.get_value("/serve{router}/dispatch/engine#1")
    assert router.pick() == 0  # ties → first
    e0.c_sub.increment(3)  # fake 3 in-flight requests on replica 0
    try:
        assert e0.load() == 3 and e1.load() == 0
        assert router.pick() == 1
        assert router.submit([4, 5, 6]).get(timeout=300) == ref_greedy([4, 5, 6], 2)
    finally:
        e0.c_sub.increment(-3)
    assert counters.get_value("/serve{router}/dispatch/engine#1") == before + 1


def test_serve_counters(port_rt, served):
    cfg, model, params, _ = served
    eng = _engine(model, params, max_batch=2, cache_len=64, max_new_tokens=3,
                  name="count#0")
    outs = [f.get(timeout=300) for f in [eng.submit([1, 2, 3]), eng.submit([9] * 20)]]
    q = dict(counters.query("/serve{count#0}/*"))
    assert q["/serve{count#0}/requests/submitted"] == 2
    assert q["/serve{count#0}/requests/completed"] == 2
    assert q["/serve{count#0}/tokens/generated"] == sum(map(len, outs)) == 8
    assert q["/serve{count#0}/pages/capacity"] == eng.kv.num_pages - 1
    assert q["/serve{count#0}/pages/allocated"] == q["/serve{count#0}/pages/freed"] >= 3
    assert q["/serve{count#0}/pages/in_use"] == 0
    assert q["/serve{count#0}/step/duration"] > 0
    assert eng.step_count >= 3 and eng.prefill_count == 2


def test_engine_bf16_serves(port_rt, served):
    """The default compute dtype (bf16) runs end to end on the CPU path."""
    _, _, params, _ = served
    model = Model(get_config("starcoder2_3b", smoke=True), device="cpu")
    eng = _engine(model, params, max_batch=2, cache_len=64, max_new_tokens=5,
                  name="bf16#0")
    assert eng.params["blk/wq"].dtype == torch.bfloat16
    assert eng.params["final_ln"].dtype == torch.float32
    out = eng.submit([3, 1, 4, 1, 5]).get(timeout=300)
    assert len(out) == 6 and all(0 <= t < 512 for t in out)


def test_seed_parity_mode_matches_greedy(port_rt, served):
    """The A/B baseline (dense cache + inline-prefill barrier) produces the
    reference's exact greedy tokens (test_serve_paged.py)."""
    cfg, model, params, ref_greedy = served
    eng = _engine(model, params, max_batch=2, cache_len=96, max_new_tokens=4,
                  paged=False, pipeline_admission=False, name="seed#0")
    assert not eng.paged and not eng._bucketed
    prompts = [[11, 12, 13], [5, 6, 7, 8], [42], [100, 3, 50, 2, 9, 11]]
    outs = [f.get(timeout=300) for f in [eng.submit(p) for p in prompts]]
    for p, o in zip(prompts, outs):
        assert o == ref_greedy(p, 4), f"prompt {p}"


@pytest.mark.parametrize("mode", [dict(), dict(paged=False),
                                  dict(paged=False, pipeline_admission=False)])
def test_decode_step_compiles_once(port_rt, served, mode):
    """Admission churn (different prompt lengths, sampling params, EOS
    timings) never changes the decode step's input shapes: one signature
    in all, on either backend (test_serve_paged.py)."""
    cfg, model, params, _ = served
    eng = _engine(model, params, max_batch=2, cache_len=64, max_new_tokens=3,
                  name="compile#0", **mode)
    futs = [eng.submit(list(range(1, 2 + i)),
                       sampling=SamplingParams(temperature=0.5 * (i % 2), top_k=i))
            for i in range(5)]
    for f in futs:
        f.get(timeout=300)
    assert eng.step_count > 1
    assert eng.decode_compile_count() == 1


def test_engine_counters(port_rt, served):
    """test_serve.py's counter test on the port's engine."""
    cfg, model, params, _ = served
    before = counters.get_value("/serve{engine#0}/requests/completed")
    eng = _engine(model, params, max_batch=2, cache_len=64, max_new_tokens=2)
    eng.submit([1, 2, 3]).get(timeout=300)
    assert counters.get_value("/serve{engine#0}/requests/completed") == before + 1


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_2b"])
def test_recurrent_families_take_the_dense_backend(port_rt, arch):
    """An ssm or hybrid model has no paged cache: the engine serves it from
    dense slots whatever ``paged`` says, prefills at the exact prompt
    length, and refuses live migration as the reference's dense backend
    does; prompts are not bounded by cache_len."""
    model = Model(get_config(arch, smoke=True), device="cpu")
    params = model.init(0)
    eng = _engine(model, params, max_batch=2, cache_len=16, max_new_tokens=3,
                  paged=True, name=f"{arch}#0")
    assert not model.supports_paged and not eng.paged and not eng._bucketed
    assert set(eng.backend.device_cache()) == set(model.cache_specs(2, 16))
    with pytest.raises(AttributeError):
        eng.kv
    with pytest.raises(NotImplementedError, match="live migration"):
        eng.backend.snapshot_slot(0)
    with pytest.raises(ValueError, match="no paged cache"):
        model.paged_cache_specs(8, 16, 2, 4)
    outs = [f.get(timeout=300) for f in [eng.submit([3, 1]), eng.submit(list(range(1, 40)))]]
    assert [len(o) for o in outs] == [4, 4]
    assert all(0 <= t < model.cfg.vocab_size for o in outs for t in o)
    assert eng.decode_compile_count() == 1


def test_engine_with_serve_plan(port_rt, served):
    """The `serve` plan (TP-only, sequence-sharded KV: nothing to shard on
    one device) produces the same greedy tokens as the futurized plan."""
    from repro_torch.dist.plan import get_plan as port_plan

    cfg, model, params, _ = served
    model2 = Model(cfg, device="cpu", plan=port_plan("serve"))
    assert model.plan.name == "futurized" and model2.plan.name == "serve"
    eng1 = _engine(model, params, max_batch=2, cache_len=64, max_new_tokens=4)
    eng2 = _engine(model2, params, max_batch=2, cache_len=64, max_new_tokens=4)
    p = [9, 8, 7, 6]
    assert eng1.submit(p).get(timeout=300) == eng2.submit(p).get(timeout=300)


@pytest.mark.parametrize("paged", [True, False])
def test_engine_close_drops_its_agas_record(port_rt, served, paged):
    """A paged engine's pools stay AGAS-registered (and alive) until the
    engine is closed; closing twice, or a dense-slot engine, is harmless."""
    from repro_torch.core import agas

    cfg, model, params, _ = served
    eng = _engine(model, params, max_batch=2, cache_len=32, max_new_tokens=2,
                  paged=paged, name=f"close{int(paged)}#0")
    assert len(eng.submit([5, 4, 3]).get(timeout=300)) == 3
    if paged:
        gid = eng.kv.gid
        assert agas.default().resolve(gid) is eng.kv.pools
    eng.close()
    eng.close()
    if paged:
        assert not agas.default().contains(gid)
