"""Every family on a 2×2 (data, model) mesh of gloo ranks on CPU tensors,
against the same model without a mesh: the ssm, hybrid and encdec losses
(fp32, 1e-5), a prefill and four greedy decode steps for one config of
each family (the same tokens), and the expert-parallel MoE layer against
the reference's two dispatch groups, near-ties left out as
``test_torch_moe.py`` leaves them.

One spawn of four ranks serves the losses and the tokens (each rank at one
thread, a ``FileStore`` under ``tmp_path``, joined with a timeout)."""
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.launch import mesh as mesh_mod
from test_torch_mesh import _full, _kept_tokens, _ref_moe_two_groups, spawn

LOSS_ARCHS = ("mamba2_780m", "recurrentgemma_2b", "whisper_small")
SERVE_ARCHS = ("starcoder2_3b", "recurrentgemma_2b")  # a plain cache and a ring
TOKEN_ARCHS = ("starcoder2_3b", "deepseek_moe_16b", "internvl2_2b", "mamba2_780m",
               "recurrentgemma_2b", "whisper_small")
B, S, STEPS = 4, 16, 4


def _cfg(arch):
    from repro_torch.configs import get_config

    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    if cfg.is_moe:  # no drops in one group or two: the same tokens either way
        cfg = replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def _batch(cfg, seed=0):
    from repro_torch.data.pipeline import DataConfig, synth_batch

    b = synth_batch(cfg, DataConfig(batch_size=B, seq_len=S, seed=seed), 0)
    return {k: v.float() if v.is_floating_point() else v for k, v in b.items()}


def _greedy(model, params, inputs, step_fn, cache_len=None, mesh=None):
    """The prefill's argmax, then STEPS greedy decode steps: (B, 1 + STEPS).
    On ``mesh``, the prefill's cache goes to the plan's cache placements
    (``cache_axes``: ``kv_seq`` shards the positions under the serve
    plan) before the first step."""
    from repro_torch.train import step as step_mod

    with torch.no_grad():
        logits, cache = model.prefill(params, inputs, cache_len=cache_len)
        if mesh is not None:
            sh = step_mod.cache_shardings(model, mesh, cache)
            cache = {k: v.redistribute(mesh, sh[k]) if isinstance(v, DTensor)
                     else distribute_tensor(v, mesh, sh[k], src_data_rank=None)
                     for k, v in cache.items()}
            if model.plan.name == "serve":  # positions over model: (L, B, T, ...) dim 2
                assert cache["k"].placements[1] == Shard(2), cache["k"].placements
        logits = model.plan.constrain(logits, ("batch", None))
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks = [_full(tok)]
        for _ in range(STEPS):
            tok, cache = step_fn(params, cache, tok)
            toks.append(_full(tok))
    return torch.cat(toks, 1)


def _families(mesh=None):
    """{arch: loss} for LOSS_ARCHS, {arch: greedy tokens} for TOKEN_ARCHS
    and, under the serve plan, for SERVE_ARCHS, on ``mesh`` (DTensor
    params, inputs and caches) or without one."""
    from repro_torch.dist.plan import get_plan
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_mod

    losses, tokens, served = {}, {}, {}
    for arch in SERVE_ARCHS:
        model = Model(_cfg(arch), "cpu", plan=get_plan("serve"))
        params = model.init(3)
        prompt = {"tokens": _batch(model.cfg)["tokens"][:, :S]}
        if mesh is not None:
            sh = step_mod.train_state_shardings(model, mesh)[0]
            params = {k: distribute_tensor(v, mesh, sh[k], src_data_rank=None)
                      for k, v in params.items()}
            prompt = step_mod.place_batch(model, mesh, prompt)
        served[arch] = _greedy(model, params, prompt, step_mod.make_decode_step(model),
                               cache_len=S + 2 * STEPS, mesh=mesh)
    for arch in dict.fromkeys(LOSS_ARCHS + TOKEN_ARCHS):
        cfg = _cfg(arch)
        model = Model(cfg, "cpu")
        params = model.init(3)
        batch = _batch(cfg)
        prompt = {k: (v[:, :S] if k == "tokens" else v) for k, v in batch.items()}
        if mesh is not None:
            sh = step_mod.train_state_shardings(model, mesh)[0]
            params = {k: distribute_tensor(v, mesh, sh[k], src_data_rank=None)
                      for k, v in params.items()}
            batch = step_mod.place_batch(model, mesh, batch)
            prompt = step_mod.place_batch(model, mesh, prompt)
        if arch in LOSS_ARCHS:
            with torch.no_grad():
                losses[arch] = float(_full(model.loss(params, batch)))
        if arch in TOKEN_ARCHS:
            tokens[arch] = _greedy(model, params, prompt, step_mod.make_decode_step(model))
    return losses, tokens, served


def _mesh_rank(rank, world):
    mesh = mesh_mod.make_mesh_shape((2, 2), ("data", "model"), "cpu")
    return _families(mesh)


@pytest.fixture(scope="module")
def family_ranks(tmp_path_factory):
    return _families(), spawn(_mesh_rank, 4, tmp_path_factory.mktemp("families"))


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_family_loss_on_a_mesh_matches_no_mesh(family_ranks, arch):
    """mamba2_780m, recurrentgemma_2b and whisper_small: the loss on a 2×2
    mesh (the plan's gather points and constraints, the scans and flash
    on each rank's batch shard) is the loss without one, fp32."""
    (want, _, _), outs = family_ranks
    for losses, _, _ in outs:
        assert abs(losses[arch] - want[arch]) <= 1e-5, (arch, losses[arch], want[arch])


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_family_greedy_tokens_on_a_mesh_match_no_mesh(family_ranks, arch):
    """A prefill and four greedy decode steps on the mesh (the decode
    kernels on each rank's shards of the cache, written in place) give the
    tokens of the same run without a mesh, on every rank."""
    (_, want, _), outs = family_ranks
    for _, tokens, _ in outs:
        assert torch.equal(tokens[arch], want[arch]), (arch, tokens[arch], want[arch])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_plan_decode_on_a_kv_seq_sharded_cache(family_ranks, arch):
    """Under the serve plan the decode cache is sharded over its positions
    (``kv_seq`` on ``model``) as well as the batch: each step writes the
    new token on the shard that holds its slot and the kernel reads the
    cache gathered; the greedy tokens equal the run without a mesh."""
    (_, _, want), outs = family_ranks
    for _, _, served in outs:
        assert torch.equal(served[arch], want[arch]), (arch, served[arch], want[arch])


# ------------------------------------------------------ expert parallelism
def _ep_case():
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import moe as RM
    from repro.models.params import init_params as ref_init_params

    rcfg = replace(ref_config("deepseek_moe_16b", smoke=True), dtype="float32")
    p = ref_init_params(RM.moe_param_specs(rcfg, 1, ""), jax.random.PRNGKey(4))
    p = {k: np.asarray(v[0], np.float32) for k, v in p.items()}
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 24, rcfg.d_model))
         + rng.standard_normal(rcfg.d_model)).astype(np.float32)
    return rcfg, p, x


def _ep_rank(rank, world, p, x):
    from repro_torch.dist.plan import get_plan
    from repro_torch.models import moe as TM
    from repro_torch.models.transformer import gather_constrain, layer_axes

    from repro_torch.configs import get_config

    cfg = replace(get_config("deepseek_moe_16b", smoke=True), dtype="float32")
    mesh = mesh_mod.make_mesh_shape((2, 2), ("data", "model"), "cpu")
    plan = get_plan("futurized")
    specs = TM.moe_param_specs(cfg, 1, "")
    dp = {k: distribute_tensor(torch.from_numpy(v[None]), mesh,
                               plan.sharding(specs[k].axes, specs[k].shape, mesh),
                               src_data_rank=None)[0] for k, v in p.items()}
    dp = gather_constrain(plan, dp, layer_axes(specs, ""))
    dx = distribute_tensor(torch.from_numpy(x), mesh, plan.sharding(
        ("batch", None, None), x.shape, mesh), src_data_rank=None)
    with mesh_mod.use(mesh), mesh_mod.replicating():
        y, aux = TM.moe_ffn(cfg, dx, dp, "", plan=plan)
    return {"y": y.full_tensor(), "aux": float(_full(aux)),
            "experts": list(dp["w_in"].placements)}


def test_expert_parallel_moe_layer_matches_reference_groups(tmp_path, monkeypatch):
    """deepseek_moe_16b's MoE layer on 2×2: two dispatch groups over
    ``data``, the capacity buffers and the expert weights sharded over
    ``model`` (4 experts a rank), against the reference's ``moe_ffn`` with
    two groups, near-ties left out."""
    rcfg, p, x = _ep_case()
    ry, raux = _ref_moe_two_groups(rcfg, p, x, monkeypatch)
    keep = _kept_tokens(rcfg, x, p["router"])
    assert keep.mean() > 0.9
    for out in spawn(_ep_rank, 4, tmp_path, p, x):
        assert "Shard(dim=0)" in str(out["experts"])  # experts over model
        np.testing.assert_allclose(out["y"].reshape(-1, rcfg.d_model).numpy()[keep],
                                   np.asarray(ry).reshape(-1, rcfg.d_model)[keep], atol=2e-5)
        assert abs(out["aux"] - float(raux)) <= 2e-5
