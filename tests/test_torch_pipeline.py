"""The port's dataflow 1F1B pipeline (``repro_torch.train.pipeline``): the
reference's three cases of ``test_pipeline.py`` on the port, the
reference's ``pipeline_value_and_grad`` against the port's on the same
numpy-seeded stage params (loss and every gradient within 1e-5), and the
starcoder2_3b smoke model split into stages — the stage functions the
port's model already has — against ``Model.loss``'s gradients (fp32, the
reference's params through ``from_reference``, within 1e-5 of each
gradient's largest)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro.configs import get_config as ref_config
from repro.data import pipeline as rpipe
from repro.dist import plan as rplan
from repro.models.model import build_model as ref_build
from repro.train import pipeline as rpipeline
from repro_torch.configs import get_config
from repro_torch.core import counters
from repro_torch.core.future import wait_all
from repro_torch.models import layers as Lx
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.models.params import from_reference
from repro_torch.train import step as step_mod
from repro_torch.train.pipeline import pipeline_value_and_grad, split_stages

TOL = 1e-5


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def _stage(params, x):
    w1, w2 = params
    return torch.tanh(x @ w1) @ w2


def _loss(y, target):
    return torch.mean((y - target) ** 2)


def _ref_stage(params, x):
    w1, w2 = params
    return jnp.tanh(x @ w1) @ w2


def _ref_loss(y, target):
    return jnp.mean((y - target) ** 2)


def _problem_np(seed=0):
    rng = np.random.default_rng(seed)
    D = 16
    stage_params = [tuple((rng.standard_normal((D, D)) * 0.3).astype(np.float32)
                          for _ in range(2)) for _ in range(4)]
    xs = rng.standard_normal((8, D)).astype(np.float32)
    tgt = np.full((8, D), 0.1, np.float32)
    return stage_params, xs, tgt


@pytest.fixture()
def problem():
    sp, xs, tgt = _problem_np()
    return ([tuple(torch.from_numpy(w) for w in p) for p in sp],
            torch.from_numpy(xs), torch.from_numpy(tgt))


def _monolithic(stage_params, xs, tgt):
    leaves = [tuple(w.detach().requires_grad_() for w in p) for p in stage_params]
    x = xs
    for p in leaves:
        x = _stage(p, x)
    loss = _loss(x, tgt)
    grads = torch.autograd.grad(loss, [w for p in leaves for w in p])
    return loss.detach(), [grads[2 * s: 2 * s + 2] for s in range(len(leaves))]


def _mbs(xs, tgt):
    return [(xs[i:i + 2], tgt[i:i + 2]) for i in range(0, 8, 2)]  # 4 of 2


def test_pipeline_matches_monolithic(port_rt, problem):
    stage_params, xs, tgt = problem
    fns = [_stage] * 4
    loss_f, grad_fs = pipeline_value_and_grad(fns, _loss, stage_params, _mbs(xs, tgt))
    loss_ref, grads_ref = _monolithic(stage_params, xs, tgt)
    assert abs(float(loss_f.get(timeout=120)) - float(loss_ref)) < 1e-5
    for s, gf in enumerate(grad_fs):
        got = gf.get(timeout=120)
        for a, b in zip(got, grads_ref[s]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_pipeline_task_count(port_rt, problem):
    """S·M forward + S·M backward + M loss tasks execute (the dataflow tree)."""
    stage_params, xs, tgt = problem
    c = counters.counter("/pipeline{1f1b}/tasks/cumulative")
    before = c.get_value()
    loss_f, grad_fs = pipeline_value_and_grad([_stage] * 4, _loss,
                                              stage_params, _mbs(xs, tgt))
    wait_all([loss_f, *grad_fs])
    ran = c.get_value() - before
    assert ran == 4 * 4 + 4 * 4 + 4  # fwd + bwd + loss


def test_split_stages_partition():
    layers = list(range(10))
    st = split_stages(layers, 4)
    assert [len(s) for s in st] == [3, 3, 2, 2]
    assert sum(st, []) == layers


def test_pipeline_runs_under_no_grad_and_leaves_params_alone(port_rt, problem):
    """Grad mode is per thread: each task sets its own, so a caller under
    ``torch.no_grad()`` gets the same gradients; the params themselves
    gain no ``.grad`` and no ``requires_grad``."""
    stage_params, xs, tgt = problem
    with torch.no_grad():
        loss_f, grad_fs = pipeline_value_and_grad([_stage] * 4, _loss, stage_params,
                                                  _mbs(xs, tgt))
        got = [g.get(timeout=120) for g in grad_fs]
    _, want = _monolithic(stage_params, xs, tgt)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)
    assert all(w.grad is None and not w.requires_grad for p in stage_params for w in p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_matches_reference(rt, port_rt, seed):
    """The reference's ``pipeline_value_and_grad`` and the port's on the
    same stage params and microbatches: loss and grads within 1e-5."""
    sp, xs, tgt = _problem_np(seed)
    rmbs = [(jnp.asarray(xs[i:i + 2]), jnp.asarray(tgt[i:i + 2])) for i in range(0, 8, 2)]
    rloss, rgrads = rpipeline.pipeline_value_and_grad(
        [_ref_stage] * 4, _ref_loss, [tuple(jnp.asarray(w) for w in p) for p in sp], rmbs)
    tloss, tgrads = pipeline_value_and_grad(
        [_stage] * 4, _loss, [tuple(torch.from_numpy(w) for w in p) for p in sp],
        _mbs(torch.from_numpy(xs), torch.from_numpy(tgt)))
    assert abs(float(tloss.get(timeout=120)) - float(rloss.get(timeout=120))) <= TOL
    for rg, tg in zip(rgrads, tgrads):
        for a, b in zip(tg.get(timeout=120), rg.get(timeout=120)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


# ------------------------------------------------- a model split in stages
def stage_fns(cfg, n_stages):
    """Stage 0 embeds, every stage runs its layers (``_layer_body``), the
    last norms and unembeds (``logits``): stage s takes its params
    ``{"layers": [...], ...}`` and the previous stage's output."""
    def make(s):
        def fn(p, x):
            if s == 0:
                x = Lx.embed(cfg, p["tok_embed"], x)
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
            for lp in p["layers"]:
                x, _, _ = T._layer_body(cfg, x, lp, positions)
            return T.logits(cfg, p, x) if s == n_stages - 1 else x
        return fn

    return [make(s) for s in range(n_stages)]


def stage_params(cfg, params, n_stages):
    """Each stage's params: its layers' slices (``unbind_layers``), the
    embedding table on stage 0, the final norm and the unembedding on the
    last."""
    groups = split_stages(T.unbind_layers(params, cfg.num_layers), n_stages)
    out = [{"layers": g} for g in groups]
    out[0]["tok_embed"] = params["tok_embed"]
    out[-1]["final_ln"] = params["final_ln"]
    out[-1]["lm_head"] = params["lm_head"]
    return out


@pytest.mark.parametrize("n_stages,layers", [(2, 2), (4, 4), (3, 5)])
def test_model_split_in_stages_matches_model_loss(port_rt, n_stages, layers):
    """The starcoder2_3b smoke model (fp32) split into stages: the
    pipeline's loss and every gradient against ``Model.loss`` over the
    whole batch (4 microbatches of 1), the stacked params' gradients
    reassembled from the stages' layer slices."""
    rcfg = replace(ref_config("starcoder2_3b", smoke=True), dtype="float32",
                   num_layers=layers)
    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32",
                  num_layers=layers)
    flat = {k: np.asarray(v, np.float32) for k, v in
            ref_build(rcfg, rplan.get_plan("futurized")).init(jax.random.PRNGKey(1)).items()}
    params = from_reference(flat, cfg, "cpu")
    tokens = torch.from_numpy(np.array(rpipe.synth_batch(
        rcfg, rpipe.DataConfig(batch_size=4, seq_len=32), 0)["tokens"]))
    model = Model(cfg, "cpu")
    want_loss, want = step_mod.value_and_grad(model.loss, params, {"tokens": tokens})

    mbs = [(tokens[m:m + 1, :-1], tokens[m:m + 1, 1:]) for m in range(4)]
    loss_f, grad_fs = pipeline_value_and_grad(stage_fns(cfg, n_stages), Lx.cross_entropy,
                                              stage_params(cfg, params, n_stages), mbs)
    assert abs(float(loss_f.get(timeout=120)) - float(want_loss)) <= TOL
    got = [g.get(timeout=120) for g in grad_fs]
    layer_grads = [lg for g in got for lg in g["layers"]]
    assert len(layer_grads) == layers
    flat_got = {"tok_embed": got[0]["tok_embed"], "final_ln": got[-1]["final_ln"],
                "lm_head": got[-1]["lm_head"]}
    for k in layer_grads[0]:
        flat_got[f"blk/{k}"] = torch.stack([lg[k] for lg in layer_grads])
    assert set(flat_got) == set(want)
    for k, w in want.items():
        err = (flat_got[k] - w).abs().max().item()
        assert err <= TOL * max(w.abs().max().item(), 1e-30), (k, err)
