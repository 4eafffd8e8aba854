"""The port's training path on the CPU against the reference: the
starcoder2_3b smoke model's loss and every gradient (the reference's
``jax.value_and_grad(model.loss)``, its flash path in interpret mode) and
those of the mamba2_780m, recurrentgemma_2b, granite_moe_3b_a800m and
deepseek_moe_16b smoke models (fp32: loss within 1e-5, each gradient
within 1e-4 of that tensor's largest), one train step of every ported
smoke config, the
AdamW update and schedule, the plans (registry, bsp ≡ futurized, remat
none ≡ full ≡ dots, microbatching ≡ full batch, bf16 cotangents), the
synthetic token stream, the trainer and the launcher.

Params are the reference's own, carried across by ``from_reference``;
batches come from the reference's ``synth_batch`` (the port's is held
bit-equal to it).  Tolerances: fp32 loss 1e-4 and grads atol 1e-4, rtol
1e-3 — the same fp32 math in other summation orders; bf16 loss 2e-2 and
grads atol 2e-2, rtol 5e-2 — both sides round to bf16 after every matmul,
norm and activation, at points that differ (as in ``test_torch_models``),
and the backward carries that through every layer.  AdamW 1e-6: the same
elementwise fp32 math (one division reordered, see ``optim/adamw.py``).
"""
import json
import os
import subprocess
import sys
from dataclasses import fields, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data import pipeline as rpipe
from repro.dist import plan as rplan
from repro.models import layers as RL
from repro.models.model import build_model as ref_build
from repro.optim import adamw as radamw
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import plan as tplan
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import from_reference
from repro_torch.optim import adamw
from repro_torch.train import step as step_mod
from repro_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(loss=1e-4, atol=1e-4, rtol=1e-3),
       "bfloat16": dict(loss=2e-2, atol=2e-2, rtol=5e-2)}


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    import repro_torch.core as core

    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def _ref_flat(cfg, seed=1):
    """The reference's params with non-trivial norm scales and biases."""
    params = ref_build(cfg, rplan.get_plan("futurized")).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(3)
    flat = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for k in flat:
        if k.endswith(("ln1", "ln2", "final_ln")):
            flat[k] = 1.0 + 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
        elif k.split("/")[-1] in ("bq", "bk", "bv"):
            flat[k] = 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
    return flat


def _ref_and_port(dtype, vocab=None, plan="futurized", impl="pallas"):
    rcfg = replace(ref_config("starcoder2_3b", smoke=True), attn_impl=impl, dtype=dtype)
    tcfg = replace(get_config("starcoder2_3b", smoke=True), dtype=dtype)
    if vocab is not None:
        rcfg, tcfg = replace(rcfg, vocab_size=vocab), replace(tcfg, vocab_size=vocab)
    flat = _ref_flat(rcfg)
    rmodel = ref_build(rcfg, rplan.get_plan(plan))
    tmodel = Model(tcfg, "cpu", plan=tplan.get_plan(plan))
    return rmodel, tmodel, flat


def _batch(cfg, B=2, S=32, step=0):
    """The reference's batch and the same batch as the port's tensors:
    tokens, and the vlm family's patches or the encdec family's frames
    (bf16, carried across exactly through fp32)."""
    b = rpipe.synth_batch(cfg, rpipe.DataConfig(batch_size=B, seq_len=S), step)
    t = {"tokens": torch.from_numpy(np.array(b["tokens"]))}
    for k in set(b) - {"tokens"}:
        t[k] = torch.from_numpy(np.asarray(b[k], np.float32)).to(torch.bfloat16)
    return b, t


def _grads_close(tg, rg, atol, rtol):
    assert set(tg) == set(rg)
    for k in rg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(rg[k], np.float32),
                                   atol=atol, rtol=rtol, err_msg=k)


# ------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("impl,dtype", [("pallas", "float32"), ("pallas", "bfloat16"),
                                        ("xla", "float32")])
def test_loss_and_grads_match_reference(impl, dtype):
    """Against the reference's flash path (its Pallas kernel in interpret
    mode, backward through ``ref.mha``) and, in fp32, its XLA attention."""
    rmodel, tmodel, flat = _ref_and_port(dtype, impl=impl)
    rb, tb = _batch(rmodel.cfg)
    rp = {k: jnp.asarray(v) for k, v in flat.items()}
    rloss, rgrads = jax.jit(jax.value_and_grad(rmodel.loss))(rp, rb)
    tp = from_reference(flat, tmodel.cfg, "cpu")
    tloss, tgrads = step_mod.value_and_grad(tmodel.loss, tp, tb)
    assert abs(float(tloss) - float(rloss)) <= TOL[dtype]["loss"]
    _grads_close(tgrads, rgrads, TOL[dtype]["atol"], TOL[dtype]["rtol"])
    # every param gets a gradient, the attention weights above all
    for k in ("blk/wq", "blk/wk", "blk/wv", "blk/bq", "blk/bk", "blk/bv"):
        assert tgrads[k].abs().amax(dim=tuple(range(1, tgrads[k].dim()))).min() > 0, k


def test_grads_with_padded_vocab_match_reference():
    """A vocab that is not a multiple of 128: the unembedding masks the
    padded columns in place (after the matmul), and their gradient is 0."""
    rmodel, tmodel, flat = _ref_and_port("float32", vocab=500)
    assert tmodel.cfg.padded_vocab == 512
    rb, tb = _batch(rmodel.cfg)
    rp = {k: jnp.asarray(v) for k, v in flat.items()}
    rloss, rgrads = jax.jit(jax.value_and_grad(rmodel.loss))(rp, rb)
    tloss, tgrads = step_mod.value_and_grad(
        tmodel.loss, from_reference(flat, tmodel.cfg, "cpu"), tb)
    assert abs(float(tloss) - float(rloss)) <= TOL["float32"]["loss"]
    _grads_close(tgrads, rgrads, TOL["float32"]["atol"], TOL["float32"]["rtol"])
    assert torch.all(tgrads["lm_head"][:, 500:] == 0)


def test_recurrent_families_refuse_to_train():
    """The bare scan wrappers, the families' only route before they had a
    backward, still refuse autograd: a gradient through them would be lost
    on the card.  The families train through the trainable ops instead
    (``test_recurrent_families_train``)."""
    x = torch.rand(1, 8, 2, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan has no backward"):
        ops.ssd_scan(x, x[..., 0], torch.zeros(2), x, x)
    with pytest.raises(RuntimeError, match="rglru_scan has no backward"):
        ops.rglru_scan(x[0], x[0])


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_2b"])
def test_recurrent_families_train(arch):
    """The recurrent families' loss has a finite value and a gradient for
    every param, through ``ops.ssd_scan_trainable`` / ``rglru_scan_trainable``."""
    model = Model(get_config(arch, smoke=True), "cpu")
    params = model.init(0)
    loss, grads = step_mod.value_and_grad(
        model.loss, params, {"tokens": torch.arange(9, dtype=torch.int32)[None]})
    assert torch.isfinite(loss)
    assert set(grads) == set(params)


# the families beyond the dense one, at their smoke configs in fp32: loss
# within 1e-5 of the reference's, each gradient within 1e-4 of that tensor's
# largest
FAMILY_ARCHS = ["mamba2_780m", "recurrentgemma_2b", "granite_moe_3b_a800m",
                "deepseek_moe_16b", "whisper_small", "internvl2_2b"]
FAMILY_LOSS_TOL = 1e-5
FAMILY_GRAD_RTOL = 1e-4
# key biases (whisper_small's self- and cross-attention): b adds q·b to every
# score of a row, which softmax does not see, so their exact gradient is 0;
# each side's is rounding noise, held within 1e-4 of the largest gradient
ZERO_GRAD = ("bk", "xbk")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_loss_and_grads_match_reference(arch):
    """The port's loss and autograd gradients (the scans' trainable ops;
    the MoE aux loss through loss_fn; the encoder's non-causal flash and
    the plain cross-attention; the VLM's patches and masked image
    positions) against the reference's ``jax.value_and_grad(model.loss)``,
    fp32, on the reference's params and batch."""
    rcfg = replace(ref_config(arch, smoke=True), dtype="float32")
    tcfg = replace(get_config(arch, smoke=True), dtype="float32")
    rmodel = ref_build(rcfg, rplan.get_plan("futurized"))
    flat = _ref_flat(rcfg)
    rb, tb = _batch(rcfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(rmodel.loss))(
        {k: jnp.asarray(v) for k, v in flat.items()}, rb)
    tmodel = Model(tcfg, "cpu", plan=tplan.get_plan("futurized"))
    tloss, tgrads = step_mod.value_and_grad(tmodel.loss, from_reference(flat, tcfg, "cpu"), tb)
    assert abs(float(tloss) - float(rloss)) <= FAMILY_LOSS_TOL
    assert set(tgrads) == set(rgrads)
    largest = max(float(np.abs(np.asarray(g, np.float32)).max()) for g in rgrads.values())
    for k, rg in rgrads.items():
        rg = np.asarray(rg, np.float32)
        if k.split("/")[-1] in ZERO_GRAD:  # both sides' rounding noise only
            assert max(float(np.abs(rg).max()), float(tgrads[k].abs().max())) <= \
                FAMILY_GRAD_RTOL * largest, k
            continue
        scale = float(np.abs(rg).max())
        assert scale > 0, k
        np.testing.assert_allclose(tgrads[k].numpy(), rg, atol=FAMILY_GRAD_RTOL * scale,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_policies_give_equal_grads_over_the_families(arch):
    """bsp (full remat) against futurized (none), and dots: the same ops on
    the same inputs, through the scans' trainable ops and the MoE layer,
    so the same loss and grads (on the CPU, bit for bit)."""
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=2, seq_len=24), 3)
    params = Model(cfg, "cpu").init(0)
    got = {}
    for name, plan in (("futurized", tplan.futurized_plan()), ("bsp", tplan.bsp_plan()),
                       ("dots", tplan.get_plan("futurized", remat_policy="dots"))):
        got[name] = step_mod.value_and_grad(Model(cfg, "cpu", plan=plan).loss, params, batch)
    for name in ("bsp", "dots"):
        assert float(got[name][0]) == float(got["futurized"][0])
        for k, g in got["futurized"][1].items():
            torch.testing.assert_close(got[name][1][k], g, atol=0, rtol=0, msg=k)


# ------------------------------------------------------------------- plans
@pytest.mark.parametrize("name", ["bsp", "futurized", "optimized", "serve"])
def test_plan_registry_matches_reference(name):
    r, t = rplan.get_plan(name), tplan.get_plan(name)
    for f in fields(t):
        assert getattr(t, f.name) == getattr(r, f.name), f.name
    assert tplan.get_plan(name, microbatches=4).microbatches == 4
    x = torch.ones(2)
    assert t.constrain(x, ("batch",)) is x


def test_plan_registry_unknown_raises():
    with pytest.raises(KeyError, match="unknown plan"):
        tplan.get_plan("nope")


def test_bsp_and_futurized_steps_agree():
    """Same math, another remat policy ⇒ the same step on one device."""
    cfg = get_config("starcoder2_3b", smoke=True)
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=4, seq_len=32), 0)
    out = {}
    for plan in (tplan.bsp_plan(), tplan.futurized_plan()):
        model = Model(cfg, "cpu", plan=plan)
        params = model.init(0)
        step = step_mod.make_train_step(model, adamw.AdamWConfig(lr=1e-3))
        p2, _, m = step(params, adamw.init(params), batch)
        out[plan.name] = (float(m["loss"]), p2)
    assert abs(out["bsp"][0] - out["futurized"][0]) < 1e-5
    for k in out["bsp"][1]:
        torch.testing.assert_close(out["bsp"][1][k], out["futurized"][1][k],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policies_give_equal_grads(dtype):
    """none, full and dots recompute the same ops on the same inputs: the
    grads are equal (on the CPU, bit for bit)."""
    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype=dtype)
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=2, seq_len=24), 3)
    params = Model(cfg, "cpu").init(0)
    got = {}
    for policy in ("none", "full", "dots"):
        model = Model(cfg, "cpu", plan=tplan.get_plan("futurized", remat_policy=policy))
        got[policy] = step_mod.value_and_grad(model.loss, params, batch)
    for policy in ("full", "dots"):
        assert float(got[policy][0]) == float(got["none"][0])
        for k, g in got["none"][1].items():
            torch.testing.assert_close(got[policy][1][k], g, atol=0, rtol=0)


def test_bf16_cotangent_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32) * 1.001  # not bf16-exact
    jg = jax.grad(lambda a: jnp.sum(RL.bf16_cotangent(a) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = TL.bf16_cotangent(xt)
    torch.testing.assert_close(y, xt, atol=0, rtol=0)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    assert not np.array_equal(xt.grad.numpy(), w)  # the cotangent was rounded
    # the optimized plan sets the boundary in attention; the math is the same
    # up to the rounding of the q/k/v cotangents (fp32 compute, so that the
    # rounding shows)
    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32")
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=2, seq_len=16), 0)
    params = Model(cfg, "cpu").init(0)
    plain = step_mod.value_and_grad(Model(cfg, "cpu").loss, params, batch)[1]
    opt = step_mod.value_and_grad(Model(cfg, "cpu", plan=tplan.get_plan("optimized")).loss,
                                  params, batch)[1]
    torch.testing.assert_close(opt["blk/wq"], plain["blk/wq"], atol=2e-2, rtol=5e-2)
    assert not torch.equal(opt["blk/wq"], plain["blk/wq"])


def test_microbatched_grads_match_full_batch():
    cfg = get_config("starcoder2_3b", smoke=True)
    model = Model(cfg, "cpu")
    params = model.init(0)
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=4, seq_len=32), 0)
    loss_fn = step_mod.make_loss_fn(model)
    l1, g1 = step_mod.value_and_grad(loss_fn, params, batch)
    l2, g2 = step_mod._microbatch_grads(loss_fn, params, batch, 4)
    assert abs(float(l1) - float(l2)) < 1e-3
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], atol=2e-2, rtol=5e-2)
    with pytest.raises(ValueError, match="microbatches"):
        step_mod._microbatch_grads(loss_fn, params, batch, 3)


@pytest.mark.parametrize("arch", ["whisper_small", "internvl2_2b"])
def test_microbatches_split_every_batch_field(arch):
    """The microbatch split slices the side inputs (whisper_small's frames,
    internvl2_2b's patches) with the tokens, row for row: fp32, the same
    loss and grads as the full batch; the step moves every field to the
    model's device."""
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    model = Model(cfg, "cpu")
    params = model.init(0)
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=4, seq_len=24), 0)
    assert len(batch) == 2
    loss_fn = step_mod.make_loss_fn(model)
    l1, g1 = step_mod.value_and_grad(loss_fn, params, batch)
    l2, g2 = step_mod._microbatch_grads(loss_fn, params, batch, 4)
    assert abs(float(l1) - float(l2)) < 1e-5
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], atol=1e-6, rtol=1e-4, msg=k)
    # rows' side inputs swapped: another loss, so each row met its own
    side = next(k for k in batch if k != "tokens")
    swapped = {**batch, side: batch[side].flip(0)}
    l3, _ = step_mod._microbatch_grads(loss_fn, params, swapped, 4)
    assert abs(float(l3) - float(l1)) > 1e-4
    p2, _, m = step_mod.make_train_step(model, adamw.AdamWConfig(lr=1e-3))(
        params, adamw.init(params), batch)
    assert torch.isfinite(m["loss"]) and abs(float(m["loss"]) - float(l1)) < 1e-5


# ------------------------------------------------------------------- adamw
def test_adamw_update_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 8), "b/c": (16,), "d": (3, 5, 7)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=1.0)
    rcfg = radamw.AdamWConfig(**{f.name: getattr(cfg, f.name) for f in fields(cfg)})
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rstate = radamw.init(rp)
    rupdate = jax.jit(lambda p, g, st: radamw.update(rcfg, p, g, st))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = adamw.init(tp)
    for step in range(4):  # the clip bites on the steps with scale 3
        gscale = 3.0 if step % 2 else 0.05
        grads = {k: gscale * rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        rp, rstate, rm = rupdate(rp, {k: jnp.asarray(g) for k, g in grads.items()}, rstate)
        # the port gets its own copy of each gradient: adamw.update writes
        # the grads it is given in place (the caller gives them up), and
        # jnp.asarray may share g's buffer with the reference's update,
        # which runs asynchronously
        tp, tstate, tm = adamw.update(cfg, tp, {k: torch.from_numpy(g.copy())
                                                for k, g in grads.items()}, tstate)
        assert int(tstate["step"]) == int(rstate["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6, atol=1e-9)
        for k in shapes:
            for t, r in ((tp[k], rp[k]), (tstate["m"][k], rstate["m"][k]),
                         (tstate["v"][k], rstate["v"][k])):
                np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=1e-6, rtol=0)


def test_schedule_warmup_and_decay():
    c = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    rc = radamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(adamw.schedule(c, torch.tensor(0))) == 0.0
    assert abs(float(adamw.schedule(c, torch.tensor(10))) - 1.0) < 1e-6
    assert float(adamw.schedule(c, torch.tensor(100))) == pytest.approx(0.1, abs=1e-6)
    assert float(adamw.schedule(c, torch.tensor(55))) < 1.0
    for s in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        assert float(adamw.schedule(c, torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(radamw.schedule(rc, jnp.asarray(s, jnp.int32))), abs=1e-7)


def test_smoke_train_step_keeps_shapes_and_finite_values():
    """The reference's ``test_arch_smoke_forward_and_train_step`` for the
    dense smoke config."""
    cfg = get_config("starcoder2_3b", smoke=True)
    model = Model(cfg, "cpu")
    params = model.init(0)
    shapes = {k: v.shape for k, v in params.items()}
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=2, seq_len=16), 0)
    loss = model.loss(params, batch)
    assert loss.shape == () and torch.isfinite(loss)
    p2, o2, m = step_mod.make_train_step(model, adamw.AdamWConfig(lr=1e-3))(
        params, adamw.init(params), batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert int(o2["step"]) == 1
    for k, v in p2.items():
        assert v.shape == shapes[k] and v.dtype == torch.float32, k
        assert torch.isfinite(v).all(), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_forward_and_train_step(arch):
    """The reference's ``test_arch_smoke_forward_and_train_step`` for every
    ported smoke config: a finite loss, then one step that keeps every
    param's shape and dtype and finite values."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, "cpu")
    params = model.init(0)
    shapes = {k: v.shape for k, v in params.items()}
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=2, seq_len=16), 0)
    loss = model.loss(params, batch)
    assert loss.shape == () and torch.isfinite(loss)
    p2, o2, m = step_mod.make_train_step(model, adamw.AdamWConfig(lr=1e-3))(
        params, adamw.init(params), batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert int(o2["step"]) == 1
    for k, v in p2.items():
        assert v.shape == shapes[k] and v.dtype == torch.float32, k
        assert torch.isfinite(v).all(), k


def test_grad_clip_bounds_update():
    cfg = get_config("starcoder2_3b", smoke=True)
    model = Model(cfg, "cpu")
    params = model.init(0)
    before = {k: v.clone() for k, v in params.items()}
    batch = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=4, seq_len=32), 0)
    step = step_mod.make_train_step(model, adamw.AdamWConfig(lr=1e-3, grad_clip=1e-9))
    p2, _, m = step(params, adamw.init(params), batch)
    # with a tiny clip the parameter change is bounded by ~lr·(1+wd·p)
    delta = max(float((p2[k] - before[k]).abs().max()) for k in before)
    assert 0 < delta < 1e-2


class _Mesh:
    """The two things the branch rule reads of a mesh."""

    def __init__(self, *names, device_type="cpu"):
        self.mesh_dim_names, self.device_type = names, device_type


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("names", [None, ("data", "model"), ("pod", "data", "model"),
                                   ("pod",)])
def test_pod_manual_branch_taken_exactly_with_compression_and_a_pod_axis(compress, names):
    """The reference's rule (``train/step.py:66-67``): the pod-manual
    branch runs when the plan compresses pod gradients and the mesh has a
    ``pod`` axis, and in no other case; a mesh on another device type than
    the model's raises."""
    cfg = get_config("starcoder2_3b", smoke=True)
    model = Model(cfg, "cpu", plan=tplan.get_plan("futurized", compress_pod_grads=compress))
    mesh = None if names is None else _Mesh(*names)
    assert step_mod.takes_pod_manual(model, mesh) == (
        compress and names is not None and "pod" in names)
    with pytest.raises(ValueError, match="cuda mesh"):
        step_mod.make_train_step(model, adamw.AdamWConfig(),
                                 mesh=_Mesh("data", device_type="cuda"))


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,B,S", [(0, 0, 4, 32), (3, 17, 2, 100), (1, 5, 1, 7)])
@pytest.mark.parametrize("arch", ["starcoder2_3b", "mamba2_780m", "whisper_small",
                                  "internvl2_2b"])
def test_synth_batch_is_bit_equal_to_reference(arch, seed, step, B, S):
    """Tokens, and the vlm family's ``patches`` (B, n_patches, D) or the
    encdec family's ``enc`` (B, S, D) in bf16, bit for bit."""
    cfg = get_config(arch, smoke=True)
    t = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=B, seq_len=S, seed=seed), step)
    r = rpipe.synth_batch(ref_config(arch, smoke=True),
                          rpipe.DataConfig(batch_size=B, seq_len=S, seed=seed), step)
    extra = {"vlm": {"patches"}, "encdec": {"enc"}}.get(cfg.family, set())
    assert set(t) == set(r) == {"tokens"} | extra
    assert t["tokens"].dtype == torch.int32 and t["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(t["tokens"].numpy(), np.asarray(r["tokens"]))
    for k in extra:
        want = np.asarray(r[k])
        assert t[k].dtype == torch.bfloat16 and tuple(t[k].shape) == want.shape
        assert t[k].shape[-1] == cfg.d_model
        assert t[k].shape[1] == (cfg.n_patches if k == "patches" else S)
        np.testing.assert_array_equal(t[k].view(torch.int16).numpy(), want.view(np.int16))


def test_prefetcher_returns_future_batches(port_rt):
    cfg = get_config("starcoder2_3b", smoke=True)
    dcfg = tpipe.DataConfig(batch_size=2, seq_len=8, prefetch=2)
    pf = tpipe.Prefetcher(cfg, dcfg)
    for step in (0, 1, 5):
        got = pf.get(step).get(timeout=30)
        torch.testing.assert_close(got["tokens"], tpipe.synth_batch(cfg, dcfg, step)["tokens"])
    assert {6, 7} <= set(pf._pending)  # the window ahead of the last step


# ----------------------------------------------------------------- trainer
def test_loss_decreases_over_training(port_rt):
    from repro_torch.core import agas

    cfg = get_config("starcoder2_3b", smoke=True)
    model = build_model(cfg, "cpu", plan=tplan.get_plan("futurized"))
    tr = Trainer(model, adamw.AdamWConfig(lr=1e-2, warmup_steps=5,
                                          total_steps=40, weight_decay=0.0),
                 tpipe.DataConfig(batch_size=4, seq_len=48),
                 TrainConfig(steps=40, log_every=10), device="cpu")
    # the counters are the process's: other trainers may have added to them
    logged, steps = tr.t_step.count, tr.c_steps.get_value()
    hist = tr.fit()
    assert [h["step"] for h in hist] == [10, 20, 30, 40]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert agas.default().resolve(f"/train/state/{cfg.name}")["params"] is tr.params
    assert tr.t_step.count - logged == 4 and tr.c_steps.get_value() - steps == 40


def test_trainer_close_drops_its_agas_record(port_rt):
    """The trainer's params and moments stay AGAS-registered until it is
    closed; closing twice is harmless."""
    from repro_torch.core import agas

    cfg = get_config("starcoder2_3b", smoke=True)
    tr = Trainer(build_model(cfg, "cpu"), adamw.AdamWConfig(),
                 tpipe.DataConfig(batch_size=1, seq_len=8), TrainConfig(steps=1),
                 device="cpu")
    assert agas.default().resolve(tr.gid)["params"] is tr.params
    tr.close()
    tr.close()
    assert not agas.default().contains(tr.gid)
    assert not agas.default().contains(f"/train/state/{cfg.name}")


def test_launch_train_grows_cuda_segments_in_place():
    """The launcher asks the CUDA allocator for expandable segments before
    CUDA starts; a caller's own setting wins."""
    script = (
        "import os, sys\n"
        "from repro_torch.launch import train\n"
        "sys.argv = ['train', '--arch', 'starcoder2_3b', '--smoke', '--device', 'cpu',"
        " '--steps', '1', '--batch', '1', '--seq', '8', '--log-every', '1']\n"
        "train.main()\n"
        "print(os.environ['PYTORCH_CUDA_ALLOC_CONF'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTORCH_CUDA_ALLOC_CONF"}
    env["PYTHONPATH"] = str(ROOT / "src")
    for given, want in ((None, "expandable_segments:True"),
                        ("max_split_size_mb:512", "max_split_size_mb:512")):
        r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                           env={**env, **({"PYTORCH_CUDA_ALLOC_CONF": given} if given else {})},
                           timeout=120)
        assert r.returncode == 0, r.stderr
        lines = r.stdout.splitlines()
        assert json.loads(lines[0])["step"] == 1 and lines[-1] == want


def test_trainer_refuses_a_model_on_another_device():
    model = Model(get_config("starcoder2_3b", smoke=True), "cpu")
    with pytest.raises((ValueError, RuntimeError)):
        Trainer(model, adamw.AdamWConfig(), tpipe.DataConfig(), TrainConfig(),
                device="meta")


def test_launch_train_prints_json_lines(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "starcoder2_3b", "--smoke", "--device", "cpu", "--steps", "6",
                        "--batch", "2", "--seq", "16", "--log-every", "3",
                        "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(line) for line in r.stdout.splitlines()]
    assert [h["step"] for h in lines[:-1]] == [3, 6]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in lines[:-1])
    counters = lines[-1]["counters"]
    assert counters["/train{loop#0}/steps/cumulative"] == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000006"]


def test_global_norm_stays_accurate_on_large_tensors():
    """A flat fp32 norm of ~10⁷ elements drifts by ~0.1 % on the CPU; the
    clip scale is read from it, so the norm reduces one dim at a time."""
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(4096, 4096, generator=g) * 1e-3, torch.randn(7, generator=g),
          torch.tensor(-2.5)]
    want = torch.sqrt(sum(x.double().square().sum() for x in xs))
    assert abs(float(adamw.global_norm(xs)) / float(want) - 1) < 1e-6


def test_prefill_and_decode_steps_are_the_models():
    cfg = get_config("starcoder2_3b", smoke=True)
    model = Model(cfg, "cpu")
    params = model.compute_params(model.init(0))
    tokens = tpipe.synth_batch(cfg, tpipe.DataConfig(batch_size=2, seq_len=7), 0)["tokens"]
    logits, cache = step_mod.make_prefill_step(model)(params, {"tokens": tokens})
    with torch.inference_mode():
        want, _ = model.prefill(params, {"tokens": tokens})
    torch.testing.assert_close(logits, want, atol=0, rtol=0)
    nxt, cache2 = step_mod.make_decode_step(model)(params, cache, logits.argmax(-1)[:, None])
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    assert torch.equal(cache2["pos"], cache["pos"] + 1)
