"""The port's pod collectives (``repro_torch.dist.collectives``) against the
reference's and against the plain ``value_and_grad``.

- ``make_error_feedback`` beside the reference's on the same 50 numpy
  gradient steps: each step's bf16 ``q`` and fp32 residual bit-equal (the
  same round-to-nearest-even and fp32 carry), and the telescoping sum
  ``Σ dequant(q_t) + residual_T`` bit-equal to the reference's and within
  its 1e-6 of ``Σ g_t`` (``test_train.py::test_error_feedback_unbiased_over_steps``).
- ``pod_manual_value_and_grad`` on 2 spawned gloo ranks (a ``pod`` axis of
  2), the smoke starcoder2_3b in fp32, against the plain
  ``value_and_grad`` of the whole batch: each gradient within 1e-2 of its
  largest with ``compress=True`` (every gradient crosses as bf16, whose
  rounding is 2⁻⁹ of a value; the wire dtype is asserted), within 1e-6
  without (fp32 in another summation order); the loss within 1e-6 either
  way (it crosses in fp32).
- ``all_gather_tree`` over the pod group, stacked and tiled.

The reference's own pod-manual path raises on this jax (ROADMAP queue 3),
so the plain ``value_and_grad`` is the oracle there.  Spawns use a
``FileStore`` under ``tmp_path`` and are joined with a timeout.
"""
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.dist import collectives
from repro_torch.launch import mesh as mesh_mod

SPAWN_TIMEOUT = 120


# --------------------------------------------------------------------- spawns
def _rank_main(fn, rank, world, tmp, args):
    try:
        mesh_mod.init_process_group(rank, world, "cpu", store_path=f"{tmp}/store",
                                    timeout_s=60)
        out = {"value": fn(rank, world, *args)}
    except BaseException:  # noqa: BLE001 — carried to the test, which fails on it
        out = {"error": traceback.format_exc()}
    finally:
        mesh_mod.destroy_process_group()
    torch.save(out, f"{tmp}/rank{rank}.pt")


def spawn(fn, world, tmp_path, *args, timeout=SPAWN_TIMEOUT):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; their
    return values by rank.  A rank still running after ``timeout`` seconds
    is killed and fails the test (a hung collective never stalls the run)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not hung, f"ranks {hung} did not finish in {timeout} s"
    outs = [torch.load(Path(tmp_path) / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
    errors = [o["error"] for o in outs if "error" in o]
    assert not errors, errors[0]
    return [o["value"] for o in outs]


# ------------------------------------------------------------ error feedback
def test_error_feedback_matches_reference_bit_for_bit():
    import jax.numpy as jnp

    from repro.dist.collectives import make_error_feedback as ref_ef

    rng = np.random.default_rng(0)
    gs = [(rng.standard_normal(64) * 1e-3).astype(np.float32) for _ in range(50)]
    r_init, r_comp = ref_ef()
    t_init, t_comp = collectives.make_error_feedback()
    r_res = r_init({"g": jnp.asarray(gs[0])})
    t_res = t_init({"g": torch.from_numpy(gs[0])})
    assert t_res["g"].dtype == torch.float32 and not t_res["g"].any()
    r_acc = jnp.zeros((64,), jnp.float32)
    t_acc = torch.zeros(64, dtype=torch.float32)
    for g in gs:
        rq, r_res = r_comp({"g": jnp.asarray(g)}, r_res)
        tq, t_res = t_comp({"g": torch.from_numpy(g)}, t_res)
        assert tq["g"].dtype == torch.bfloat16
        np.testing.assert_array_equal(tq["g"].float().numpy(),
                                      np.asarray(rq["g"].astype(jnp.float32)))
        np.testing.assert_array_equal(t_res["g"].numpy(), np.asarray(r_res["g"]))
        r_acc = r_acc + rq["g"].astype(jnp.float32)
        t_acc = t_acc + tq["g"].float()
    true = np.sum(np.stack(gs), axis=0, dtype=np.float32)
    np.testing.assert_array_equal((t_acc + t_res["g"]).numpy(),
                                  np.asarray(r_acc + r_res["g"]))
    np.testing.assert_allclose((t_acc + t_res["g"]).numpy(), true, atol=1e-6)
    assert float((t_acc - torch.from_numpy(true)).abs().max()) < 1e-4


def test_error_feedback_keeps_the_tree_and_the_device():
    init, comp = collectives.make_error_feedback(torch.float16)
    tree = {"a": [torch.ones(3), torch.full((2, 2), 1e-4)], "b": torch.zeros(())}
    res = init(tree)
    q, res = comp(tree, res)
    assert q["a"][0].dtype == torch.float16 and isinstance(q["a"], list)
    assert res["b"].shape == () and res["a"][1].dtype == torch.float32


# --------------------------------------------------------------- pod manual
def _pod_manual_rank(rank, world, compress):
    import torch.distributed as dist
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core import migration
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.dist.plan import get_plan
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_mod

    mesh = mesh_mod.make_mesh_shape((world, 1, 1), ("pod", "data", "model"), "cpu")
    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32")
    model = Model(cfg, "cpu", plan=get_plan("futurized", compress_pod_grads=compress))
    params = model.init(0)
    batch = synth_batch(cfg, DataConfig(batch_size=4, seq_len=16, seed=0), 0)
    loss0, grads0 = step_mod.value_and_grad(model.loss, params, batch)
    dparams = migration.migrate_tree(params, step_mod.train_state_shardings(model, mesh)[0],
                                     mesh)
    dbatch = step_mod.place_batch(model, mesh, batch)
    wires = []
    all_reduce = dist.all_reduce

    def seen(t, *a, **kw):
        wires.append(t.dtype)
        return all_reduce(t, *a, **kw)

    dist.all_reduce = seen
    try:
        loss, grads = collectives.pod_manual_value_and_grad(model.loss, mesh, compress)(
            dparams, dbatch)
    finally:
        dist.all_reduce = all_reduce
    rel = {k: float((g.full_tensor() - grads0[k]).abs().max() / grads0[k].abs().max())
           for k, g in grads.items()}
    return {"loss_err": abs(float(loss.full_tensor()) - float(loss0)), "rel": rel,
            "wires": [str(w) for w in wires], "n_grads": len(grads),
            "placements_ok": all(list(g.placements) == list(dparams[k].placements)
                                 for k, g in grads.items())}


@pytest.mark.parametrize("compress,tol", [(True, 1e-2), (False, 1e-6)])
def test_pod_manual_grads_match_plain_value_and_grad(tmp_path, compress, tol):
    outs = spawn(_pod_manual_rank, 2, tmp_path, compress)
    for out in outs:
        assert out["loss_err"] <= 1e-6
        worst = max(out["rel"], key=out["rel"].get)
        assert out["rel"][worst] <= tol, (worst, out["rel"][worst])
        assert out["placements_ok"]
        grads_wire = out["wires"][1:]  # the loss crosses first, in fp32
        assert out["wires"][0] == "torch.float32"
        assert len(grads_wire) == out["n_grads"]
        assert set(grads_wire) == {"torch.bfloat16" if compress else "torch.float32"}
    if compress:  # the bf16 wire does round: the grads are not fp32-exact
        assert max(outs[0]["rel"].values()) > 1e-6


# ---------------------------------------------------------------- all-gather
def _gather_rank(rank, world):
    mesh = mesh_mod.make_mesh_shape((world, 1), ("pod", "model"), "cpu")
    tree = {"scalar": torch.tensor(1.5 * rank), "rows": torch.full((2, 3), float(rank))}
    stacked = collectives.all_gather_tree(tree, mesh)
    tiled = collectives.all_gather_tree(tree, mesh, tiled=True)
    return {"scalar": stacked["scalar"], "rows": stacked["rows"],
            "tiled_rows": tiled["rows"], "tiled_scalar": tiled["scalar"]}


def test_all_gather_tree_over_the_pod_axis(tmp_path):
    for out in spawn(_gather_rank, 2, tmp_path):
        assert torch.equal(out["scalar"], torch.tensor([0.0, 1.5]))
        assert torch.equal(out["tiled_scalar"], torch.tensor([0.0, 1.5]))
        assert out["rows"].shape == (2, 2, 3) and torch.equal(out["rows"][1], torch.ones(2, 3))
        assert out["tiled_rows"].shape == (4, 3)
        assert torch.equal(out["tiled_rows"][:2], torch.zeros(2, 3))
