"""The port's device plane on multi-rank meshes: spawned gloo ranks on CPU
tensors (the card hosts only one-rank NCCL meshes), held against the
reference.

- ``MeshExecutor`` / ``mesh_policy`` on 4 ranks (a (data,) mesh, and the
  data axis of a 2×2 mesh), every algorithm against ``seq`` and against
  the reference's ``mesh_policy`` on its one-device mesh: integers and
  orderings exact, fp32 sums within 1e-6 of the magnitudes added, the
  reference's jit-fused ``3·x + 1`` within half an ulp of ``3·x``.
- ``shard_parcel`` against the reference's (a per-shard body, and one
  whose local sums meet in a collective).
- ``migrate_to_mesh`` from 4 ranks to 2: values bit-equal, the GID kept,
  the generation bumped once.
- The smoke starcoder2_3b in fp32 under ``bsp``, ``futurized`` (also in
  two microbatches) and ``optimized`` on a 2×2 (data, model) mesh: one
  step's loss and every
  gradient against the reference's ``jax.value_and_grad`` on the same
  params (converted with ``from_reference``).  ROADMAP's rule: fp32 2e-5
  × 4 with attention, of each gradient's largest; ``optimized`` puts a
  bf16 boundary on the q/k/v cotangents, whose rounding each side meets
  at its own points, so its gradients are held to the bf16 limit 2e-2.
- The MoE layer at a data degree of 2 (two dispatch groups of T/2 tokens,
  per-group capacity) against the reference's ``moe_ffn`` with
  ``_group_count`` patched to 2 in memory, in process (a ``{data: 2}``
  mapping as the active mesh) and on 2 ranks; tokens whose top-k margin is
  below fp32 resolution left out, as ``test_torch_moe.py`` does.
- ``Trainer.elastic_restart`` from 4 ranks to 2, then ``resume(shardings=)``
  onto 4: the loss sequence equals an unmoved run's (fp32, 1e-5).
- ``examples/elastic_migration_torch.py`` on 8 ranks at smoke size.
- No fallback: a DTensor reaching a kernel entry point raises, and so does
  a mesh on another device type than the model's.

Every spawn uses a ``FileStore`` under ``tmp_path`` and is joined with a
timeout, so a hung collective fails its test instead of stalling the run.
"""
import os
import subprocess
import sys
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.launch import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120
ATTN_ATOL = 2e-5 * 4
BF16_ATOL = 2e-2


# --------------------------------------------------------------------- spawns
def _rank_main(fn, rank, world, tmp, args):
    torch.set_num_threads(1)  # several ranks share the host's cores
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
    is killed and fails the test."""
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


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------- the runtime's device plane
def _maximum(a, b):
    return torch.maximum(a, b) if isinstance(a, torch.Tensor) else np.maximum(a, b)


ALGOS = {
    "for_each": lambda a, p, d: a.for_each(p, d, lambda x: x * 2),
    "transform": lambda a, p, d: a.transform(p, d, lambda x: 3 * x + 1),
    "reduce": lambda a, p, d: a.reduce(p, d, init=5),
    "reduce_max": lambda a, p, d: a.reduce(p, d, init=-5000, op=_maximum),
    "transform_reduce": lambda a, p, d: a.transform_reduce(p, d, lambda x: x * x),
    "inclusive_scan": lambda a, p, d: a.inclusive_scan(p, d),
    "exclusive_scan": lambda a, p, d: a.exclusive_scan(p, d, init=7),
    "sort": lambda a, p, d: a.sort(p, d),
    "count_if": lambda a, p, d: a.count_if(p, d, lambda x: x > 0),
    "all_of": lambda a, p, d: a.all_of(p, d, lambda x: x > -2000),
    "any_of": lambda a, p, d: a.any_of(p, d, lambda x: x > 990),
    "fill": lambda a, p, d: a.fill(p, d, 3),
    "min_element": lambda a, p, d: a.min_element(p, d),
    "max_element": lambda a, p, d: a.max_element(p, d),
    "copy": lambda a, p, d: a.copy(p, d),
}
SUMS = {"reduce", "transform_reduce", "inclusive_scan", "exclusive_scan"}


def _data():
    """Odd lengths: 4 ranks hold uneven shards (and 3 elements leave a
    rank empty)."""
    rng = np.random.default_rng(0)
    return {"int64": rng.integers(-1000, 1000, size=1001),
            "float32": rng.uniform(-1.0, 1.0, size=1001).astype(np.float32),
            "short": rng.integers(-1000, 1000, size=3)}


def _value(x):
    if x is None or isinstance(x, (bool, int, float)):
        return x
    return np.asarray(_full(x).numpy()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _runtime_rank(rank, world):
    from repro_torch.core import agas, migration, parcel
    from repro_torch.core import algorithms as alg
    from repro_torch.core.executor import MeshExecutor, mesh_policy
    from repro_torch.dist.plan import get_plan

    mesh4 = mesh_mod.make_mesh_shape((world,), ("data",), "cpu")
    mesh22 = mesh_mod.make_mesh_shape((2, 2), ("data", "model"), "cpu")
    mesh2 = mesh_mod.make_mesh_shape((2,), ("data",), "cpu")
    out = {"algos": {}, "algos_2x2": {}}
    for kind, arr in _data().items():
        for name, call in ALGOS.items():
            out["algos"][(name, kind)] = _value(call(alg, mesh_policy(mesh4), torch.from_numpy(arr)))
            out["algos_2x2"][(name, kind)] = _value(
                call(alg, mesh_policy(mesh22, "data"), torch.from_numpy(arr)))
    ex = MeshExecutor(mesh4)
    x = torch.arange(10.0)
    shard = ex.put(x)
    out["put"] = (list(shard.placements), tuple(shard.to_local().shape))
    out["parallelism"] = (ex.parallelism, MeshExecutor(mesh22, "model").parallelism)

    # shard_parcel: a per-shard body, and local sums meeting in a collective
    def body(t):
        return t * 2 + 1

    def total(t):
        import torch.distributed as dist

        s = t.sum().reshape(())
        dist.all_reduce(s, group=mesh4.get_group("data"))
        return s

    x12 = torch.arange(12.0)
    y = parcel.shard_parcel(mesh4, body, [("data",)], ("data",))(x12)
    s = parcel.shard_parcel(mesh4, total, [("data",)], ())(x12)
    out["parcel"] = (y.full_tensor(), list(y.placements), s.full_tensor())
    try:  # as shard_map: a dim that does not split evenly raises
        parcel.shard_parcel(mesh4, body, [("data",)], ("data",))(x)
        out["uneven_raised"] = False
    except ValueError:
        out["uneven_raised"] = True

    # migrate_to_mesh: 4 ranks → 2
    plan = get_plan("futurized")
    tree = {"w": distribute_tensor(torch.arange(24.0).reshape(8, 3), mesh4, [Shard(0)]),
            "v": distribute_tensor(torch.arange(6, dtype=torch.int64), mesh4, [Replicate()]),
            "s": torch.tensor(3.5)}
    gid = agas.default().register_name("/test/mesh/tree", tree, replace=True)
    gen = migration.migrate_to_mesh(gid, mesh2, lambda leaf: plan.sharding_for(leaf, mesh2))
    rec = agas.default().record(gid)
    moved = rec.obj
    member = mesh2.get_coordinate() is not None
    out["migrate"] = {
        "gen": gen, "record_gen": rec.generation, "gid_kept": rec.gid == gid,
        "placement_is_mesh": rec.placement is mesh2, "member": member,
        "meshes": {k: v.device_mesh is mesh2 for k, v in moved.items()},
        "placements": {k: list(v.placements) for k, v in moved.items()},
        "values": {k: v.full_tensor() for k, v in moved.items()} if member else None}
    return out


@pytest.fixture(scope="module")
def runtime_ranks(tmp_path_factory):
    return spawn(_runtime_rank, 4, tmp_path_factory.mktemp("runtime"))


def _ref_value(x):
    if x is None or isinstance(x, (bool, int, float)):
        return x
    return np.asarray(x)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_mesh_policy_matches_seq_and_reference(runtime_ranks, algo):
    """Each algorithm under ``mesh_policy`` on 4 ranks (and on the data
    axis of a 2×2 mesh), every rank's result against ``seq`` over a host
    list and against the reference's ``mesh_policy`` on a one-device mesh."""
    import jax
    import jax.numpy as jnp

    from repro.core import algorithms as ralg
    from repro.core.executor import mesh_policy as ref_mesh_policy
    from repro_torch.core import algorithms as alg
    from repro_torch.core.executor import seq

    ref_pol = ref_mesh_policy(jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",)))
    call = ALGOS[algo]
    for kind, arr in _data().items():
        want_ref = _ref_value(call(ralg, ref_pol, jnp.asarray(arr)))
        host = call(alg, seq, arr.tolist() if algo != "fill" else list(arr.tolist()))
        want_seq = _ref_value(host if algo not in ("fill",) else host)
        for out in runtime_ranks:
            for got in (out["algos"][(algo, kind)], out["algos_2x2"][(algo, kind)]):
                if want_ref is None or isinstance(want_ref, bool):
                    assert got == want_ref == want_seq
                    continue
                got, ref = np.asarray(got, np.float64), np.asarray(want_ref, np.float64)
                assert got.shape == ref.shape, (algo, kind)
                if kind == "float32" and algo in SUMS:
                    scale = np.abs(arr).astype(np.float64).sum() * 3 + 7
                    assert np.abs(got - ref).max() <= 1e-6 * scale
                    assert np.abs(got - np.asarray(want_seq, np.float64)).max() <= 1e-6 * scale
                elif kind == "float32" and algo == "transform":
                    # the reference fuses 3·x + 1 into one FMA
                    assert np.all(np.abs(got - ref) <= 2.0 ** -23 * (3 * np.abs(arr) + 1))
                else:
                    np.testing.assert_array_equal(got, ref, err_msg=f"{algo} {kind}")
                    if algo != "fill":
                        np.testing.assert_array_equal(
                            got, np.asarray(want_seq, np.float64), err_msg=f"{algo} {kind}")


def test_mesh_executor_shards_over_its_axis(runtime_ranks):
    for rank, out in enumerate(runtime_ranks):
        placements, local = out["put"]
        assert placements == [Shard(0)]
        assert local == (len(torch.arange(10).chunk(4)[rank]),)
        assert out["parallelism"] == (4, 2)


def test_shard_parcel_matches_reference(runtime_ranks):
    """Against the reference's ``shard_parcel``, which is ``jax.shard_map``
    over its specs (``src/repro/core/parcel.py:222-235``).  The reference's
    function itself first imports ``jax.sharding.use_mesh``, which jax
    0.9.0 lacks, so it raises here; its ``shard_map`` call is the oracle."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    x = jnp.arange(12.0)

    def ref_shard_parcel(body, in_specs, out_specs):
        return jax.shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False)

    want = ref_shard_parcel(lambda t: t * 2 + 1, P("data"), P("data"))(x)
    want_sum = ref_shard_parcel(lambda t: jax.lax.psum(t.sum(), "data"), P("data"), P())(x)
    for out in runtime_ranks:
        y, placements, s = out["parcel"]
        np.testing.assert_array_equal(y.numpy(), np.asarray(want))
        assert placements == [Shard(0)]
        assert float(s) == float(want_sum)
        assert out["uneven_raised"]


def test_migrate_to_mesh_shrinks_four_ranks_to_two(runtime_ranks):
    tree = {"w": torch.arange(24.0).reshape(8, 3), "v": torch.arange(6),
            "s": torch.tensor(3.5)}
    for rank, out in enumerate(runtime_ranks):
        m = out["migrate"]
        assert m["gen"] == m["record_gen"] == 1 and m["gid_kept"] and m["placement_is_mesh"]
        assert all(m["meshes"].values())
        assert m["placements"] == {"w": [Shard(0)], "v": [Shard(0)], "s": [Replicate()]}
        assert m["member"] == (rank < 2)
        if m["member"]:
            for k, v in tree.items():
                assert torch.equal(m["values"][k], v), k


# ------------------------------------------------------------- the models
def _ref_flat(cfg, seed=1):
    """The reference's params with non-trivial norm scales (as
    ``test_torch_train.py`` draws them)."""
    import jax

    from repro.dist import plan as rplan
    from repro.models.model import build_model as ref_build

    params = ref_build(cfg, rplan.get_plan("futurized")).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(3)
    flat = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for k in flat:
        if k.endswith(("ln1", "ln2", "final_ln")):
            flat[k] = 1.0 + 0.1 * rng.standard_normal(flat[k].shape).astype(np.float32)
    return flat


def _model_rank(rank, world, flat, tokens, plans):
    from repro_torch.configs import get_config
    from repro_torch.core import migration
    from repro_torch.dist.plan import get_plan
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_reference
    from repro_torch.train import step as step_mod

    mesh = mesh_mod.make_mesh_shape((2, 2), ("data", "model"), "cpu")
    cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32")
    out = {}
    for name in plans:
        base, _, mb = name.partition("_mb")
        model = Model(cfg, "cpu", plan=get_plan(base, microbatches=int(mb or 1)))
        params = from_reference(flat, cfg, "cpu")
        dparams = migration.migrate_tree(
            params, step_mod.train_state_shardings(model, mesh)[0], mesh)
        batch = step_mod.place_batch(model, mesh, {"tokens": torch.from_numpy(tokens)})
        if mb:  # each rank's rows split into microbatches, grads accumulated
            loss, grads = step_mod._microbatch_grads(model.loss, dparams, batch, int(mb))
        else:
            loss, grads = step_mod.value_and_grad(model.loss, dparams, batch)
        out[name] = {"loss": float(loss.full_tensor()),
                     "grads": {k: g.full_tensor() for k, g in grads.items()},
                     "sharded": {k: any(isinstance(p, Shard) for p in g.placements)
                                 for k, g in grads.items()}}
    # no fallback: a DTensor straight into a kernel entry point raises
    q = distribute_tensor(torch.zeros(2, 4, 2, 8), mesh, [Shard(0), Replicate()])
    for fn in (lambda: ops.flash_attention(q, q, q),
               lambda: ops.flash_attention_trainable(q, q, q)):
        try:
            fn()
            out.setdefault("no_raise", []).append(True)
        except TypeError:
            pass
    return out


@pytest.fixture(scope="module")
def model_ranks(tmp_path_factory):
    from repro.configs import get_config as ref_config
    from repro.data import pipeline as rpipe

    rcfg = replace(ref_config("starcoder2_3b", smoke=True), dtype="float32")
    flat = _ref_flat(rcfg)
    b = rpipe.synth_batch(rcfg, rpipe.DataConfig(batch_size=4, seq_len=32), 0)
    tokens = np.array(b["tokens"])
    outs = spawn(_model_rank, 4, tmp_path_factory.mktemp("model"), flat, tokens,
                 ("bsp", "futurized", "optimized", "futurized_mb2"))
    return rcfg, flat, b, outs


@pytest.mark.parametrize("plan", ["bsp", "futurized", "optimized", "futurized_mb2"])
def test_mesh_step_matches_reference(model_ranks, plan):
    """One step on a 2×2 (data, model) mesh against the reference's fp32
    ``value_and_grad`` (its flash path in interpret mode) on the same
    params and batch, every rank; ``futurized_mb2`` accumulates two
    microbatches of each rank's rows against the whole batch's step."""
    import jax
    import jax.numpy as jnp

    from repro.dist import plan as rplan
    from repro.models.model import build_model as ref_build

    rcfg, flat, b, outs = model_ranks
    rmodel = ref_build(replace(rcfg, attn_impl="pallas"), rplan.get_plan(plan.split("_")[0]))
    rloss, rgrads = jax.jit(jax.value_and_grad(rmodel.loss))(
        {k: jnp.asarray(v) for k, v in flat.items()}, b)
    atol = BF16_ATOL if plan == "optimized" else ATTN_ATOL
    for out in outs:
        got = out[plan]
        assert abs(got["loss"] - float(rloss)) <= ATTN_ATOL
        assert set(got["grads"]) == set(rgrads)
        for k, g in got["grads"].items():
            want = np.asarray(rgrads[k], np.float32)
            err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= atol, (plan, k, err)
        # FSDP and tensor parallelism did shard the gradients
        assert got["sharded"]["blk/wq"] and got["sharded"]["tok_embed"]


def test_kernel_entry_points_refuse_dtensors(model_ranks):
    for out in model_ranks[3]:
        assert "no_raise" not in out


def test_mesh_device_type_must_match_the_models(tmp_path):
    """A gloo (CPU) mesh under a model on another device, or a DTensor on
    another mesh device than the model's, raises (in process, one rank)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    mesh_mod.init_process_group(0, 1, "cpu", store_path=str(tmp_path / "store"))
    try:
        mesh = mesh_mod.make_mesh_shape((1, 1), ("data", "model"), "cpu")
        with pytest.raises(ValueError, match="cuda mesh over a gloo"):
            mesh_mod.make_mesh_shape((1,), ("data",), "cuda")
        model = Model(get_config("starcoder2_3b", smoke=True), "cpu")
        model.device = torch.device("meta")  # a model said to live elsewhere
        with pytest.raises(ValueError, match="cpu mesh under a model on meta"):
            step_mod.make_train_step(model, adamw.AdamWConfig(), mesh=mesh)
        w = distribute_tensor(torch.zeros(4, 4), mesh, [Replicate(), Replicate()])
        with pytest.raises(ValueError, match="cpu mesh under a model on meta"):
            model.mesh_of({"w": w})
    finally:
        mesh_mod.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_host_mesh(1, 1, "cpu")


# ----------------------------------------------------------------------- MoE
def _moe_case():
    from repro.configs import get_config as ref_config
    from repro.models import moe as RM
    from repro.models.params import init_params as ref_init_params

    import jax

    rcfg = replace(ref_config("granite_moe_3b_a800m", smoke=True), dtype="float32")
    p = ref_init_params(RM.moe_param_specs(rcfg, 1, ""), jax.random.PRNGKey(2))
    p = {k: np.asarray(v[0], np.float32) for k, v in p.items()}
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 24, rcfg.d_model))
         + rng.standard_normal(rcfg.d_model)).astype(np.float32)
    return rcfg, p, x


def _ref_moe_two_groups(rcfg, p, x, monkeypatch):
    import jax.numpy as jnp

    from repro.dist.plan import get_plan
    from repro.models import moe as RM

    monkeypatch.setattr(RM, "_group_count", lambda T: 2)  # in memory only
    return RM.moe_ffn(rcfg, get_plan("futurized"), jnp.asarray(x),
                      {k: jnp.asarray(v) for k, v in p.items()})


def _kept_tokens(cfg, x, router):
    """Tokens whose top-k margin is above fp32 resolution."""
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, cfg.d_model)) @
                          torch.from_numpy(router.copy()), -1).sort(-1, descending=True).values
    k = cfg.top_k
    return ((probs[:, k - 1] - probs[:, k]) / probs[:, k - 1] > 1e-4).numpy()


def test_moe_two_groups_match_reference_in_process(monkeypatch):
    """A {data: 2} mapping as the active mesh: two groups of T/2 tokens with
    per-group capacity (drops differ from one group's), plain tensors."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as TM

    rcfg, p, x = _moe_case()
    tcfg = replace(get_config("granite_moe_3b_a800m", smoke=True), dtype="float32")
    ry, raux = _ref_moe_two_groups(rcfg, p, x, monkeypatch)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    with mesh_mod.use({"data": 2, "model": 1}):
        assert TM._group_count(x.shape[0] * x.shape[1]) == 2
        ty, taux = TM.moe_ffn(tcfg, torch.from_numpy(x.copy()), tp)
    one, _ = TM.moe_ffn(tcfg, torch.from_numpy(x.copy()), tp)
    keep = _kept_tokens(tcfg, x, p["router"])
    np.testing.assert_allclose(ty.reshape(-1, tcfg.d_model).numpy()[keep],
                               np.asarray(ry).reshape(-1, tcfg.d_model)[keep], atol=2e-5)
    assert abs(float(taux) - float(raux)) <= 2e-5
    assert not torch.allclose(one, ty, atol=1e-3)  # grouping changes the drops


def _moe_rank(rank, world, p, x):
    from repro_torch.configs import get_config
    from repro_torch.dist.plan import get_plan
    from repro_torch.models import moe as TM

    cfg = replace(get_config("granite_moe_3b_a800m", smoke=True), dtype="float32")
    mesh = mesh_mod.make_mesh_shape((world, 1), ("data", "model"), "cpu")
    plan = get_plan("futurized")
    dx = distribute_tensor(torch.from_numpy(x), mesh, [Shard(0), Replicate()],
                           src_data_rank=None)
    dp = {k: distribute_tensor(torch.from_numpy(v), mesh, [Replicate(), Replicate()],
                               src_data_rank=None) for k, v in p.items()}
    with mesh_mod.use(mesh), mesh_mod.replicating():
        y, aux = TM.moe_ffn(cfg, dx, dp, "", plan=plan)
    return {"y": y.full_tensor(), "aux": float(_full(aux)), "local": tuple(y.to_local().shape)}


def test_moe_data_degree_two_on_two_ranks(tmp_path, monkeypatch):
    """The same on 2 ranks: each rank dispatches its own group (local_map),
    the aux loss's means reduced across them."""
    rcfg, p, x = _moe_case()
    ry, raux = _ref_moe_two_groups(rcfg, p, x, monkeypatch)
    keep = _kept_tokens(rcfg, x, p["router"])
    for out in spawn(_moe_rank, 2, tmp_path, p, x):
        assert out["local"] == (2, 24, rcfg.d_model)
        np.testing.assert_allclose(out["y"].reshape(-1, rcfg.d_model).numpy()[keep],
                                   np.asarray(ry).reshape(-1, rcfg.d_model)[keep], atol=2e-5)
        assert abs(out["aux"] - float(raux)) <= 2e-5


# ---------------------------------------------------------- elastic restart
def _elastic_rank(rank, world, ckpt_dir):
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.core import agas, counters
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    core.init(num_workers=2)
    try:
        cfg = replace(get_config("starcoder2_3b", smoke=True), dtype="float32")
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
        dcfg = DataConfig(batch_size=4, seq_len=16)
        mesh4 = mesh_mod.make_mesh_shape((2, 2), ("data", "model"), "cpu")
        mesh2 = mesh_mod.make_mesh_shape((2, 1), ("data", "model"), "cpu")
        plain = Trainer(Model(cfg, "cpu"), opt, dcfg, TrainConfig(steps=6, log_every=1),
                        device="cpu")
        unmoved = [h["loss"] for h in plain.fit(6)]
        plain.close()
        tr = Trainer(Model(cfg, "cpu"), opt, dcfg,
                     TrainConfig(steps=2, log_every=1, ckpt_every=4, ckpt_dir=ckpt_dir),
                     device="cpu", mesh=mesh4)
        losses = [h["loss"] for h in tr.fit(2)]
        gen = agas.default().record(tr.gid).generation
        tr.elastic_restart(mesh2)
        rec = agas.default().record(tr.gid)
        after = (rec.generation, rec.placement is mesh2)
        moved = [h["loss"] for h in tr.fit(2)]  # ranks 2 and 3 sit out
        losses += moved
        step = tr.resume(shardings=tr.shardings(mesh4), mesh=mesh4)
        losses += [h["loss"] for h in tr.fit(2)]
        tr.close()
        return {"unmoved": unmoved, "losses": losses, "moved": moved, "step": step,
                "gen": (gen, after[0]), "placement": after[1],
                "restarts": counters.default().counter(
                    "/train{loop#0}/elastic_restarts/cumulative").get_value(),
                "on_mesh4": all(v.device_mesh is mesh4 for v in tr.params.values())}
    finally:
        core.finalize()


def test_elastic_restart_and_resume_keep_the_loss_sequence(tmp_path):
    """4 ranks for 2 steps, ``elastic_restart`` onto 2 ranks for 2 more
    (checkpointed at step 4; ranks 2 and 3 hold nothing), then every rank
    ``resume(shardings=)`` onto the 4-rank mesh for 2 more: the same loss
    sequence as a run that never moved."""
    outs = spawn(_elastic_rank, 4, tmp_path, str(tmp_path / "ckpt"))
    for rank, out in enumerate(outs):
        assert out["step"] == 4 and out["restarts"] == 1 and out["on_mesh4"]
        assert out["gen"][1] == out["gen"][0] + 1 and out["placement"]
        if rank < 2:
            assert len(out["losses"]) == 6
            np.testing.assert_allclose(out["losses"], out["unmoved"], rtol=0, atol=1e-5)
        else:
            assert out["moved"] == [] and len(out["losses"]) == 4
            np.testing.assert_allclose(out["losses"], out["unmoved"][:2] + out["unmoved"][4:],
                                       rtol=0, atol=1e-5)


def test_elastic_migration_example_runs_on_eight_ranks(tmp_path):
    """``examples/elastic_migration_torch.py`` at smoke size: 4×2, shrink to
    2×1 and keep training, restore the checkpoint onto 8×1."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, str(ROOT / "examples/elastic_migration_torch.py"),
                          "--steps", "2", "--ckpt-dir", str(tmp_path / "ckpt")],
                         env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "[mesh 4x2] 2 steps" in out and "[mesh 2x1] survived failure" in out
    assert "AGAS gid stable: True, generation 1 → 3" in out
    assert "[mesh 8x1] checkpoint from step 2 restored onto 8 ranks" in out
