"""The port's sharding plans (``repro_torch.dist.plan``) against the
reference's: the nine cases of ``test_plan.py`` on the port, a Hypothesis
property that the port's ``spec`` equals the reference's ``PartitionSpec``
entry for entry for every plan and for random axes, shapes and
``{pod, data, model}`` sizes (the reference on an ``AbstractMesh``, the
port on a plain ``{axis: size}`` mapping, its counterpart), the
``placements`` round trip, the placement helpers on a one-rank gloo
``DeviceMesh``, and the train state's, batch's and cache's placements of
three smoke models against the reference's specs.  Everything here is
exact: specs are discrete.
"""
import jax
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro.dist import plan as rplan
from repro_torch.dist import plan as tplan
from repro_torch.dist.plan import bsp_plan, futurized_plan, get_plan, optimized_plan
from repro_torch.launch import mesh as mesh_mod

PLANS = ["bsp", "futurized", "optimized", "serve"]
MESH11 = {"data": 1, "model": 1}
LOGICAL = ["batch", "embed", "mlp", "heads", "kv_heads", "vocab", "experts", "kv_seq",
           "seq", "seq_sp", "expert_cap", "ssm_inner", "lru", "layers", None]


def _abstract_mesh(shape):
    """The reference's AbstractMesh (its ctor signature differs across jax
    versions, as in ``test_plan.py``)."""
    try:
        return jax.sharding.AbstractMesh(tuple(shape.items()))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(shape.values()), tuple(shape.keys()))


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo (data, model) mesh in this process."""
    mesh_mod.init_process_group(0, 1, "cpu")
    yield mesh_mod.make_mesh_shape((1, 1), ("data", "model"), "cpu")
    mesh_mod.destroy_process_group()


# -------------------------------------------------- test_plan.py, on the port
def test_tp_axes_resolve():
    plan = futurized_plan()
    assert plan.spec(("embed", "mlp"), (64, 128), MESH11) == ("data", "model")
    assert plan.spec(("vocab", "embed"), (128, 64), MESH11) == ("model", "data")


def test_divisibility_guard_replicates():
    plan = futurized_plan()
    # 7 kv-heads on a 4-way axis replicate, 8 shard
    assert plan.spec(("kv_heads",), (7,), {"model": 4}) == ()
    assert plan.spec(("kv_heads",), (8,), {"model": 4}) == ("model",)
    # the joint multi-axis degree is guarded too: batch → (pod, data) = 8-way
    assert plan.spec(("batch",), (12,), {"pod": 2, "data": 4}) == ("pod",)
    # 1-device axes always divide
    assert plan.spec(("heads",), (6,), {"model": 1}) in (("model",), (None,), ())


def test_fcfs_axis_allocation():
    """experts and mlp both map to model: first dim wins, second replicates."""
    spec = futurized_plan().spec(("experts", "embed", "mlp"), (64, 32, 128), MESH11)
    assert spec == ("model", "data")


def test_bsp_has_no_fsdp():
    plan = bsp_plan()
    assert plan.spec(("embed", "mlp"), (64, 128), MESH11) == (None, "model")
    assert plan.gather_upfront and plan.remat_policy == "full"


def test_optimized_plan_shards_kv_seq():
    plan = optimized_plan()
    assert plan.spec(("batch", "kv_seq"), (8, 128), MESH11) == ("data", "model")
    assert plan.bf16_boundaries


def test_plan_registry():
    for name in ("bsp", "futurized", "optimized"):
        assert get_plan(name).name == name
    with pytest.raises(KeyError):
        get_plan("nope")


@settings(max_examples=30, deadline=None)
@given(st.lists(st.sampled_from(["embed", "mlp", "heads", "vocab", "experts",
                                 "layers", None]), min_size=1, max_size=4))
def test_spec_never_duplicates_mesh_axes(axes):
    spec = futurized_plan().spec(tuple(axes), tuple(16 for _ in axes), MESH11)
    flat = []
    for e in spec:
        if e is not None:
            flat.extend(e if isinstance(e, tuple) else (e,))
    assert len(flat) == len(set(flat)), f"duplicate axis in {spec}"


@settings(max_examples=50, deadline=None)
@given(st.lists(st.sampled_from(["batch", "embed", "mlp", "heads", "kv_heads",
                                 "vocab", "experts", "kv_seq", "layers", None]),
                min_size=1, max_size=4),
       st.data())
def test_spec_sharded_dims_always_divisible(axes, data):
    plan = get_plan(data.draw(st.sampled_from(PLANS)))
    sizes = {"pod": data.draw(st.sampled_from([1, 2])),
             "data": data.draw(st.sampled_from([1, 2, 3, 4])),
             "model": data.draw(st.sampled_from([1, 2, 4, 8]))}
    shape = tuple(data.draw(st.integers(1, 64)) for _ in axes)
    spec = plan.spec(tuple(axes), shape, sizes)
    for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if entry is None:
            continue
        degree = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            degree *= sizes[a]
        assert dim % degree == 0, (plan.name, axes, shape, spec)


def test_registry_round_trip_all_plans():
    for name in PLANS:
        p = get_plan(name)
        q = get_plan(p.name)
        assert q == p and q is not p
        r = get_plan(name, microbatches=4)
        assert r.microbatches == 4 and r.name == name
        assert get_plan(name).microbatches == 1


# ----------------------------------------------------- parity with the reference
@settings(max_examples=200, deadline=None)
@given(st.sampled_from(PLANS),
       st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=5),
       st.data())
def test_spec_equals_reference_entry_for_entry(name, axes, data):
    """Every plan, random logical axes, shapes and mesh sizes: the port's
    spec equals the reference's PartitionSpec entry for entry (a joint
    entry as the same tuple of names)."""
    sizes = {"pod": data.draw(st.sampled_from([1, 2, 4])),
             "data": data.draw(st.sampled_from([1, 2, 3, 4, 8])),
             "model": data.draw(st.sampled_from([1, 2, 4, 8, 16]))}
    keep = data.draw(st.sampled_from([("pod", "data", "model"), ("data", "model"),
                                      ("model",), ("pod", "data")]))
    sizes = {k: sizes[k] for k in keep}
    shape = tuple(data.draw(st.integers(1, 96)) for _ in axes)
    want = rplan.get_plan(name).spec(tuple(axes), shape, _abstract_mesh(sizes))
    got = tplan.get_plan(name).spec(tuple(axes), shape, sizes)
    assert got == tuple(want), (name, axes, shape, sizes)


def test_registry_matches_reference():
    for name in PLANS:
        r, t = rplan.get_plan(name), tplan.get_plan(name)
        for f in ("name", "rules", "fsdp", "gather_upfront", "remat_policy",
                  "bf16_boundaries", "compress_pod_grads", "microbatches"):
            assert getattr(r, f) == getattr(t, f), (name, f)


# ------------------------------------------------------------------ placements
@settings(max_examples=100, deadline=None)
@given(st.sampled_from(PLANS), st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=4),
       st.data())
def test_placements_round_trip(name, axes, data):
    """spec → placements (one per mesh dim) → spec gives the spec back; a
    joint entry shards its dim on each named mesh dim, the first named the
    major one."""
    sizes = {"pod": data.draw(st.sampled_from([1, 2])),
             "data": data.draw(st.sampled_from([1, 2, 4])),
             "model": data.draw(st.sampled_from([1, 2, 4]))}
    shape = tuple(data.draw(st.integers(1, 32)) for _ in axes)
    spec = get_plan(name).spec(tuple(axes), shape, sizes)
    pl = tplan.placements(spec, sizes)
    assert len(pl) == len(sizes)
    assert tplan.spec_of(pl, sizes, len(shape)) == spec


def test_joint_entry_shards_both_mesh_dims():
    sizes = {"pod": 2, "data": 2, "model": 2}
    spec = futurized_plan().spec(("batch", "seq", "vocab"), (8, 4, 6), sizes)
    assert spec == (("pod", "data"), None, "model")
    assert tplan.placements(spec, sizes) == [Shard(0), Shard(0), Shard(2)]
    assert tplan.placements((), sizes) == [Replicate()] * 3


def test_placement_helpers_on_a_device_mesh(mesh1):
    """sharding / replicated / param_shardings / sharding_for against a
    real DeviceMesh; constrain redistributes a DTensor to its placements
    and leaves a plain tensor alone."""
    plan = futurized_plan()
    assert plan.sharding(("embed", "mlp"), (4, 6), mesh1) == [Shard(0), Shard(1)]
    assert plan.replicated(mesh1) == [Replicate(), Replicate()]
    specs = {"w": tplan_spec((4, 6), ("embed", "mlp")), "b": tplan_spec((6,), ("mlp",))}
    assert plan.param_shardings(specs, mesh1) == {"w": [Shard(0), Shard(1)],
                                                  "b": [Replicate(), Shard(0)]}
    assert plan.sharding_for(torch.zeros(4, 3), mesh1) == ("data",)
    assert plan.sharding_for(torch.zeros(()), mesh1) == ()
    assert plan.sharding_for(torch.zeros(4, 3)) == ()  # no active mesh
    with mesh_mod.use(mesh1):
        assert plan.sharding_for(torch.zeros(4, 3)) == ("data",)
    x = torch.arange(24.0).reshape(4, 6)
    assert plan.constrain(x, ("batch", None)) is x
    d = distribute_tensor(x, mesh1, [Replicate(), Replicate()])
    c = plan.constrain(d, ("batch", "vocab"))
    assert isinstance(c, DTensor) and list(c.placements) == [Shard(0), Shard(1)]
    assert torch.equal(c.full_tensor(), x)
    assert plan.constrain(c, ("batch", "vocab")) is c


def tplan_spec(shape, axes):
    from repro_torch.models.params import ParamSpec

    return ParamSpec(shape, axes)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ["starcoder2_3b", "granite_moe_3b_a800m", "internvl2_2b"])
def test_state_batch_and_cache_shardings_match_reference_specs(arch, plan):
    """``train_state_shardings`` / ``batch_shardings`` / ``cache_shardings``
    of the smoke models on a 2×2×2 (pod, data, model) mapping: the
    placements of the reference's specs for the same logical axes."""
    from repro.configs import get_config as ref_config
    from repro.models.model import build_model as ref_build
    from repro.optim import adamw as radamw
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train import step as step_mod

    sizes = {"pod": 2, "data": 2, "model": 2}
    amesh = _abstract_mesh(sizes)
    rplan_, tplan_ = rplan.get_plan(plan), tplan.get_plan(plan)
    rmodel = ref_build(ref_config(arch, smoke=True), rplan_)
    tmodel = Model(get_config(arch, smoke=True), "cpu", plan=tplan_)

    def want(axes, shape):
        return tplan.placements(tuple(rplan_.spec(axes, shape, amesh)), sizes)

    specs = rmodel.param_specs()
    p_sh, o_sh = step_mod.train_state_shardings(tmodel, sizes)
    ax = radamw.state_axes(specs)
    assert set(p_sh) == set(specs)
    for k, sp in specs.items():
        assert p_sh[k] == want(sp.axes, sp.shape), k
        assert o_sh["m"][k] == o_sh["v"][k] == want(ax["m"][k], sp.shape), k
    assert o_sh["step"] == [Replicate()] * 3
    batch = {"tokens": torch.zeros(8, 33, dtype=torch.int32)}
    if arch == "internvl2_2b":
        batch["patches"] = torch.zeros(8, 4, tmodel.cfg.d_model)
    b_sh = step_mod.batch_shardings(tmodel, sizes, batch)
    for k, v in batch.items():
        assert b_sh[k] == want(rmodel.batch_axes()[k], tuple(v.shape)), k
    cache = tmodel.cache_specs(8, 64)
    c_sh = step_mod.cache_shardings(tmodel, sizes, cache)
    r_axes = rmodel.cache_axes()
    for k, sp in cache.items():
        assert c_sh[k] == want(r_axes[k], sp.shape), k
