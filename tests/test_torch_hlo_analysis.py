"""The port's static profiler (``repro_torch.dist.hlo_analysis``) against
the reference's HLO parser: the ring wire-byte model and the cross-pod
rule on the same kinds, bytes, groups and device counts; ``dot_flops`` of
jitted matmul chains and an MLP block against the profile of the same
functions in torch; and, on a fake process group, a step over L layers
issuing L times one layer's collectives, each all-gather's operand 1/g of
its result."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.dist import hlo_analysis as H

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


@pytest.mark.parametrize("kind,operand,group", list(itertools.product(
    KINDS, (4096, 12_345, 3 << 20), (1, 2, 16, 256))))
def test_wire_bytes_equal_reference(kind, operand, group):
    from repro.dist import hlo_analysis as R

    result = operand * group if kind == "all-gather" else (
        operand // group if kind == "reduce-scatter" else operand)
    args = dict(kind=kind, name="c", operand_bytes=operand, result_bytes=result,
                group_size=group, trip_count=3, crosses_pod=False)
    mine, ref = H.CollectiveOp(**args), R.CollectiveOp(**args)
    assert mine.wire_bytes_per_device == ref.wire_bytes_per_device
    assert mine.total_wire_bytes == ref.total_wire_bytes


@pytest.mark.parametrize("groups,n_devices", [
    ([[0, 1]], 256), ([[0, 256]], 512), ([[0, 16, 32]], 512), ([[255, 256]], 512),
    ([list(range(0, 512, 32))], 512), ([[3, 7], [300, 301]], 512), ([[0, 300]], 256)])
def test_cross_pod_rule_equals_reference(groups, n_devices):
    from repro.dist import hlo_analysis as R

    assert H._crosses_pod(groups, n_devices, pod_size=256) == R._crosses_pod(groups, n_devices)
    assert H._crosses_pod(groups, n_devices) == R._crosses_pod(groups, n_devices)


def _chain2(a, b, c):
    return (a @ b) @ c


def _chain3(a, b, c, d):
    return ((a @ b) @ c) @ d


def _mlp(x, w_in, w_gate, w_out):
    if isinstance(x, torch.Tensor):
        g = torch.nn.functional.gelu(x @ w_gate, approximate="tanh")
    else:
        import jax

        g = jax.nn.gelu(x @ w_gate)
    return (g * (x @ w_in)) @ w_out


@pytest.mark.parametrize("fn,shapes", [
    (_chain2, [(8, 16), (16, 32), (32, 4)]),
    (_chain3, [(5, 7), (7, 11), (11, 13), (13, 3)]),
    (_mlp, [(2, 12, 64), (64, 128), (64, 128), (128, 64)]),
])
def test_dot_flops_equal_reference(fn, shapes):
    import jax
    import jax.numpy as jnp

    from repro.dist.hlo_analysis import parse_module

    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    hlo = jax.jit(fn).lower(*[jnp.asarray(a) for a in arrays]).compile().as_text()
    want = parse_module(hlo, 1).dot_flops()
    _out, an, _trace = H.profile(fn, *[torch.from_numpy(a) for a in arrays])
    assert an.dot_flops == want


# ------------------------------------------------- on a fake process group
def _layer(x, w1, w2, plan):
    h = plan.constrain(x @ w1, ("batch", "mlp"))
    return plan.constrain(h @ w2, ("batch", None))


def _step_trace(L):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.plan import get_plan
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod

    plan = get_plan("futurized")
    with dryrun.fake_process_group(16):
        mesh = mesh_mod.make_mesh_shape((4, 4), ("data", "model"), "cpu")
        x = distribute_tensor(torch.ones(8, 32), mesh, plan.sharding(("batch", None), (8, 32), mesh),
                              src_data_rank=None)
        ws = [(distribute_tensor(torch.ones(32, 64), mesh,
                                 plan.sharding(("embed", "mlp"), (32, 64), mesh),
                                 src_data_rank=None),
               distribute_tensor(torch.ones(64, 32), mesh,
                                 plan.sharding(("mlp", "embed"), (64, 32), mesh),
                                 src_data_rank=None)) for _ in range(L)]

        def step(x):
            for w1, w2 in ws:
                x = _layer(x, plan.constrain(w1, (None, "mlp")),
                           plan.constrain(w2, ("mlp", None)), plan)
            return x

        _out, an, trace = H.profile(step, x, n_devices=16)
    return an, trace


def test_a_step_over_L_layers_issues_L_times_one_layers_collectives():
    one, _ = _step_trace(1)
    assert one.collectives.count() > 0
    for L in (2, 3):
        an, _ = _step_trace(L)
        assert an.collectives.count() == L * one.collectives.count()
        assert an.collectives.total_wire() == L * one.collectives.total_wire()
        assert an.dot_flops == L * one.dot_flops


def test_all_gather_operand_is_one_gth_of_its_result():
    an, trace = _step_trace(2)
    gathers = [o for o in an.collectives.ops if o.kind == "all-gather"]
    assert gathers
    for o in gathers:
        assert o.operand_bytes * o.group_size == o.result_bytes
        assert o.group_size == 4 and not o.crosses_pod
    assert all(len(r["group"]) == 4 for r in trace if "kind" in r)
