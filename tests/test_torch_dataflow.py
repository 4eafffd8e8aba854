"""The port's futurization (``repro_torch.core.dataflow``): the reference's
eight cases of ``test_core_dataflow.py`` on the port's runtime, and the
same numpy-seeded task graphs through both packages, equal values."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core as rcore
import repro_torch.core as core
from repro_torch.core.dataflow import TaskGraph, dataflow, futurize
from repro_torch.core.future import make_ready_future


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def test_dataflow_waits_for_args(port_rt):
    a = core.spawn(lambda: 2)
    b = core.spawn(lambda: 3)
    c = dataflow(lambda x, y: x * y, a, b)
    assert c.get() == 6


def test_dataflow_nested_containers(port_rt):
    a = core.spawn(lambda: 1)
    c = dataflow(lambda d: d["x"] + d["y"][0], {"x": a, "y": [make_ready_future(2)]})
    assert c.get() == 3


def test_futurize_decorator(port_rt):
    @futurize
    def add(a, b):
        return a + b

    assert add(add(1, 2), add(3, 4)).get() == 10


def test_taskgraph_topological(port_rt):
    g = TaskGraph()
    g.add("a", lambda: 1)
    g.add("b", lambda x: x + 1, deps=["a"])
    g.add("c", lambda x: x * 10, deps=["a"])
    g.add("d", lambda x, y: x + y, deps=["b", "c"])
    assert g.run()["d"].get() == 12


def test_taskgraph_rejects_unknown_dep(port_rt):
    g = TaskGraph()
    with pytest.raises(ValueError):
        g.add("x", lambda y: y, deps=["missing"])


def test_taskgraph_rejects_duplicate(port_rt):
    g = TaskGraph()
    g.add("a", lambda: 1)
    with pytest.raises(ValueError):
        g.add("a", lambda: 2)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(-100, 100), min_size=1, max_size=40))
def test_dataflow_tree_reduction_matches_sum(port_rt, xs):
    """Property: a random dataflow reduction tree == plain sum."""
    futs = [make_ready_future(x) for x in xs]
    while len(futs) > 1:
        nxt = []
        for i in range(0, len(futs) - 1, 2):
            nxt.append(dataflow(lambda a, b: a + b, futs[i], futs[i + 1]))
        if len(futs) % 2:
            nxt.append(futs[-1])
        futs = nxt
    assert futs[0].get() == sum(xs)


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 30), st.data())
def test_random_dag_executes_in_dependency_order(port_rt, n, data):
    """Property: every node observes its dependencies' results (values
    propagate along a random DAG without races)."""
    g = TaskGraph()
    g.add("n0", lambda: 1)
    for i in range(1, n):
        deps = data.draw(st.lists(
            st.sampled_from([f"n{j}" for j in range(i)]),
            min_size=1, max_size=min(i, 4), unique=True))
        g.add(f"n{i}", lambda *vals: sum(vals) + 1, deps=deps)
    results = {k: f.get() for k, f in g.run().items()}
    assert all(v >= 1 for v in results.values())
    assert results["n0"] == 1


# ------------------------------------------------------ port vs reference
def _random_dag(seed, n):
    """A numpy-seeded DAG: (name, deps, coefficient) per node."""
    rng = np.random.default_rng(seed)
    nodes = [("n0", [], 1)]
    for i in range(1, n):
        k = int(rng.integers(1, min(i, 4) + 1))
        deps = sorted(rng.choice(i, size=k, replace=False).tolist())
        nodes.append((f"n{i}", [f"n{j}" for j in deps], int(rng.integers(-3, 4))))
    return nodes


def _run_graph(graph_cls, nodes):
    g = graph_cls()
    for name, deps, c in nodes:
        g.add(name, (lambda *vals, c=c: c + sum(vals) % 1000), deps=deps)
    return {k: f.get(timeout=60) for k, f in g.run().items()}


@pytest.mark.parametrize("seed,n", [(0, 8), (1, 25), (2, 60)])
def test_taskgraph_matches_reference(rt, port_rt, seed, n):
    nodes = _random_dag(seed, n)
    assert _run_graph(TaskGraph, nodes) == _run_graph(rcore.TaskGraph, nodes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dataflow_priority_and_executor_match_reference(rt, port_rt, seed):
    """``executor=`` and ``priority=`` compose (a ``PriorityExecutor``
    around the bound pool): the same futurized fold in both packages."""
    xs = np.random.default_rng(seed).integers(-50, 50, size=33).tolist()

    def fold(flow, runtime, make_ready):
        ex = runtime.get_executor("default")
        futs = [make_ready(x) for x in xs]
        while len(futs) > 1:
            nxt = [flow(lambda a, b: a * 3 + b, futs[i], futs[i + 1],
                        executor=ex, priority=i % 3)
                   for i in range(0, len(futs) - 1, 2)]
            futs = nxt + futs[len(futs) - len(futs) % 2:]
        return futs[0].get(timeout=60)

    want = fold(rcore.dataflow, rt, rcore.make_ready_future)
    assert fold(dataflow, port_rt, make_ready_future) == want
