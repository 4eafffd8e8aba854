"""The port's object migration (``repro_torch.core.migration``): the
reference's three migration cases of ``test_migration_data.py`` with CPU
placements (a placement is a device, or a tree of devices), and the same
numpy-seeded tree migrated in both packages — equal values, the same
generations, the GID kept."""
import threading

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.core as core
from repro.core import agas as ragas
from repro.core import migration as rmigration
from repro_torch.core import agas, counters, migration

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def port_rt():
    """The port's own AMT runtime (the root ``rt`` fixture is the
    reference's)."""
    runtime = core.init(num_workers=4, policy="local")
    yield runtime
    core.finalize()


def test_migrate_tree_preserves_values():
    tree = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones((4,))}
    before = counters.counter("/migration/trees/cumulative").get_value()
    moved = migration.migrate_tree(tree, CPU)
    torch.testing.assert_close(moved["w"], tree["w"], rtol=0, atol=0)
    assert moved["w"].device == CPU
    assert counters.counter("/migration/trees/cumulative").get_value() == before + 1


def test_agas_migration_generation_and_identity(port_rt):
    gid = agas.default().register({"x": torch.ones((8,))})
    gen = migration.migrate(gid, CPU)
    assert gen == 1
    rec = agas.default().record(gid)
    assert rec.placement == CPU
    torch.testing.assert_close(rec.obj["x"], torch.ones((8,)), rtol=0, atol=0)
    gen2 = migration.migrate(gid, CPU)
    assert gen2 == 2  # GID stable across migrations
    assert agas.default().record(gid).gid == gid


def test_migrate_generation_never_stale_under_concurrent_resolve(port_rt):
    """Property: after migrate() returns generation g, every subsequent
    resolve observes generation >= g and the matching placement — readers
    racing the migration never see a *rolled-back* record."""

    @settings(max_examples=8, deadline=None)
    @given(st.integers(min_value=2, max_value=5),
           st.integers(min_value=3, max_value=12))
    def prop(n_readers, n_migrations):
        a = agas.AGAS(locality=0)
        gid = a.register({"x": torch.arange(4.0)}, placement="gen0")
        stop = threading.Event()
        violations = []

        def reader():
            # generation and placement-index must each be monotonic from
            # any reader's viewpoint: a decrease = a rolled-back (stale)
            # record became visible after a later one
            last_gen, last_idx = -1, -1
            while not stop.is_set():
                rec = a.record(gid)
                gen = rec.generation
                idx = int(str(rec.placement)[3:])
                if gen < last_gen or idx < last_idx:
                    violations.append((last_gen, gen, last_idx, idx))
                last_gen, last_idx = max(last_gen, gen), max(last_idx, idx)

        threads = [threading.Thread(target=reader, daemon=True)
                   for _ in range(n_readers)]
        for t in threads:
            t.start()
        try:
            for k in range(1, n_migrations + 1):
                moved = migration.migrate_tree(a.resolve(gid), CPU)
                gen = a.rebind(gid, moved, placement=f"gen{k}")
                assert gen == k
                # the bound just returned must be visible immediately
                rec = a.record(gid)
                assert rec.generation >= gen
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert not violations, violations[:3]

    prop()


def test_placement_tree_must_match():
    tree = {"a": torch.zeros(2), "b": [torch.ones(1), torch.ones(2)]}
    moved = migration.migrate_tree(tree, {"a": "cpu", "b": ["cpu", CPU]})
    assert moved["b"][1].device == CPU and isinstance(moved["b"], list)
    with pytest.raises(ValueError):
        migration.migrate_tree(tree, {"a": "cpu", "b": ["cpu"]})
    with pytest.raises(ValueError):
        migration.migrate_tree({"a": torch.zeros(1)}, {"a": ["cpu"]})


def test_migrate_to_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        assert migration.migrate_tree(torch.ones(2), "cuda").is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        migration.migrate_tree({"x": torch.ones(2)}, "cuda")


@pytest.mark.parametrize("seed", [0, 1])
def test_migration_matches_reference(rt, port_rt, seed):
    """The same seeded tree registered and migrated twice in each package:
    the same generations 1 and 2, the GID unchanged, the values equal."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "blk": {"b": rng.integers(-9, 9, size=(4,))}}
    sh = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    rgid = ragas.default().register(jax.tree.map(np.copy, tree))
    pgid = agas.default().register({"w": torch.from_numpy(tree["w"].copy()),
                                    "blk": {"b": torch.from_numpy(tree["blk"]["b"].copy())}})
    gens = ([rmigration.migrate(rgid, sh) for _ in range(2)],
            [migration.migrate(pgid, CPU) for _ in range(2)])
    assert gens[0] == gens[1] == [1, 2]
    rrec, prec = ragas.default().record(rgid), agas.default().record(pgid)
    assert prec.gid == pgid and prec.generation == rrec.generation == 2
    np.testing.assert_array_equal(prec.obj["w"].numpy(), np.asarray(rrec.obj["w"]))
    np.testing.assert_array_equal(prec.obj["blk"]["b"].numpy(), np.asarray(rrec.obj["blk"]["b"]))
