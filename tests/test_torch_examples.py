"""The port's examples on the CPU (``--device cpu``): ``quickstart_torch``
prints the reference quickstart's values, ``serve_lm_torch`` serves all its
requests in one process and over two localities, and
``tiled_cholesky_torch`` factors as ``jax.numpy.linalg.cholesky`` does with
exactly the DAG's tasks."""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWO_LOCALITIES_TIMEOUT = 240  # s: two spawned processes on a loaded host


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _values(text):
    """The printed lines that carry values, not the counters' task counts."""
    return [line for line in text.splitlines()
            if line.strip() and not line.startswith("counter ")]


def test_quickstart_prints_the_reference_values(capsys):
    ref = _example("quickstart")
    ref.main()
    want = _values(capsys.readouterr().out)
    _example("quickstart_torch").main(["--device", "cpu"])
    got = _values(capsys.readouterr().out)
    assert got == want
    assert got[0] == "future chain: 42" and got[-1] == "parcel result: 32.0"
    assert "vec transform_reduce: 332833500" in got


@pytest.mark.parametrize("n, tile", [(256, 64), (192, 64), (256, 256)])
def test_tiled_cholesky_matches_jax_and_runs_the_dag(n, tile):
    """fp32 on the CPU: L within 1e-5 of ``jnp.linalg.cholesky`` relative to
    its largest entry, lower triangular, and exactly the DAG's tasks
    executed (20 at N = 256, tile 64: 4 potrf, 6 trsm, 6 syrk, 4 gemm)."""
    import repro_torch.core as core

    mod = _example("tiled_cholesky_torch")
    A = mod.spd_matrix(n, 0)
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(A)))
    core.init(num_workers=4)
    try:
        executed = "/scheduler{default}/tasks/executed"
        before = core.counters.get_value(executed)
        L = mod.tiled_cholesky(A, tile, "cpu")
        tasks = core.counters.get_value(executed) - before
    finally:
        core.finalize()
    assert L.device.type == "cpu" and L.dtype == torch.float32
    assert torch.equal(L, torch.tril(L))
    err = np.abs(L.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    assert tasks == mod.tile_tasks(n // tile)
    if (n, tile) == (256, 64):
        assert tasks == 20


def test_tiled_cholesky_example_runs_its_default():
    report = _example("tiled_cholesky_torch").main(["--device", "cpu"])
    assert report["tasks"] == 120 and report["rel_err"] <= 1e-5


def test_tiled_cholesky_refuses_a_ragged_tiling_and_an_indefinite_matrix():
    import repro_torch.core as core

    mod = _example("tiled_cholesky_torch")
    with pytest.raises(ValueError, match="not square in tiles of 64"):
        mod.tiled_cholesky(np.eye(100, dtype=np.float32), 64, "cpu")
    A = np.eye(128, dtype=np.float32)
    A[64, 64] = -1.0
    core.init(num_workers=4)
    try:
        with pytest.raises(torch.linalg.LinAlgError, match="diagonal tile 1 is not"):
            mod.tiled_cholesky(A, 64, "cpu")
    finally:
        core.finalize()


def test_serve_lm_one_process_completes_every_request():
    report = _example("serve_lm_torch").main(["--device", "cpu"])
    reqs = report["requests"]
    assert len(reqs) == 10 and all(len(out) == 13 for _, _, out in reqs)
    assert [t for _, t, _ in reqs] == [0.0, 0.8] * 5
    assert all(0 <= tok < 512 for _, _, out in reqs for tok in out)
    assert all(v > 0 for v in report["tokens_by_engine"].values())
    assert sum(report["tokens_by_engine"].values()) == 130


def test_serve_lm_over_two_localities_every_locality_serves():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, str(EXAMPLES / "serve_lm_torch.py"), "--device",
                        "cpu", "--localities", "2"], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=TWO_LOCALITIES_TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert sum(line.startswith(("greedy ", "sampled ")) for line in lines) == 12
    assert any(line.startswith("12 requests, 156 tokens") for line in lines)
    per_loc = next(line for line in lines if line.startswith("tokens by locality:"))
    per_loc = ast.literal_eval(per_loc.split(":", 1)[1].strip())
    assert set(per_loc) == {"locality#0", "locality#1"} and all(v > 0 for v in per_loc.values())
