"""Tiled Cholesky by futurization on the port — the paper's linear-algebra
showcase, on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/tiled_cholesky_torch.py
    PYTHONPATH=src python examples/tiled_cholesky_torch.py --device cpu --n 256 --tile 64

As ``examples/tiled_cholesky.py``: the right-looking blocked factorization
is a dataflow DAG in which each tile op (potrf / trsm / syrk / gemm) is a
task whose inputs are futures of other tiles.  No global barrier anywhere —
tasks fire the moment their tiles are ready (the paper's
'constraint-based synchronization').  The tiles stay on the device: a task
only enqueues its tile op on the device's stream, which orders the device
work as the DAG orders the tasks, and L is assembled there.
"""
import argparse
import functools
import time

import numpy as np
import torch

import repro_torch.core as core
from repro_torch._device import resolve_device
from repro_torch.core.dataflow import dataflow


def _potrf(C, info, k):
    """L of diagonal tile ``k``: ``cholesky_ex`` leaves its status in
    ``info[k]`` for the caller to check once, so the task does not wait for
    the device (``cholesky`` would)."""
    L, info[k] = torch.linalg.cholesky_ex(C)
    return L


def _trsm(L, B):
    """X with X·Lᵀ = B: the panel tile below the diagonal."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True, left=False)


def _syrk(C, L):
    return C - L @ L.mT


def _gemm(C, A, B):
    return C - A @ B.mT


def tile_tasks(n: int) -> int:
    """The tasks of an ``n`` × ``n``-tile factorization: n potrf, n(n−1)/2
    trsm and syrk each, C(n, 3) gemm."""
    return n + n * (n - 1) + n * (n - 1) * (n - 2) // 6


def tiled_cholesky(A, tile: int, device=None) -> torch.Tensor:
    """Right-looking blocked Cholesky of the SPD matrix ``A`` (an array or
    tensor, N a multiple of ``tile``) as a dataflow DAG of tile tasks, on
    ``device`` (``cuda`` unless asked for the CPU): the lower factor L,
    on the device."""
    dev = resolve_device(device)
    A = torch.as_tensor(A).to(dev)
    N = A.shape[0]
    if A.shape != (N, N) or N % tile:
        raise ValueError(f"A of shape {tuple(A.shape)} is not square in tiles of {tile}")
    n = N // tile

    def blk(i):
        return slice(i * tile, (i + 1) * tile)

    tiles = {(i, j): core.make_ready_future(A[blk(i), blk(j)])
             for i in range(n) for j in range(n) if j <= i}
    info = [None] * n
    for k in range(n):
        tiles[(k, k)] = dataflow(functools.partial(_potrf, info=info, k=k), tiles[(k, k)])
        for i in range(k + 1, n):
            tiles[(i, k)] = dataflow(_trsm, tiles[(k, k)], tiles[(i, k)])
        for i in range(k + 1, n):
            tiles[(i, i)] = dataflow(_syrk, tiles[(i, i)], tiles[(i, k)])
            for j in range(k + 1, i):
                tiles[(i, j)] = dataflow(_gemm, tiles[(i, j)], tiles[(i, k)],
                                         tiles[(j, k)])
    L = torch.zeros_like(A)
    for (i, j), fut in tiles.items():
        L[blk(i), blk(j)] = fut.get()
    failed = torch.stack(info).ne(0)
    if bool(failed.any()):  # the one wait for the device
        raise torch.linalg.LinAlgError(f"tiled_cholesky: diagonal tile "
                                       f"{int(failed.nonzero()[0])} is not positive-definite")
    return L


def spd_matrix(N: int, seed: int) -> np.ndarray:
    """X·Xᵀ + N·I with X standard normal, fp32 (``bench_cholesky.py``'s)."""
    X = np.random.default_rng(seed).standard_normal((N, N)).astype(np.float32)
    return X @ X.T + N * np.eye(N, dtype=np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    core.init(num_workers=4)
    N, tile = args.n, args.tile
    A = torch.from_numpy(spd_matrix(N, 7)).to(dev)
    executed = "/scheduler{default}/tasks/executed"
    before = core.counters.get_value(executed)
    t0 = time.perf_counter()
    L = tiled_cholesky(A, tile, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tasks = int(core.counters.get_value(executed) - before)
    err = float((L @ L.mT - A).abs().max() / A.abs().max())
    n_tiles = (N // tile) * (N // tile + 1) // 2
    print(f"N={N} tile={tile} ({n_tiles} tiles) on {dev} in {dt * 1e3:.1f} ms, "
          f"reconstruction rel err {err:.2e}")
    print("tasks executed:", tasks)
    core.finalize()
    return {"seconds": dt, "rel_err": err, "tasks": tasks}


if __name__ == "__main__":
    main()
