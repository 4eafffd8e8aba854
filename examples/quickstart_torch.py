"""Quickstart of the PyTorch port: the HPX-style AMT runtime in 60 lines,
on the GPU unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Section for section ``examples/quickstart.py``: futures, futurization,
task graphs, the execution policies, ``vec`` over a tensor on the device,
AGAS with a parcel, and the performance counters.
"""
import argparse

import torch

import repro_torch.core as core
from repro_torch._device import resolve_device
from repro_torch.core import algorithms as alg
from repro_torch.core.dataflow import TaskGraph, futurize
from repro_torch.core.executor import par, par_task, vec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises without CUDA unless asked for the CPU

    # hpx::init — the resource partitioner carves workers into named pools
    # (compute on "default", host I/O progress on "io")
    core.init(policy="local", pools={"default": 4, "io": 1})

    # 1. futures: wait-free asynchronous execution --------------------------
    f = core.spawn(lambda: 21)
    g = f.then_value(lambda x: x * 2)  # continuation, runs on the pool
    print("future chain:", g.get())  # 42

    # 2. futurization: sequential code → dataflow DAG -----------------------
    @futurize
    def mul(a, b):
        return a * b

    @futurize
    def add(a, b):
        return a + b

    print("dataflow DAG:", add(mul(3, 4), mul(5, 6)).get())  # 42

    # explicit task graphs (the tiled-Cholesky pattern)
    graph = TaskGraph()
    graph.add("a", lambda: 2)
    graph.add("b", lambda x: x + 3, deps=["a"])
    graph.add("c", lambda x, y: x * y, deps=["a", "b"])
    print("task graph:", graph.run()["c"].get())  # 10

    # 3. parallel algorithms with execution policies (C++17 style) ----------
    #    policies are pure rewrites: .on(executor) binds resources,
    #    .with_() tunes parameters, par_task returns Futures (two-way);
    #    vec runs on the tensor's own device
    data = list(range(1_000))
    print("par reduce:", alg.reduce(par, data))
    io_bound = par.on(core.get_runtime().get_executor("io")).with_(chunk_size=250)
    print("reduce on the io pool:", alg.reduce(io_bound, data))
    print("par_task sort is a Future:", alg.sort(par_task, [3, 1, 2]).get())
    print("vec transform_reduce:",
          int(alg.transform_reduce(vec, torch.arange(1_000, device=device),
                                   lambda x: x * x)))

    # 4. AGAS + parcels: send work to data ----------------------------------
    core.agas.register({"weights": torch.ones((4, 4), device=device)}, name="/demo/model")
    fut = core.parcel.apply(lambda obj, s: float(obj["weights"].sum()) * s,
                            "/demo/model", 2.0)
    print("parcel result:", fut.get())  # 32.0

    # 5. performance counters (APEX style, per pool) ------------------------
    for name, value in core.counters.query("/scheduler{default}/tasks/*"):
        print(f"counter {name} = {value:.0f}")
    for name, value in core.counters.query("/scheduler{io}/tasks/executed"):
        print(f"counter {name} = {value:.0f}")

    core.finalize()


if __name__ == "__main__":
    main()
