"""Multi-pod dry run: trace every (arch × shape × mesh) cell's real step on
one process that stands for rank 0 of 256 or 512 — the port's counterpart
of the reference's ``launch/dryrun.py``, which lowers and compiles each
cell for 256 or 512 placeholder devices.

For each cell :func:`run_cell` brings up a ``fake`` process group of 256
(``pod``, 16×16) or 512 (``multipod``, 2×16×16) ranks, builds the
production mesh on it (``launch.mesh.make_production_mesh``), makes the
state under ``FakeTensorMode`` as DTensors in the plan's placements
(``distribute_tensor(..., src_data_rank=None)``: no data, no
communication), runs the port's ``make_train_step`` /
``make_prefill_step`` / ``make_decode_step`` once, and tears the group
down.  Over that one call it records, for rank 0:

- ``memory``: the argument bytes (the local shards of the params and, in
  training, of the optimizer state; the inputs or cache) and the peak
  (``torch.distributed._tools.mem_tracker.MemTracker``);
- the op profile of ``dist.hlo_analysis``: matmul and kernel FLOPs, HBM
  traffic and the collective inventory;
- ``CommDebugMode``'s collective counts and each kernel op's calls;
- ``cost_analysis_raw``: the FLOPs of every op ``FlopCounterMode`` has a
  formula for, from the same trace.

The kernels run as their ``repro_torch::`` ops' fake implementations, so
no kernel launches.  A cell traces for the device of ``--device``
(``cuda`` unless ``--device cpu`` is given): the card's route needs a
CUDA build of torch; a CPU build traces the same program for CPU
tensors.  Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh>__<plan>.json``
(git ignores the folder), and beside each the op trace, gzipped
(``.trace.json.gz``), which ``analysis/reanalyze.py`` re-derives the
record from.  Nothing happens at import.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen25_3b --shape train_4k --mesh pod --device cpu
  python -m repro_torch.launch.dryrun --all [--mesh both] [--plan futurized] --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gzip
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, Iterator

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A ``fake`` process group of ``world_size`` ranks, this process as
    rank 0: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_shard_sizes_outside_fake_mode() -> Iterator[None]:
    """DTensor computes a strided shard's local size with a ``torch.arange``
    that, under ``FakeTensorMode``, becomes a fake tensor whose length it
    then asks for (a data-dependent error).  The computation is on
    integers alone, so it runs with the mode set aside."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    _StridedShard = getattr(placement_types, "_StridedShard", None)
    orig = getattr(_StridedShard, "local_shard_size_and_offset", None)
    if orig is None:  # a torch without it computes the sizes otherwise
        yield
        return

    @functools.wraps(orig)
    def sizes(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = sizes
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _variant_plan(plan, variant: str):
    """The reference's perf-iteration ablations of a plan."""
    if not variant:
        return plan
    rules = dict(plan.rules)
    if variant in ("bf16only", "nomods"):
        rules["seq_sp"] = None
    kw: Dict[str, Any] = {"rules": rules}
    if variant in ("sponly", "nomods", "spupfront"):
        kw["bf16_boundaries"] = False
    if variant == "spupfront":  # gather weights once per step, reuse
        kw["gather_upfront"] = True
    if variant in ("tponly", "tponly-kvseq"):  # the serve plan's ablations
        rules["embed"] = None
        kw["fsdp"] = False
        kw["gather_upfront"] = True
        if variant == "tponly":
            rules["kv_seq"] = None
    return replace(plan, **kw)


def _local_bytes(tree: Any) -> int:
    """Bytes of the local shards of every tensor in a (nested) dict."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _tensors(tree: Any):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif hasattr(tree, "shape"):
        yield tree


def cell_tag(plan_name: str, microbatches: int = 1, variant: str = "") -> str:
    tag = plan_name if microbatches == 1 else f"{plan_name}-mb{microbatches}"
    return f"{tag}-{variant}" if variant else tag


def _step_and_args(model, cell, mesh, dev):
    """The cell's step function and its arguments as DTensors without data
    (call under ``FakeTensorMode``): params (fp32 masters and the AdamW
    state for training, bf16 weights for serving), and the batch, the
    prefill's inputs or the decode cache and token, in the plan's
    placements."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    plan = model.plan
    p_sh, o_sh = step_mod.train_state_shardings(model, mesh)

    def place(tree, sh):
        return {k: distribute_tensor(v, mesh, sh[k], src_data_rank=None)
                for k, v in tree.items()}

    if cell.kind == "train":
        st = adamw.abstract_state(model.param_specs(), dev)
        opt = {"m": place(st["m"], o_sh["m"]), "v": place(st["v"], o_sh["v"]),
               "step": distribute_tensor(st["step"], mesh, o_sh["step"],
                                         src_data_rank=None)}
        batch = step_mod.place_batch(model, mesh, model.batch_specs(cell, dev))
        return (step_mod.make_train_step(model, adamw.AdamWConfig(), mesh),
                (place(model.abstract_params(dev), p_sh), opt, batch))
    # serving runs bf16 weights (no fp32 master copy at inference)
    params = place(model.abstract_params(dev, torch.bfloat16), p_sh)
    if cell.kind == "prefill":
        inputs = step_mod.place_batch(model, mesh, model.prefill_specs(cell, dev))
        return step_mod.make_prefill_step(model), (params, inputs)
    cache, token = model.decode_specs(cell, dev)
    cache = place(cache, step_mod.cache_shardings(model, mesh, cache))
    token = distribute_tensor(token, mesh, plan.sharding(("batch", None), token.shape, mesh),
                              src_data_rank=None)
    return step_mod.make_decode_step(model), (params, cache, token)


def _measure(fn, args) -> Dict[str, Any]:
    """One call of ``fn(*args)`` under the op profiler, ``CommDebugMode``
    and ``MemTracker`` (the arguments counted as already resident),
    DTensor's shape propagation hidden from all three."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.dist.hlo_analysis import OpProfiler, hidden_shape_propagation

    tree = dict(enumerate(args))
    mem = MemTracker()
    mem.track_external(*_tensors(tree))
    prof = OpProfiler()
    t0 = time.time()
    with hidden_shape_propagation(), CommDebugMode() as comm, mem, prof:
        fn(*args)
    return {
        "trace": prof.trace, "trace_s": time.time() - t0,
        "argument_bytes": _local_bytes(tree),
        "peak_bytes": sum(v["Total"] for v in mem.get_tracker_snapshot("peak").values()),
        "comm_counts": {str(k).split(".")[-1]: int(v)
                        for k, v in comm.get_comm_counts().items()},
    }


def measure_cell(model, cell, mesh_shape, mesh_axes, device) -> Dict[str, Any]:
    """Trace ``model``'s step for a shape cell on a ``mesh_shape`` mesh of a
    fake process group of as many ranks, on stand-ins without data for
    ``device``: the measurements of :func:`_measure` (the op trace, its
    seconds, argument and peak bytes, ``CommDebugMode``'s counts), with
    ``build_s``, the seconds to make the state."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import mesh as mesh_mod

    t0 = time.time()
    with fake_process_group(math.prod(mesh_shape)), _strided_shard_sizes_outside_fake_mode():
        mesh = mesh_mod.make_mesh_shape(mesh_shape, mesh_axes, device.type)
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = _step_and_args(model, cell, mesh, device)
            build_s = time.time() - t0
            return {**_measure(fn, args), "build_s": build_s}


def cell_record(arch: str, cell, mesh_name: str, tag: str, n_dev: int, model,
                m: Dict[str, Any]) -> Dict[str, Any]:
    """The record of one traced cell (the reference's fields, and the
    port's ``device``, ``kernel_calls`` and ``comm_counts``)."""
    from repro_torch.dist import hlo_analysis as H
    from repro_torch.models.params import param_bytes

    an = H.analyze_trace(m["trace"], n_dev)
    peak, arg_bytes = m["peak_bytes"], m["argument_bytes"]
    return {
        "arch": arch, "shape": cell.name, "mesh": mesh_name, "plan": tag,
        "n_devices": n_dev, "kind": cell.kind,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "param_bytes_fp32": param_bytes(model.param_specs()),
        "lower_s": round(m["build_s"], 2), "compile_s": round(m["trace_s"], 2),
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "peak_size_in_bytes": int(peak),
                   "temp_size_in_bytes": int(max(peak - arg_bytes, 0))},
        "hlo_flops_per_device": float(an.dot_flops),
        "hlo_flops_total": float(an.dot_flops) * n_dev,
        "hbm_traffic_per_device": float(an.memory_traffic),
        "cost_analysis_raw": {"flops": float(an.flops)},
        "collectives": H.collectives_record(an.collectives),
        "hlo_bytes": len(json.dumps(m["trace"])),
        "device": model.device.type,
        "kernel_calls": an.kernel_calls,
        "comm_counts": m["comm_counts"],
    }


def run_cell(arch: str, shape: str, mesh_name: str, plan_name: str = "futurized",
             out_dir: Path = RESULTS, force: bool = False, microbatches: int = 1,
             variant: str = "", device: str = "cuda", cfg=None,
             save: bool = True) -> Dict[str, Any]:
    """Trace one cell on the production mesh (16×16 ``pod`` or 2×16×16
    ``multipod``) and return (and, with ``save``, write) its record, the
    trace under ``"_trace"``.  ``cfg`` overrides the arch's full config
    (tests pass smoke ones)."""
    from repro_torch._device import resolve_device
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.dist.plan import get_plan
    from repro_torch.models.model import Model

    tag = cell_tag(plan_name, microbatches, variant)
    out_path = Path(out_dir) / f"{arch}__{shape}__{mesh_name}__{tag}.json"
    if save and out_path.exists() and not force:
        return json.loads(out_path.read_text())
    dev = resolve_device(device)
    cell = SHAPES[shape]
    plan = _variant_plan(get_plan(plan_name, **({"microbatches": microbatches}
                                                if microbatches > 1 else {})), variant)
    model = Model(cfg if cfg is not None else get_config(arch), dev, plan=plan)
    multi = mesh_name == "multipod"
    shape_, axes = (((2, 16, 16), ("pod", "data", "model")) if multi
                    else ((16, 16), ("data", "model")))
    m = measure_cell(model, cell, shape_, axes, dev)
    rec = cell_record(arch, cell, mesh_name, tag, math.prod(shape_), model, m)
    if save:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
        with gzip.open(trace_path(out_path), "wt") as f:
            json.dump(m["trace"], f)
    rec["_trace"] = m["trace"]
    return rec


def bf16_all_reduces(trace) -> int:
    """All-reduce calls on bf16 tensors in an op trace (the pod-manual
    gradients' half-width hop)."""
    def bf16(a):
        return isinstance(a, list) and (a[1:] == ["bfloat16"] or any(map(bf16, a)))

    return sum(r["n"] for r in trace
               if r.get("kind") == "all-reduce" and bf16(r["args"][0]))


def trace_path(record_path: Path) -> Path:
    """The gzipped op trace saved beside a record."""
    return Path(record_path).with_suffix(".trace.json.gz")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod", "both"))
    ap.add_argument("--plan", default="futurized")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--variant", default="",
                    choices=("", "bf16only", "sponly", "nomods", "spupfront",
                             "tponly", "tponly-kvseq"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the step is traced for (cuda needs a CUDA build)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        # a subprocess per cell: isolation and bounded memory per trace
        from repro_torch.configs import all_cells

        meshes = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)
        done = failed = 0
        for mesh_name in meshes:
            for arch, shape in all_cells():
                tag = f"{arch}__{shape}__{mesh_name}__{args.plan}"
                if (out_dir / f"{tag}.json").exists() and not args.force:
                    done += 1
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape, "--mesh", mesh_name, "--plan", args.plan,
                       "--out", str(out_dir), "--device", args.device]
                if args.force:
                    cmd.append("--force")
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True)
                ok = r.returncode == 0
                done += ok
                failed += not ok
                print(f"[{'OK' if ok else 'FAIL'}] {tag} ({time.time() - t0:.0f}s)",
                      flush=True)
                if not ok:
                    out_dir.mkdir(parents=True, exist_ok=True)
                    (out_dir / f"{tag}.err").write_text(
                        r.stdout[-4000:] + "\n" + r.stderr[-8000:])
        print(f"dryrun --all: {done} ok, {failed} failed")
        sys.exit(1 if failed else 0)

    rec = run_cell(args.arch, args.shape, args.mesh, args.plan, out_dir=out_dir,
                   force=args.force, microbatches=args.microbatches,
                   variant=args.variant, device=args.device)
    rec.pop("_trace", None)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
