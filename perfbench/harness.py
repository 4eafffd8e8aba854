"""The benchmark's core: a cell's files found by name, the run, and the
result line.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` names

- ``configs/<config>.json``: the configuration as it is run (its source's
  keys, the departures, ``port.fields``: each field of the port's
  ``ModelConfig`` with the key of this file that gives it, or the value
  itself; ``port.reference``: what the plain reference needs besides);
- ``mixes/<traffic>.json``: the traffic, with its ``driver`` (a module of
  ``drivers/``) and its ``kind`` (the generator, a module of ``gen/``);
- ``cells/<cell>.json``: what belongs to the pair (a serving cell's rate,
  each compared number's limit);
- each per-layer metric ``<metric>``: ``layer_metrics/<metric>.py``, whose
  ``read(record)`` returns the number or None where it finds nothing.

A new configuration, mix, metric or cell is new files and a
``BENCHMARK.json`` entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent
FOREIGN = ("jax", "jaxlib", "flax", "repro")  # the JAX package and its stack


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Optional[Path] = None) -> Dict:
    return load_json(path or ROOT.parent / "BENCHMARK.json")


def cell_entry(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def _resolve(config: Dict, spec: Any) -> Any:
    """A key of the configuration file names its value; anything else is
    the value itself."""
    return config[spec] if isinstance(spec, str) and spec in config else spec


def load_config(root: Path, name: str) -> Tuple[Dict, Dict]:
    """(the file, the shape: the port's field names with the values as
    run, plus the reference's extras)."""
    config = load_json(root / "configs" / f"{name}.json")
    port = config["port"]
    shape = {f: _resolve(config, spec) for f, spec in port["fields"].items()}
    shape.update({f: _resolve(config, spec) for f, spec in port.get("reference", {}).items()})
    return config, shape


def port_config(config: Dict):
    """The port's ``ModelConfig`` of this configuration, refused where any
    field the file gives differs from the port's."""
    from repro_torch.configs import get_config

    port = config["port"]
    cfg = get_config(port["arch"], smoke=bool(port.get("smoke", False)))
    bad = []
    for f, spec in port["fields"].items():
        want, have = _resolve(config, spec), getattr(cfg, f)
        same = (math.isclose(float(want), float(have), rel_tol=1e-12)
                if isinstance(want, (int, float)) and not isinstance(want, bool)
                else want == have)
        if not same:
            bad.append(f"{f}: the port has {have!r}, the file {want!r}")
    if bad:
        raise ValueError(f"configuration {port['arch']} disagrees with the port: "
                         + "; ".join(bad))
    return cfg


def load_module(path: Path, tag: str):
    """A module of the benchmark by its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those that list it, and those with no list (per-layer:
    where the cell reports the metric it moves)."""
    e2e = {m["name"] for m in metrics_for(bench, cell, "end_to_end")} if kind == "per_layer" else None
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


@dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments and the
    generator; ``fault`` lets a test break the timed path underneath."""
    root: Path
    cell: str
    config: Dict
    shape: Dict
    mix: Dict
    params: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float
    gen: Any
    fault: Optional[Callable] = None


@dataclass
class Record:
    """What a per-layer reader reads, all on ``time.perf_counter`` but the
    profile's own clock."""
    shape: Dict
    peaks: Dict
    window: Tuple[float, float]
    # the window up to the profiled stretch: what the profiler does not slow
    quiet: Optional[Tuple[float, float]] = None
    spans: List[Tuple[str, float, float, Dict]] = field(default_factory=list)
    gauges: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    profile: Any = None
    steps: int = 0
    rows: int = 0                      # a training step's rows; a decode step's
    seq: int = 0
    microbatches: int = 0
    page_size: int = 0
    # per decode step (start, end, the live rows' lengths)
    decode_lengths: List[Tuple[float, float, List[int]]] = field(default_factory=list)
    # per request (due time, the times its tokens arrived)
    requests: List[Tuple[float, List[float]]] = field(default_factory=list)


@dataclass
class Outcome:
    """What a driver returns."""
    metrics: Dict[str, float]
    attempted: int
    failed: int
    correct: bool
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    record: Optional[Record] = None
    notes: List[str] = field(default_factory=list)


def power_limit_w() -> Optional[float]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def breakdown(profile) -> Dict[str, List]:
    """The device operations that took most time in the profiled
    stretch, and its longest idle gaps named by the program's spans the
    host was inside (``Profile.names``)."""
    from perfbench import stats

    by: Dict[str, float] = {}
    for name, a, b, _ in profile.device:
        by[name] = by.get(name, 0.0) + (b - a) / 1e9
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    idle = stats.gaps([(a, b) for _, a, b, _ in profile.device], profile.t0_ns, profile.t1_ns)
    named = []
    for a, b in idle[:10]:
        mid = (a + b) / 2
        inside = sorted({n for n, s, e in profile.names if s <= mid <= e})
        named.append([("host in " + "+".join(inside)) if inside else "host between spans",
                      (b - a) / 1e9])
    return {"device_ops": [[n[:160], s] for n, s in top], "idle_gaps": named}


def context(workload: str, seed: int, seconds: float, trace: bool, *, device: str,
            root: Path, bench: Dict, t_process: float, fault: Optional[Callable] = None):
    """(the cell's Context, its driver module)."""
    entry = cell_entry(bench, workload)
    config, shape = load_config(root, entry["config"])
    mix = load_json(root / "mixes" / f"{entry['traffic']}.json")
    params = load_json(root / "cells" / f"{workload}.json")
    ctx = Context(root=root, cell=workload, config=config, shape=shape, mix=mix,
                  params=params, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                  device=device, t_process=t_process,
                  gen=load_module(root / "gen" / f"{mix['kind']}.py", f"gen_{mix['kind']}"),
                  fault=fault)
    return ctx, load_module(root / "drivers" / f"{mix['driver']}.py", f"driver_{mix['driver']}")


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        chips: int = 1, t_process: Optional[float] = None, root: Path = ROOT,
        bench: Optional[Dict] = None, fault: Optional[Callable] = None) -> Dict:
    """One run of one cell → the result object (see ``run.py``)."""
    from perfbench import peaks as peaks_mod

    t_process = time.perf_counter() if t_process is None else t_process
    bench = bench if bench is not None else load_benchmark()
    ctx, drv = context(workload, seed, seconds, trace, device=device, root=root, bench=bench,
                       t_process=t_process, fault=fault)
    out: Outcome = drv.run(ctx)

    import torch

    on_card = device == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    result: Dict[str, Any] = {"correct": bool(out.correct), "attempted": int(out.attempted),
                              "failed": int(out.failed)}
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in metrics_for(bench, workload, "end_to_end"):
            if m["name"] not in out.metrics:
                raise KeyError(f"cell {workload} does not report {m['name']}")
            metrics[m["name"]] = {"value": out.metrics[m["name"]], "unit": m["unit"]}
    else:
        rec = out.record
        rec.peaks = peaks_mod.peaks(kind) if on_card else peaks_mod.PEAKS["NVIDIA H100 80GB HBM3"]
        for m in metrics_for(bench, workload, "per_layer"):
            reader = load_module(root / "layer_metrics" / f"{m['name']}.py", f"metric_{len(metrics)}")
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                print(f"per-layer metric {m['name']}: nothing to read in this run",
                      file=sys.stderr)
    result["metrics"] = metrics
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": chips,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace and out.record is not None and out.record.profile is not None:
        from perfbench import stats

        p = out.record.profile
        dev["busy_s"] = stats.union_length([(a, b) for _, a, b, _ in p.device],
                                           p.t0_ns, p.t1_ns) / 1e9
        dev["window_s"] = p.window_s
        result["device"] = dev
        result["breakdown"] = breakdown(p)
    else:
        result["device"] = dev
    result["power_limit_w"] = power_limit_w() if on_card else None
    result["notes"] = out.notes
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return result


def foreign_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is the JAX
    package's or JAX's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FOREIGN)


def emit(result: Dict) -> None:
    """Each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
