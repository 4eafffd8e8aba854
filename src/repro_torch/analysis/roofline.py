"""Roofline analysis over the dry run's records — ported from the
reference's ``analysis/roofline.py``, with one H100 SXM5's constants
(``launch/mesh.py``) in the place of the v5e's.

Three terms per (arch × shape × mesh), in seconds per step:

    compute    = FLOPs_total      / (GPUs × 989 TF/s bf16)
    memory     = HBM_traffic/GPU  /          3.35 TB/s
    collective = in-pod wire/(GPUs × 50 GB/s) + cross-pod wire/(GPUs × 25 GB/s)

The FLOPs and HBM traffic come from the op profile of
``dist.hlo_analysis`` (matmuls and the kernel ops' formulas; result bytes
of every materialising op).  MODEL_FLOPS = 6·N·D (train) / 2·N·D
(inference), N_active for MoE: the useful-compute ratio MODEL_FLOPS /
FLOPs exposes remat and quadratic-attention overheads.  Every term is a
prediction from these constants, not a measurement.

    PYTHONPATH=src python -m repro_torch.analysis.roofline [pod|multipod] [DIR]
    PYTHONPATH=src python -m repro_torch.analysis.roofline --cells [DIR]
"""

from __future__ import annotations

import argparse
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.launch import mesh as _mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def active_param_count(arch: str) -> int:
    """Activated parameters per token (MoE: shared + top-k routed), from
    the param specs alone (nothing is allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import param_specs

    cfg = get_config(arch)
    total = 0
    for path, s in param_specs(cfg).items():
        n = math.prod(s.shape)
        if cfg.is_moe and "moe/w_" in path:  # routed experts: top_k of E active
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


def model_flops(rec: Dict) -> float:
    """MODEL_FLOPS: 6·N_active·D train, 2·N_active·D inference."""
    n = active_param_count(rec["arch"])
    if rec["kind"] == "train":
        return 6.0 * n * rec["global_batch"] * rec["seq_len"]
    if rec["kind"] == "prefill":
        return 2.0 * n * rec["global_batch"] * rec["seq_len"]
    return 2.0 * n * rec["global_batch"]  # decode: one token per slot


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    plan: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    ici_s: float
    dci_s: float
    model_flops: float
    hlo_flops: float
    step_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0

    def finish(self) -> "Roofline":
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        # overlapped execution: perfectly async collectives and copies, so
        # the step takes the largest term; the roofline fraction is the
        # useful compute's time at peak over that bound
        self.step_s = max(terms.values())
        ideal = self.model_flops / (self.chips * _mesh.PEAK_FLOPS_BF16)
        self.useful_ratio = self.model_flops / self.hlo_flops if self.hlo_flops else 0.0
        self.roofline_fraction = ideal / self.step_s if self.step_s else 0.0
        return self


def analyze(rec: Dict) -> Roofline:
    chips = rec["n_devices"]
    coll = rec["collectives"]
    ici = coll["wire_bytes_ici"] / (chips * _mesh.ICI_BW)
    dci = coll["wire_bytes_dci"] / (chips * _mesh.DCI_BW)
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], plan=rec["plan"],
        chips=chips,
        compute_s=rec["hlo_flops_total"] / (chips * _mesh.PEAK_FLOPS_BF16),
        memory_s=rec["hbm_traffic_per_device"] / _mesh.HBM_BW,
        collective_s=ici + dci,
        ici_s=ici, dci_s=dci,
        model_flops=model_flops(rec),
        hlo_flops=rec["hlo_flops_total"],
    ).finish()


def load_records(results_dir: Path = RESULTS, plan: Optional[str] = None,
                 mesh: Optional[str] = None) -> List[Dict]:
    recs = []
    for p in sorted(Path(results_dir).glob("*.json")):
        r = json.loads(p.read_text())
        if plan and r.get("plan") != plan:
            continue
        if mesh and r.get("mesh") != mesh:
            continue
        recs.append(r)
    return recs


def table(results_dir: Path = RESULTS, plan: str = "futurized",
          mesh: str = "pod") -> List[Roofline]:
    return [analyze(r) for r in load_records(results_dir, plan, mesh)]


def format_table(rows: List[Roofline]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'chips':>5s} {'compute':>9s} "
           f"{'memory':>9s} {'coll':>9s} {'bottleneck':>10s} {'MF/HF':>6s} "
           f"{'roofline%':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.chips:5d} {r.compute_s:9.2e} "
            f"{r.memory_s:9.2e} {r.collective_s:9.2e} {r.bottleneck:>10s} "
            f"{r.useful_ratio:6.2f} {100 * r.roofline_fraction:8.1f}%")
    return "\n".join(lines)


HBM_BYTES = 80e9  # one H100 SXM5's device memory


def cell_table(results_dir: Path = RESULTS, plan: str = "futurized") -> str:
    """A markdown grid, an arch a row and a shape a column: each cell's
    per-rank peak in GB on ``pod`` / ``multipod`` (✗ where it exceeds one
    card's 80 GB) and its bottleneck term with that term's share of the
    three terms' sum on each mesh."""
    from repro_torch.configs import ARCH_IDS, SHAPES

    cells: Dict = {}
    for rec in load_records(results_dir, plan):
        r = analyze(rec)
        terms = r.compute_s + r.memory_s + r.collective_s
        share = max(r.compute_s, r.memory_s, r.collective_s) / terms if terms else 0.0
        cells[rec["arch"], rec["shape"], rec["mesh"]] = (
            rec["memory"]["peak_size_in_bytes"] / 1e9, r.bottleneck, share)

    def entry(arch: str, shape: str) -> str:
        got = [cells.get((arch, shape, m)) for m in ("pod", "multipod")]
        if not any(got):
            return "—"
        peaks = " / ".join("?" if g is None else
                           f"{g[0]:.1f}{'' if g[0] <= HBM_BYTES / 1e9 else ' ✗'}" for g in got)
        if all(got) and got[0][1] == got[1][1]:
            bounds = f"{got[0][1]} {100 * got[0][2]:.0f} / {100 * got[1][2]:.0f} %"
        else:
            bounds = " / ".join("?" if g is None else f"{g[1]} {100 * g[2]:.0f} %" for g in got)
        return f"{peaks}; {bounds}"

    lines = ["| arch | " + " | ".join(SHAPES) + " |", "| --- |" + " --- |" * len(SHAPES)]
    for arch in ARCH_IDS:
        lines.append(f"| {arch} | " + " | ".join(entry(arch, sh) for sh in SHAPES) + " |")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> None:
    """``[MESH] [DIR]``: one mesh's table (``pod`` by default) of the
    records in ``DIR``; ``--cells [DIR]``: the grid of :func:`cell_table`.
    ``DIR`` defaults to ``results/dryrun_torch/``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.roofline")
    ap.add_argument("--cells", nargs="?", const=RESULTS, type=Path, metavar="DIR",
                    help="print the arch × shape grid of every record in DIR")
    ap.add_argument("mesh", nargs="?", default="pod", choices=("pod", "multipod"))
    ap.add_argument("dir", nargs="?", default=RESULTS, type=Path)
    args = ap.parse_args(argv)
    if args.cells is not None:
        print(cell_table(args.cells))
    else:
        print(format_table(table(args.dir, mesh=args.mesh)))


if __name__ == "__main__":
    main()
