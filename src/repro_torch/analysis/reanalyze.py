"""Re-derive each dry-run record's FLOPs, HBM traffic and collectives from
its saved op trace (``.trace.json.gz``) and update the record in place —
analysis refinements without tracing again.  Ported from the reference's
``analysis/reanalyze.py``, which re-parses archived HLO.

    PYTHONPATH=src python -m repro_torch.analysis.reanalyze [results/dryrun_torch]
"""

from __future__ import annotations

import gzip
import json
import sys
from pathlib import Path

from repro_torch.dist.hlo_analysis import analyze_trace, collectives_record

DEFAULT = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def reanalyze(results_dir: Path = DEFAULT) -> int:
    n = 0
    for jpath in sorted(Path(results_dir).glob("*.json")):
        tpath = jpath.with_suffix(".trace.json.gz")
        if not tpath.exists():
            continue
        rec = json.loads(jpath.read_text())
        with gzip.open(tpath, "rt") as f:
            an = analyze_trace(json.load(f), rec["n_devices"])
        rec["hlo_flops_per_device"] = float(an.dot_flops)
        rec["hlo_flops_total"] = rec["hlo_flops_per_device"] * rec["n_devices"]
        rec["hbm_traffic_per_device"] = float(an.memory_traffic)
        rec["collectives"] = collectives_record(an.collectives)
        rec["kernel_calls"] = an.kernel_calls
        jpath.write_text(json.dumps(rec, indent=1))
        n += 1
    return n


if __name__ == "__main__":
    d = Path(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT
    print(f"reanalyzed {reanalyze(d)} artifacts in {d}")
