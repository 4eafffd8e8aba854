"""The readings that a cell's limits are set from, at the cell's own size
on the card: for each seed, the program's compared numbers and, with
``--control``, those of the reference put in the program's place in the
precision below the configuration's (fp8 for bf16), and with
``--faults`` those of the faults the check has to catch:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 8 [--control] [--faults]

A serving cell runs a short window at its own rate for each seed, long
enough to finish as many requests as a run compares, and reads the
logit gaps of the program's served tokens and (``--control``) of the
fp8 reference's first choices at the same positions, and whether each
passes the cell's own checks (the driver's ``judge``, its limits).  A training
cell drives its checked steps and reads the program against the fp32
reference, and (``--control``) the fp8 reference against it, and
(``--faults``) the reference over half of each step's rows.  One JSON
line a seed.  The benchmark's runs never call this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkout", default=str(CHECKOUT),
                    help="where BENCHMARK.json and its perfbench/ folder are")
    args = ap.parse_args()
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    from perfbench import harness

    root = Path(args.checkout) / "perfbench"
    bench = harness.load_benchmark(Path(args.checkout) / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds, args.control,
                                  args.faults, args.device, root, bench)), flush=True)
    return 0


def readings(workload, seed, seconds, control, faults, device, root, bench):
    """One seed's readings (see the module's doc)."""
    from perfbench import harness

    ctx, drv = harness.context(workload, seed, seconds, False, device=device, root=root,
                               bench=bench, t_process=time.perf_counter())
    out = {"seed": seed}
    if ctx.mix["driver"] == "serve_open":
        ses = drv.Session(ctx, seed)
        w = ses.window(ses.schedule(float(ctx.params["rate_per_s"]), seconds), seconds)
        ses.close()
        picks = ses.picks(w)
        t0 = time.perf_counter()
        out["program"] = drv.gap_stats(drv.position_gaps(ses, w, picks, fp8=False))
        out["reference_s"] = time.perf_counter() - t0
        out["program_correct"] = drv.judge(ctx, out["program"], w)[1]
        if control:
            out["control"] = drv.gap_stats(drv.position_gaps(ses, w, picks, fp8=True))
            out["control_correct"] = drv.judge(ctx, out["control"], w)[1]
    else:
        ses = drv.Session(ctx, seed)
        ses.close()
        t0 = time.perf_counter()
        gold = ses.reference()
        out["reference_s"] = time.perf_counter() - t0
        runs = {"program": ses.prog}
        if control:
            runs["control"] = ses.reference(fp8=True)
        if faults:
            runs["half_batch"] = ses.reference(half=True)
        for name, got in runs.items():
            cmp = drv.compare(got, gold)
            out[name] = _three(cmp)
            out[f"{name}_correct"] = drv.judge(ctx, cmp)[1]
    return out


def _three(cmp):
    return {k: cmp[k] for k in ("loss_gap", "grad_norm_gap", "change_norm_gap")}


if __name__ == "__main__":
    sys.exit(main())
