"""Find a serving cell's knee: the highest rate at which the backlog does
not grow over a window.  One engine (one seed's weights) serves
``--repeats`` windows at each rate in turn, lowest first:

    python3 perfbench/sweep.py --workload <cell> --rates 1,2,3 --seconds 40 --repeats 2 --seed <n>

Each window prints a JSON line: its end-to-end metrics, the tokens
received over those offered, and the TTFT trend (median of the last
third of the requests due over the first third's).  A window whose
tokens fall short of ``MIN_SHARE`` of those offered, or whose TTFT trend
reaches ``MAX_TREND``, shows a growing backlog; the knee, printed last,
is the highest rate below which no window shows one.  The benchmark's
runs never call this; a benchmark change that finds a knee again does.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
MIN_SHARE, MAX_TREND = 0.9, 1.5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkout", default=str(CHECKOUT),
                    help="where BENCHMARK.json and its perfbench/ folder are")
    args = ap.parse_args()
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    from perfbench import harness

    bench = harness.load_benchmark(Path(args.checkout) / "BENCHMARK.json")
    ctx, drv = harness.context(args.workload, args.seed, args.seconds, False, device=args.device,
                               root=Path(args.checkout) / "perfbench", bench=bench,
                               t_process=time.perf_counter())
    ses = drv.Session(ctx, args.seed)
    mean_out = statistics.mean((ctx.mix["output_tokens"]["min"], ctx.mix["output_tokens"]["max"]))
    knee, past = None, False
    for rate in (float(r) for r in args.rates.split(",")):
        for _ in range(args.repeats):
            w = ses.window(ses.schedule(rate, args.seconds), args.seconds)
            metrics, n = drv.window_metrics(w, args.seconds)
            ttft = n["ttft"]
            third = max(len(ttft) // 3, 1)
            trend = statistics.median(ttft[-third:]) / statistics.median(ttft[:third])
            share = n["tokens"] / (rate * mean_out * args.seconds)
            past = past or share < MIN_SHARE or trend >= MAX_TREND
            print(json.dumps({"rate_per_s": rate, **metrics, "due": n["due"],
                              "unanswered": n["unanswered"], "in_flight_max": n["in_flight_max"],
                              "tokens_over_offered": share, "ttft_trend": trend}), flush=True)
        if not past:
            knee = rate
    print(json.dumps({"knee_per_s": knee}), flush=True)
    ses.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
