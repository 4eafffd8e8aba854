"""Run one cell of the benchmark on this machine's card(s):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``; ``checks`` last: each compared number
beside its limit, also the last lines of standard error).  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.

It exits non-zero and prints no result where CUDA is missing or the
machine has fewer cards than the cell asks for, where the port is not
in the checkout, and where the JAX package or JAX was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # caches at fixed places inside the checkout, set before torch loads
    cache = CHECKOUT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

    from perfbench import harness

    bench = harness.load_benchmark(CHECKOUT / "BENCHMARK.json")
    entry = harness.cell_entry(bench, args.workload)
    mix = harness.load_json(harness.ROOT / "mixes" / f"{entry['traffic']}.json")
    drv = harness.load_module(harness.ROOT / "drivers" / f"{mix['driver']}.py", "env")
    for k, v in getattr(drv, "ENV", {}).items():
        os.environ.setdefault(k, v)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not (CHECKOUT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", chips=entry["chips"], t_process=T_PROCESS,
                         bench=bench)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"the run loaded JAX or the JAX package: {foreign}", file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
