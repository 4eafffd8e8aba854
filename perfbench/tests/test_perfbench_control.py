"""The control, at a size a test run holds: the reference put in the
program's place in the precision below the configuration's (fp8 for
bf16) fails the cell's own checks (the driver's ``judge``, with the
number and the limit that the cell's file names), where the program
passes them.  At full size it runs on the card (``control.py``), and its
readings set the limits (PERF.md)."""

import pytest

from perfbench import control, harness
from perfbench.tests.conftest import SERVE_LIMITS


@pytest.mark.parametrize("cell", ["sc.tiny", "ds.tiny"])
def test_serving_control_fails_the_cells_checks(checkout, cell):
    bench = harness.load_json(checkout / "BENCHMARK.json")
    r = control.readings(cell, 17, 1.5, True, False, "cpu", checkout / "perfbench", bench)
    assert r["program_correct"] and not r["control_correct"]
    (number, limit), = SERVE_LIMITS[cell.split(".")[0]].items()
    assert r["program"][number] <= limit < r["control"][number]


def test_training_control_and_fault_fail_the_cells_checks(checkout):
    bench = harness.load_json(checkout / "BENCHMARK.json")
    r = control.readings("sc.tinytrain", 17, 1.0, True, True, "cpu", checkout / "perfbench",
                         bench)
    assert r["program_correct"]
    assert not r["control_correct"] and not r["half_batch_correct"]


def test_sweep_prints_each_window_and_the_knee(checkout):
    """``sweep.py`` serves ``--repeats`` windows a rate on one engine and
    names the knee last (None where a window already shows a backlog)."""
    import json
    import subprocess
    import sys

    from perfbench.tests.conftest import REPO

    out = subprocess.run([sys.executable, "perfbench/sweep.py", "--workload", "sc.tiny",
                          "--rates", "2,3", "--seconds", "1.5", "--repeats", "2", "--seed", "5",
                          "--device", "cpu", "--checkout", str(checkout)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x["rate_per_s"] for x in lines[:-1]] == [2.0, 2.0, 3.0, 3.0]
    assert all({"tokens_over_offered", "ttft_trend", "in_flight_max"} <= set(x) for x in lines[:-1])
    assert set(lines[-1]) == {"knee_per_s"} and lines[-1]["knee_per_s"] in (None, 2.0, 3.0)
