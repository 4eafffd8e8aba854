"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the reference loads nothing of the program."""

import subprocess
import sys
import textwrap

from perfbench import harness
from perfbench.tests.conftest import REPO


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{REPO}:{REPO / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_foreign_names_are_compared_whole():
    assert "repro_torch" not in harness.FOREIGN
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    assert "repro_torch_lookalike_for_test" not in harness.foreign_modules()


def test_a_whole_run_loads_no_jax(tmp_path):
    from perfbench.tests.conftest import make_checkout

    co = make_checkout(tmp_path)
    mods = _modules(f"""
        import sys
        from pathlib import Path
        from perfbench import harness
        co = Path({str(co)!r})
        for cell in ("sc.tiny", "sc.tinytrain"):
            harness.run(cell, 3, 1.0, cell == "sc.tiny", device="cpu", root=co / "perfbench",
                        bench=harness.load_json(co / "BENCHMARK.json"))
        print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("""
        import sys
        import perfbench.reference.transformer, perfbench.reference.train
        import perfbench.work, perfbench.stats, perfbench.weights
        print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
