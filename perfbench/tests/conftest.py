"""Fixtures of the benchmark's tests: a small checkout of the benchmark
on the CPU (the smoke sizes of the two configurations, a tiny open loop
and a tiny training mix), and the ``chip`` marker for tests that need a
CUDA card (they skip here)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "perfbench"
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_SIZES = {
    "starcoder2_3b": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                      "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                      "vocab_size": 512},
    "deepseek_moe_16b": {"hidden_size": 64, "intermediate_size": 128,
                         "moe_intermediate_size": 32, "num_hidden_layers": 3,
                         "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
                         "n_routed_experts": 8, "num_experts_per_tok": 2, "vocab_size": 512},
}
# each tiny serving cell compares the number its full-size cell compares
SERVE_LIMITS = {"sc": {"logit_gap_max": 0.05}, "ds": {"logit_gap_mean": 0.01}}
TRAIN_LIMITS = {"grad_norm_gap": 1e-2, "change_norm_gap": 5e-2}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_checkout(tmp: Path) -> Path:
    """A checkout holding BENCHMARK.json and a perfbench/ folder whose
    code is this one's and whose data is small: cells ``sc.tiny``,
    ``ds.tiny`` and ``sc.tinytrain`` (the training driver, whose cell
    waits under PERF.md's Open questions, with ``train_tokens_per_s``)."""
    pb = tmp / "perfbench"
    for d in ("gen", "drivers", "layer_metrics"):
        shutil.copytree(BENCH / d, pb / d, ignore=shutil.ignore_patterns("__pycache__"))
    for short, name in (("sc", "starcoder2_3b"), ("ds", "deepseek_moe_16b")):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        cfg.update(SMOKE_SIZES[name])
        cfg["port"]["smoke"] = True
        cfg["serving"] = {"max_batch": 4, "cache_len": 256, "page_size": 16}
        write(pb / "configs" / f"{short}.json", cfg)
        write(pb / "cells" / f"{short}.tiny.json",
              {"rate_per_s": 6.0, "limits": SERVE_LIMITS[short]})
    mix = json.loads((BENCH / "mixes" / "longprompt.json").read_text())
    mix.update({"prompt_tokens": {"dist": "log_uniform", "min": 17, "max": 120},
                "output_tokens": {"dist": "uniform", "min": 3, "max": 6}, "lead_s": 0.5,
                "check": {"requests": 3, "with_longest": True}})
    write(pb / "mixes" / "tiny.json", mix)
    train = json.loads((BENCH / "mixes" / "train16k.json").read_text())
    train.update({"rows_per_step": 4, "seq_len": 32, "microbatches": 2})
    write(pb / "mixes" / "tinytrain.json", train)
    write(pb / "cells" / "sc.tinytrain.json", {"limits": TRAIN_LIMITS})
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rename = {"starcoder2_3b.longprompt": "sc.tiny", "deepseek_moe_16b.longprompt": "ds.tiny"}
    bench["configs"] = [{**c, "name": {"starcoder2_3b": "sc", "deepseek_moe_16b": "ds"}[c["name"]],
                         "file": c["file"]} for c in bench["configs"]]
    bench["workloads"] = [{**w, "name": rename[w["name"]],
                           "config": {"starcoder2_3b": "sc", "deepseek_moe_16b": "ds"}[w["config"]],
                           "traffic": {"longprompt": "tiny", "train16k": "tinytrain"}[w["traffic"]]}
                          for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    bench["workloads"].append({"name": "sc.tinytrain", "config": "sc", "traffic": "tinytrain",
                               "chips": 1, "why": "the training driver at a tiny size"})
    bench["end_to_end"].append({"name": "train_tokens_per_s", "unit": "tokens/s",
                                "better": "higher", "bound": 0.06, "source": "host_clock",
                                "workloads": ["sc.tinytrain"]})
    write(tmp / "BENCHMARK.json", bench)
    return tmp


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))


def run_cell(checkout: Path, cell: str, seed: int = 2 ** 31 + 7, seconds: float = 1.5,
             trace: bool = False, fault=None):
    from perfbench import harness

    bench = harness.load_json(checkout / "BENCHMARK.json")
    return harness.run(cell, seed, seconds, trace, device="cpu", root=checkout / "perfbench",
                       bench=bench, fault=fault)
