"""The harness finds a cell's configuration, mix, per-layer metrics and
driver by name, takes a new cell made of new files alone, and refuses a
configuration whose widths disagree with the port's."""

import json
import re
import shutil

import pytest

from perfbench import harness
from perfbench.tests.conftest import BENCH, REPO, SERVE_LIMITS, run_cell, write

BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_resolves_to_its_files():
    for w in BENCHMARK["workloads"]:
        assert (BENCH / "configs" / f"{w['config']}.json").is_file()
        mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "gen" / f"{mix['kind']}.py").is_file()
        assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
        assert "limits" in json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
    for m in BENCHMARK["per_layer"]:
        assert callable(harness.load_module(BENCH / "layer_metrics" / f"{m['name']}.py",
                                            "t_reader").read)


def test_benchmark_json_keeps_the_contract_shape():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in harness.metrics_for(b, w, "end_to_end")}
    for w in b["workloads"]:
        assert len(harness.metrics_for(b, w["name"], "end_to_end")) >= 2
        assert harness.metrics_for(b, w["name"], "per_layer")


@pytest.mark.parametrize("name", ["starcoder2_3b", "deepseek_moe_16b"])
def test_configurations_match_the_port_at_full_width(name):
    config, shape = harness.load_config(BENCH, name)
    cfg = harness.port_config(config)
    assert cfg.d_model == shape["d_model"] and cfg.num_layers == shape["num_layers"]


def test_a_config_whose_widths_disagree_is_refused(tmp_path):
    config = json.loads((BENCH / "configs" / "starcoder2_3b.json").read_text())
    config["intermediate_size"] = 8192
    write(tmp_path / "configs" / "bad.json", config)
    config, _ = harness.load_config(tmp_path, "bad")
    with pytest.raises(ValueError, match="d_ff"):
        harness.port_config(config)


def test_metrics_are_chosen_by_cell(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    pl = {m["name"] for m in harness.metrics_for(bench, "sc.tinytrain", "per_layer")}
    assert pl == set()
    e2e = {m["name"] for m in harness.metrics_for(bench, "sc.tinytrain", "end_to_end")}
    assert e2e == {"train_tokens_per_s", "setup_s"}
    e2e = {m["name"] for m in harness.metrics_for(BENCHMARK, "deepseek_moe_16b.longprompt",
                                                  "end_to_end")}
    assert e2e == {"output_tokens_per_s", "setup_s"}
    e2e = {m["name"] for m in harness.metrics_for(BENCHMARK, "starcoder2_3b.longprompt",
                                                  "end_to_end")}
    assert e2e == {"itl_p50_ms", "output_tokens_per_s", "setup_s"}
    for cell, own in (("starcoder2_3b.longprompt", ".longprompt"),
                      ("deepseek_moe_16b.longprompt", ".longprompt_moe")):
        pl = {m["name"] for m in harness.metrics_for(BENCHMARK, cell, "per_layer")}
        assert "flash_fwd_roofline.longprompt" in pl and len(pl) == 8
        assert "decode_step_ms" + own in pl


def test_a_new_cell_is_new_files_and_an_entry(checkout, tmp_path):
    """A configuration, a mix, a per-layer metric and a cell, added as
    files and BENCHMARK.json entries, run with no file of the benchmark
    changed."""
    co = tmp_path / "co"
    shutil.copytree(checkout, co)
    pb = co / "perfbench"
    cfg = json.loads((pb / "configs" / "sc.json").read_text())
    write(pb / "configs" / "sc_wide.json", cfg)
    mix = json.loads((pb / "mixes" / "tiny.json").read_text())
    mix["output_tokens"] = {"dist": "uniform", "min": 2, "max": 3}
    write(pb / "mixes" / "short.json", mix)
    write(pb / "cells" / "sc_wide.short.json", {"rate_per_s": 4.0,
                                                "limits": {"logit_gap_max": 0.05}})
    (pb / "layer_metrics" / "requests_seen.short.py").write_text(
        "def read(rec):\n    return float(len([s for s in rec.spans if s[0] == 'prefill']))\n")
    bench = json.loads((co / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "sc_wide"})
    bench["workloads"].append({"name": "sc_wide.short", "config": "sc_wide", "traffic": "short",
                               "chips": 1, "why": "a cell of new files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "sc.tiny" in m["workloads"]:
            m["workloads"].append("sc_wide.short")
    bench["per_layer"].append({"name": "requests_seen.short", "unit": "count",
                               "better": "higher", "source": "program_span",
                               "layer": "serve/engine.py", "moves": "output_tokens_per_s",
                               "workloads": ["sc_wide.short"]})
    write(co / "BENCHMARK.json", bench)
    r = run_cell(co, "sc_wide.short", trace=True)
    assert r["correct"] and r["metrics"]["requests_seen.short"]["value"] > 0
    assert r["metrics"]["itl_p95_ms.longprompt"]["value"] > 0
    r = run_cell(co, "sc_wide.short")
    assert r["correct"] and set(r["metrics"]) == {"itl_p50_ms", "output_tokens_per_s",
                                                  "setup_s"}


def test_result_line_shape(checkout):
    r = run_cell(checkout, "ds.tiny")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["logit_gap_mean"]["limit"] == SERVE_LIMITS["ds"]["logit_gap_mean"]
    assert r["notes"] == [f"in_flight_max {r['notes'][0].split()[1]}", "decode capacity C 8"]
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_a_traced_run_reads_its_cells_own_twin(checkout):
    r = run_cell(checkout, "ds.tiny", trace=True)
    assert r["correct"] and r["metrics"]["decode_step_ms.longprompt_moe"]["value"] > 0
    assert "decode_step_ms.longprompt" not in r["metrics"]
