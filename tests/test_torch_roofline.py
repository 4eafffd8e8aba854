"""The port's roofline (``repro_torch.analysis.roofline``) and re-analysis
(``reanalyze``): active parameter counts of all ten full configs equal the
reference's (param specs only, nothing allocated); ``analyze`` with the
reference's v5e constants patched in equals the reference's ``analyze`` on
the same record; and a record is restored from its saved op trace."""
import dataclasses
import json
from dataclasses import replace

import pytest

from repro_torch.analysis import reanalyze as RA
from repro_torch.analysis import roofline as RL
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_param_count_equals_reference(arch):
    from repro.analysis import roofline as R

    assert RL.active_param_count(arch) == R.active_param_count(arch)


def _record(**over):
    rec = {"arch": "deepseek_moe_16b", "shape": "train_4k", "mesh": "multipod",
           "plan": "futurized", "n_devices": 512, "kind": "train", "seq_len": 4096,
           "global_batch": 256, "hlo_flops_total": 3.1e18, "hbm_traffic_per_device": 7.5e12,
           "collectives": {"wire_bytes_ici": 9.0e11, "wire_bytes_dci": 2.0e11}}
    rec.update(over)
    return rec


@pytest.mark.parametrize("over", [
    {}, {"kind": "prefill", "shape": "prefill_32k", "seq_len": 32768, "global_batch": 32},
    {"kind": "decode", "shape": "decode_32k", "arch": "starcoder2_3b", "n_devices": 256,
     "mesh": "pod", "hlo_flops_total": 2.0e13, "collectives": {"wire_bytes_ici": 4.0e10,
                                                              "wire_bytes_dci": 0}},
    {"hlo_flops_total": 0.0}])
def test_analyze_with_v5e_constants_equals_reference(monkeypatch, over):
    from repro.analysis import roofline as R
    from repro.launch import mesh as rmesh

    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "DCI_BW"):
        monkeypatch.setattr(mesh_mod, name, getattr(rmesh, name))
    rec = _record(**over)
    assert dataclasses.asdict(RL.analyze(rec)) == dataclasses.asdict(R.analyze(rec))


def test_h100_constants():
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW, mesh_mod.POD_SIZE) == (989e12, 3.35e12, 256)
    assert (mesh_mod.ICI_BW, mesh_mod.DCI_BW) == (50e9, 25e9)


def test_reanalyze_restores_a_record_from_its_trace(tmp_path):
    cfg = replace(get_config("mamba2_780m", smoke=True), num_layers=1)
    dryrun.run_cell("mamba2_780m", "train_4k", "pod", device="cpu", cfg=cfg, out_dir=tmp_path)
    path = tmp_path / "mamba2_780m__train_4k__pod__futurized.json"
    good = json.loads(path.read_text())
    bad = dict(good, hlo_flops_per_device=0.0, hlo_flops_total=0.0, hbm_traffic_per_device=0.0,
               collectives={}, kernel_calls={})
    path.write_text(json.dumps(bad))
    assert RA.reanalyze(tmp_path) == 1
    assert json.loads(path.read_text()) == good
    row = RL.table(tmp_path, mesh="pod")[0]
    assert row.bottleneck in ("compute", "memory", "collective") and row.step_s > 0
    assert "mamba2_780m" in RL.format_table([row])


@pytest.mark.parametrize("argv", [["--cells", "{d}"], ["multipod", "{d}"]])
def test_main_reads_the_directory_it_is_given(tmp_path, capsys, argv):
    """``--cells DIR`` and ``[MESH] [DIR]`` both read DIR (``--cells DIR``
    once read the default ``results/dryrun_torch/``)."""
    rec = _record(memory={"peak_size_in_bytes": 123.4e9})
    (tmp_path / "deepseek_moe_16b__train_4k__multipod__futurized.json").write_text(
        json.dumps(rec))
    RL.main([a.format(d=tmp_path) for a in argv])
    out = capsys.readouterr().out
    if argv[0] == "--cells":
        row = next(line for line in out.splitlines() if line.startswith("| deepseek_moe_16b"))
        assert row.startswith("| deepseek_moe_16b | ? / 123.4 ✗; ? / compute ")
    else:
        assert "deepseek_moe_16b       train_4k       512 " in out
