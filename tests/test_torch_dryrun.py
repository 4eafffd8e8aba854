"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: the shape
cells equal the reference's, and ``run_cell`` traces a train and a decode
cell of a smoke config of each family on the 16×16 production mesh of a
fake 256-rank process group (``--device cpu``), giving records with every
field of the reference's.  Per-rank argument bytes equal the shard sizes
of the reference plan's ``PartitionSpec``s; a multipod train cell puts
bytes on the cross-pod links; a decode step costs far less than a train
step; and the kernel ops run once a layer."""
import math
import types
from dataclasses import replace

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun

FAMILIES = ("starcoder2_3b", "deepseek_moe_16b", "internvl2_2b", "mamba2_780m",
            "recurrentgemma_2b", "whisper_small")
REF_FIELDS = ("arch", "shape", "mesh", "plan", "n_devices", "kind", "seq_len",
              "global_batch", "param_bytes_fp32", "lower_s", "compile_s", "memory",
              "hlo_flops_per_device", "hlo_flops_total", "hbm_traffic_per_device",
              "cost_analysis_raw", "collectives", "hlo_bytes")
COLL_FIELDS = ("count", "wire_bytes_total", "wire_bytes_ici", "wire_bytes_dci",
               "operand_bytes_total", "by_kind")


def test_shape_cells_equal_reference():
    from repro import configs as R

    from repro_torch import configs as T

    assert {k: tuple(vars(v).values()) for k, v in T.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in R.SHAPES.items()}
    for arch in T.ARCH_IDS:
        assert T.cells_for(T.get_config(arch)) == R.cells_for(R.get_config(arch))
    assert T.all_cells() == R.all_cells()


@pytest.fixture(scope="module")
def records():
    out = {}
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True)
        for shape in ("train_4k", "decode_32k"):
            out[arch, shape, "pod"] = dryrun.run_cell(arch, shape, "pod", device="cpu",
                                                      cfg=cfg, save=False)
    out["starcoder2_3b", "train_4k", "multipod"] = dryrun.run_cell(
        "starcoder2_3b", "train_4k", "multipod", device="cpu",
        cfg=get_config("starcoder2_3b", smoke=True), save=False)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_records_carry_every_reference_field(records, arch, shape):
    rec = records[arch, shape, "pod"]
    assert set(REF_FIELDS) <= set(rec) and set(COLL_FIELDS) <= set(rec["collectives"])
    assert rec["n_devices"] == 256 and rec["kind"] == shape.split("_")[0]
    assert rec["hlo_flops_total"] == rec["hlo_flops_per_device"] * 256
    assert rec["hlo_flops_per_device"] > 0 and rec["hbm_traffic_per_device"] > 0
    assert rec["memory"]["peak_size_in_bytes"] >= rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["count"] > 0 and rec["collectives"]["wire_bytes_dci"] == 0


def _ref_local_bytes(axes, shape, itemsize, sizes):
    """Bytes of one rank's shard under the reference plan's PartitionSpec."""
    from repro.dist.plan import get_plan

    spec = get_plan("futurized").spec(axes, shape, types.SimpleNamespace(shape=sizes))
    n = math.prod(shape)
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                n //= sizes[ax]
    return n * itemsize


@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_equal_reference_shards(records, arch):
    """fp32 params and their two AdamW moments, the step counter and the
    batch: each at its shard of the reference plan's spec on 16×16."""
    from repro.configs import SHAPES, get_config as ref_config
    from repro.dist.plan import get_plan
    from repro.models.model import build_model

    sizes = {"data": 16, "model": 16}
    ref = build_model(ref_config(arch, smoke=True), get_plan("futurized"))
    want = 4  # the step counter
    for s in ref.param_specs().values():
        want += 3 * _ref_local_bytes(s.axes, s.shape, 4, sizes)
    axes = ref.batch_axes()
    for k, s in ref.batch_specs(SHAPES["train_4k"]).items():
        want += _ref_local_bytes(axes[k], s.shape, s.dtype.itemsize, sizes)
    assert records[arch, "train_4k", "pod"]["memory"]["argument_size_in_bytes"] == want


def test_multipod_train_cell_crosses_pods(records):
    rec = records["starcoder2_3b", "train_4k", "multipod"]
    assert rec["n_devices"] == 512
    assert rec["collectives"]["wire_bytes_dci"] > 0
    assert rec["collectives"]["wire_bytes_total"] == (rec["collectives"]["wire_bytes_ici"]
                                                       + rec["collectives"]["wire_bytes_dci"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_costs_far_less_than_train(records, arch):
    train, decode = records[arch, "train_4k", "pod"], records[arch, "decode_32k", "pod"]
    assert decode["hlo_flops_per_device"] < train["hlo_flops_per_device"] / 50


@pytest.mark.parametrize("arch", FAMILIES)
def test_kernel_ops_run_once_a_layer(records, arch):
    """Train: one forward kernel a layer (flash, the SSD or the RG-LRU
    scan; the RG-LRU's backward is its kernel once more, reversed);
    decode: one decode kernel per attention layer (two for the enc-dec
    decoder: self and cross), none in the SSM's recurrent step."""
    cfg = get_config(arch, smoke=True)
    train = records[arch, "train_4k", "pod"]["kernel_calls"]
    decode = records[arch, "decode_32k", "pod"]["kernel_calls"]
    if cfg.family == "ssm":
        assert train == {"ssd_scan": cfg.num_layers} and decode == {}
    elif cfg.family == "hybrid":
        attn = cfg.num_layers // 3
        assert train == {"rglru_scan": 2 * (cfg.num_layers - attn), "flash_attention": attn}
        assert decode == {"decode_attention": attn}
    elif cfg.family == "encdec":
        assert train == {"flash_attention": cfg.enc_layers + cfg.dec_layers}
        assert decode == {"decode_attention": 2 * cfg.dec_layers}
    else:
        assert train == {"flash_attention": cfg.num_layers}
        assert decode == {"decode_attention": cfg.num_layers}


def test_saved_record_and_trace(tmp_path):
    """``save`` writes the record and its gzipped op trace; a second call
    reads the record back instead of tracing again."""
    cfg = replace(get_config("starcoder2_3b", smoke=True), num_layers=1)
    rec = dryrun.run_cell("starcoder2_3b", "decode_32k", "pod", device="cpu", cfg=cfg,
                          out_dir=tmp_path)
    path = tmp_path / "starcoder2_3b__decode_32k__pod__futurized.json"
    assert path.exists() and dryrun.trace_path(path).exists()
    again = dryrun.run_cell("starcoder2_3b", "decode_32k", "pod", device="cpu", cfg=cfg,
                            out_dir=tmp_path)
    rec.pop("_trace")
    assert again == rec
