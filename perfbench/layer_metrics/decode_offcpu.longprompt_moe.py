"""``decode_offcpu.longprompt``, read in the cells that report no
``itl_p50_ms`` (deepseek_moe_16b.longprompt), where it moves
``output_tokens_per_s`` by moving the knee."""

from pathlib import Path

from perfbench import harness

read = harness.load_module(Path(__file__).with_name("decode_offcpu.longprompt.py"),
                           "decode_offcpu_longprompt").read
