"""The traffic generators repeat exactly by seed, and every seed gets the
same set of sizes and arrivals in another order."""

import json

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.conftest import BENCH

GEN = harness.load_module(BENCH / "gen" / "poisson_open.py", "t_poisson")
ROWS = harness.load_module(BENCH / "gen" / "seeded_rows.py", "t_rows")
MIX = json.loads((BENCH / "mixes" / "longprompt.json").read_text())
TRAIN = json.loads((BENCH / "mixes" / "train16k.json").read_text())
SEEDS = [0, 1, 2 ** 31 + 12345, 2 ** 33 + 5]


def _flat(sched):
    return [(r["due"], r["out_tokens"], r["in_window"], r["prompt"].tolist()) for r in sched]


@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_repeats_by_seed(seed):
    a = GEN.schedule(MIX, {"rate_per_s": 2.8}, seed, 10.0, 49152)
    b = GEN.schedule(MIX, {"rate_per_s": 2.8}, seed, 10.0, 49152)
    assert _flat(a) == _flat(b)


def test_every_seed_gets_the_same_schedule_and_other_ids():
    a = GEN.schedule(MIX, {"rate_per_s": 2.8}, 11, 51.0, 49152)
    b = GEN.schedule(MIX, {"rate_per_s": 2.8}, 12, 51.0, 49152)
    assert [(r["due"], len(r["prompt"]), r["out_tokens"]) for r in a] == \
        [(r["due"], len(r["prompt"]), r["out_tokens"]) for r in b]
    assert all((r["prompt"] != q["prompt"]).any() for r, q in zip(a, b))
    assert sum(r["in_window"] for r in a) == 143


def test_the_order_is_the_mixs():
    other = {**MIX, "order_seed": MIX["order_seed"] + 1}
    a = GEN.schedule(MIX, {"rate_per_s": 2.8}, 11, 51.0, 49152)
    b = GEN.schedule(other, {"rate_per_s": 2.8}, 11, 51.0, 49152)
    assert sorted(len(r["prompt"]) for r in a) == sorted(len(r["prompt"]) for r in b)
    assert [len(r["prompt"]) for r in a] != [len(r["prompt"]) for r in b]
    assert [r["due"] for r in a] != [r["due"] for r in b]


def test_schedule_follows_the_mix():
    s = GEN.schedule(MIX, {"rate_per_s": 2.8}, 3, 40.0, 49152)
    lens = np.array([len(r["prompt"]) for r in s])
    outs = np.array([r["out_tokens"] for r in s])
    assert lens.min() >= 1025 and lens.max() <= 3968
    assert outs.min() >= 8 and outs.max() <= 48
    assert all(r["prompt"].min() >= 1 and r["prompt"].max() < 49152 for r in s)
    due = [r["due"] for r in s]
    assert due == sorted(due) and due[0] == -MIX["lead_s"]
    assert all(0 <= d < 40 for d, r in zip(due, s) if r["in_window"])
    # log-uniform: about half the prompts below the geometric middle
    assert abs(np.mean(lens < np.sqrt(1025 * 3968)) - 0.5) < 0.05


def test_warmup_covers_the_buckets():
    lens = sorted(len(p) for p in GEN.warmup(MIX, 5, 49152))
    assert lens[0] == 1025 and lens[-1] == 3968 and 2048 in lens and 2049 in lens


@pytest.mark.parametrize("seed", SEEDS)
def test_rows_repeat_by_seed_and_differ(seed):
    a = ROWS.batch(TRAIN, seed, 3, 49152)["tokens"]
    b = ROWS.batch(TRAIN, seed, 3, 49152)["tokens"]
    assert a.shape == (8, 2049) and bool((a == b).all())
    c = ROWS.batch(TRAIN, seed, 4, 49152)["tokens"]
    rows = {tuple(r.tolist()) for r in a} | {tuple(r.tolist()) for r in c}
    assert len(rows) == 16
