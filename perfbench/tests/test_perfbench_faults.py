"""A whole run with the timed path broken underneath comes out not
correct, once for each fault the cells can have; the same run unbroken
comes out correct.  (No cell spans chips, so none can leave out an
exchange between them.)"""

import math

import pytest

from perfbench.tests.conftest import SERVE_LIMITS, run_cell


def _alter_a_token(engine):
    """The third token of every request is not the one the step chose."""
    emit = engine._emit

    def altered(req, tok):
        emit(req, (tok + 1) % engine.model.cfg.vocab_size if len(req.generated) == 2 else tok)

    engine._emit = altered


def _state_unchanged(trainer):
    """The step computes nothing and returns its state as it was."""
    import torch

    def step(params, opt_state, batch):
        return params, opt_state, {"loss": torch.tensor(math.log(512.0)),
                                   "grad_norm": torch.tensor(0.0)}

    trainer._step_fn = step


def _half_batch(trainer):
    """Each step sees the first half of its rows: the mean over the rest."""
    step = trainer._step_fn

    def half(params, opt_state, batch):
        return step(params, opt_state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    trainer._step_fn = half


@pytest.mark.parametrize("cell", ["sc.tiny", "ds.tiny"])
def test_serving_token_altered(checkout, cell):
    assert run_cell(checkout, cell)["correct"]
    r = run_cell(checkout, cell, fault=_alter_a_token)
    (number, limit), = SERVE_LIMITS[cell.split(".")[0]].items()
    assert not r["correct"] and r["checks"][number]["value"] > limit


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_training_fault(checkout, fault):
    r = run_cell(checkout, "sc.tinytrain", seconds=1.0, fault=fault)
    assert not r["correct"]


def test_training_sound(checkout):
    assert run_cell(checkout, "sc.tinytrain", seconds=1.0)["correct"]
