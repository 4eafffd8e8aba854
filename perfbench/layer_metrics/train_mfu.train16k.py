"""Model FLOPs of the training steps completed in the window (forward
and backward, causal attention counted, nothing recomputed:
``work.train_step_flops``) over the window times the bf16 peak."""

from perfbench import work


def read(rec):
    w0, w1 = rec.window
    if not rec.steps or w1 <= w0:
        return None
    flops = rec.steps * work.train_step_flops(rec.shape, rec.rows, rec.seq)
    return flops / ((w1 - w0) * rec.peaks["bf16_flops"]) * 100
