"""Model FLOPs of the valid prompt tokens prefilled in the window up to
the profiled stretch (the
benchmark's own count, ``work.prefill_flops``; a mixture of experts
counts the activated experts, never capacity padding) over the union of
the ``prefill`` spans' intervals times the bf16 peak."""

from perfbench import stats, work


def read(rec):
    w0, w1 = rec.quiet or rec.window
    spans = [(a, b, args) for n, a, b, args in rec.spans if n == "prefill" and w0 <= a < w1]
    if not spans:
        return None
    flops = sum(work.prefill_flops(rec.shape, int(args["prompt_len"])) for _, _, args in spans)
    busy = stats.union_length((a, b) for a, b, _ in spans)
    return flops / (busy * rec.peaks["bf16_flops"]) * 100
