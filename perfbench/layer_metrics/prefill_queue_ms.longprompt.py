"""The median wait of a request before its prefill starts, over the
``prefill`` spans that start in the window up to the profiled stretch:
their ``queue_s`` argument (the prefill's start less the request's
``submit``: the engine's queue and the prefill pool's), in ms."""

from perfbench import stats


def read(rec):
    w0, w1 = rec.quiet or rec.window
    q = [args["queue_s"] * 1e3 for n, a, _, args in rec.spans
         if n == "prefill" and w0 <= a < w1 and "queue_s" in args]
    return stats.percentile(q, 50) if q else None
