"""The 95th percentile of the time to first token over the requests due
in the traced run's window up to the profiled stretch, from the due time
(as ``drivers/serve_open.py`` reads ``ttft_p95_ms`` untraced): the program's spans
are on, the profiler not yet.  Recorded for the trend, since no bound
the check allows holds it untraced (PERF.md)."""

import math

from perfbench import stats


def read(rec):
    w0, w1 = rec.quiet or rec.window
    due = [(d, ts) for d, ts in rec.requests if w0 <= d < w1]
    if not due:
        return None
    v = stats.percentile([(ts[0] - d) * 1e3 if ts else math.inf for d, ts in due], 95)
    return None if math.isinf(v) else v
