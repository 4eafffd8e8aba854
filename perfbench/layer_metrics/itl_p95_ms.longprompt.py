"""The 95th percentile over every gap between consecutive tokens of a
request whose later token arrived in the traced run's window up to the
profiled stretch (the program's spans on, the profiler not yet).
Recorded for the trend, since no bound the check allows holds it
untraced (PERF.md)."""

from perfbench import stats


def read(rec):
    w0, w1 = rec.quiet or rec.window
    gaps = [(b - a) * 1e3 for _, ts in rec.requests for a, b in zip(ts, ts[1:]) if w0 <= b < w1]
    return stats.percentile(gaps, 95) if gaps else None
