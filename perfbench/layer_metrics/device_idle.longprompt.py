"""The share of the profiled stretch of the serving window in which no
operation runs on the device."""

from perfbench import stats


def read(rec):
    p = rec.profile
    if p is None or p.t1_ns <= p.t0_ns:
        return None
    busy = stats.union_length([(a, b) for _, a, b, _ in p.device], p.t0_ns, p.t1_ns)
    return (1 - busy / (p.t1_ns - p.t0_ns)) * 100
