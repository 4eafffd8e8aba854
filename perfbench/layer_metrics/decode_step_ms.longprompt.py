"""Mean wall time of the engine's decode step in the window up to the
profiled stretch: the ``decode_step`` spans' durations over their count
(each ends in the host's read of its tokens)."""


def read(rec):
    w0, w1 = rec.quiet or rec.window
    d = [b - a for n, a, b, _ in rec.spans if n == "decode_step" and w0 <= a and b < w1]
    return sum(d) / len(d) * 1e3 if d else None
