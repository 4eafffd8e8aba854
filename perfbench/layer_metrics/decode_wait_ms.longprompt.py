"""Mean wall time a decode step's host spends blocked on the device in
the window up to the profiled stretch: the ``wait_s`` argument of each
``decode_step`` span (the wall of its ``decode.wait`` child, the read of
the sampled tokens: the step's own device work still queued, and any
prefill work queued ahead of it on the shared stream), over their
count."""


def read(rec):
    w0, w1 = rec.quiet or rec.window
    d = [args["wait_s"] for n, a, b, args in rec.spans
         if n == "decode_step" and w0 <= a and b < w1 and "wait_s" in args]
    return sum(d) / len(d) * 1e3 if d else None
