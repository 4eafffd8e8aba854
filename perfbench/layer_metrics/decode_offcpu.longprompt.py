"""The share of the decode steps' wall time in the window up to the
profiled stretch that the decode thread spent off the CPU: 100 × (1 −
Σ ``cpu_s`` / Σ wall) over the ``decode_step`` spans, ``cpu_s`` being
the thread's CPU time in the span.  Off the CPU, the thread waits to get
the interpreter's lock back (torch releases it around each operator,
and the prefill workers take it); CUDA's default synchronisation spins,
so the read of the tokens counts as CPU time."""


def read(rec):
    w0, w1 = rec.quiet or rec.window
    steps = [(b - a, args["cpu_s"]) for n, a, b, args in rec.spans
             if n == "decode_step" and w0 <= a and b < w1 and "cpu_s" in args]
    wall = sum(w for w, _ in steps)
    return (1 - sum(c for _, c in steps) / wall) * 100 if wall > 0 else None
