"""Mean wall time of a decode step's enqueue in the window up to the
profiled stretch: the ``launch_s`` argument of each ``decode_step`` span
(the wall of its ``decode.launch`` child: the forward and the sampling
enqueued by the host), over their count.  A CUDA graph of the step would
take this part away; a wait for the interpreter's lock inside the
enqueue counts here too (``decode_offcpu`` says how much)."""


def read(rec):
    w0, w1 = rec.quiet or rec.window
    d = [args["launch_s"] for n, a, b, args in rec.spans
         if n == "decode_step" and w0 <= a and b < w1 and "launch_s" in args]
    return sum(d) / len(d) * 1e3 if d else None
