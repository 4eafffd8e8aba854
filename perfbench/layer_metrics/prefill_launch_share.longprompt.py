"""The share of the prefills' wall time in the window up to the profiled
stretch that the host spends enqueueing the forward: 100 × Σ
``launch_s`` / Σ wall over the ``prefill`` spans that lie in the window
(``launch_s``: the wall of the span's ``prefill.launch`` child, the
prompt's upload and the model's prefill enqueued; the rest is chiefly
``prefill.wait``, the read of the logits)."""


def read(rec):
    w0, w1 = rec.quiet or rec.window
    spans = [(b - a, args["launch_s"]) for n, a, b, args in rec.spans
             if n == "prefill" and w0 <= a and b < w1 and "launch_s" in args]
    wall = sum(w for w, _ in spans)
    return sum(s for _, s in spans) / wall * 100 if wall > 0 else None
