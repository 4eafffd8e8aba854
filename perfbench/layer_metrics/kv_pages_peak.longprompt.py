"""The highest share of the paged cache's pages in use in the window up
to the profiled stretch: ``/serve{engine#0}/pages/in_use`` over
``pages/capacity``, sampled every 5 ms."""


def read(rec):
    w0, w1 = rec.quiet or rec.window
    used = rec.gauges.get("/serve{engine#0}/pages/in_use", [])
    cap = dict(rec.gauges.get("/serve{engine#0}/pages/capacity", []))
    shares = [v / cap[t] for t, v in used if w0 <= t < w1 and cap.get(t)]
    return max(shares) * 100 if shares else None
