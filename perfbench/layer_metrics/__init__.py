"""Per-layer metrics, one reader a metric, found by the metric's name:
``read(record) -> float | None`` (None where it finds nothing to read).

The serving cells' bounded metrics are ``output_tokens_per_s``, pinned
to the offered rate below the knee (a layer moves it by moving the knee,
the highest rate the engine sustains, past a cell's rate), and in
starcoder2_3b.longprompt ``itl_p50_ms``, the decode pace.  A quantity
read in cells that report different end-to-end metrics has a reader for
each (``<metric>.longprompt`` and ``<metric>.longprompt_moe``).  The
tails (``ttft_p95_ms``, ``itl_p95_ms``) are read here too, from the
traced run, for the trend (PERF.md says why no bound holds them)."""
