"""repro_torch.obs — observability, ported from the reference's
``repro.obs``.

**Recording** — :mod:`trace` (the per-thread ring-buffer span recorder),
:mod:`export` (the merged Chrome trace), :mod:`sampler` (counter time
series and the ``--print-counters`` report).

**Export** — :mod:`metrics` (OpenMetrics text of the counter tree, served
through :mod:`repro_torch.net.httpd`), :mod:`timeseries` (JSONL counter
timelines bounded by stride-doubling downsample), :mod:`top` (the
``python -m repro_torch.obs.top`` live fleet dashboard).

**Analysis** — :mod:`critical_path` (per-request paths tiled into the
SLOW classes), :mod:`attribution` (per-tier reports, folded into
histogram counters), :mod:`recorder` (the anomaly flight recorder),
:mod:`analyze` (the ``python -m repro_torch.obs.analyze`` CLI).

Given a ``net`` (:mod:`repro_torch.net`), each module reaches every
locality over the parcelport, as the reference's does; without one it runs
on this process alone.  Only
:mod:`trace` is imported eagerly: the core runtime instruments it, so
this package loads everything else on first attribute access.
"""

from repro_torch.obs import trace  # noqa: F401 — the leaf recorder

__all__ = ["trace", "export", "sampler", "critical_path", "attribution",
           "recorder", "analyze", "metrics", "timeseries", "top"]

_LAZY = ("export", "sampler", "critical_path", "attribution", "recorder",
         "analyze", "metrics", "timeseries", "top")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
