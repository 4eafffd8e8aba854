"""repro_torch.net — the port's network tier.  So far it holds only
:mod:`repro_torch.net.httpd`, the HTTP listener the metrics exporter
serves ``/metrics`` through; the reference's localities, parcelport and
remote AGAS wait for the port's multi-locality runtime.  This package is
the only place in the port that opens a listening socket."""

from repro_torch.net import httpd

__all__ = ["httpd"]
