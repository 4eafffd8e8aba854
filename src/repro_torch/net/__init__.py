"""repro_torch.net — the port's multi-locality runtime: localities as OS
processes, ported from the reference's ``repro.net``.

The subsystem that makes "locality" mean what the paper means (§2.2–2.3):
a separate runtime instance reached only through parcels.

    bootstrap(n)            spawn n-1 worker runtimes; caller = AGAS root
    running(n)              context-managed bootstrap (leak-proof teardown)
    apply_remote(a, gid)    one-sided invoke where the object lives
    run_on(loc, fn, ...)    invoke against a locality's runtime itself
    migrate_remote(gid, L)  move an object; GID stays valid (gen bump)
    query_counters(loc, p)  a locality's performance counters, via parcel
    fetch(gid)              host snapshot of a (remote) object's state
    current() / require()   the process's NetRuntime, if bootstrapped

Layering: :mod:`repro_torch.net.parcelport` moves zero-copy frames,
:mod:`repro_torch.net.locality` runs the per-process endpoint + bootstrap,
:mod:`repro_torch.net.remote` adds the distributed AGAS tier on top, and
:mod:`repro_torch.net.httpd` is the HTTP listener the metrics exporter
serves ``/metrics`` through.  This package is the *only* place in the port
that opens sockets or starts processes (``tests/test_torch_guard.py``).
"""

from repro_torch.net import httpd
from repro_torch.net.locality import (
    ROOT,
    Locality,
    NetRuntime,
    UnknownGid,
    bootstrap,
    current,
    require,
    running,
)
from repro_torch.net.parcelport import NetConfig, PortClosed
from repro_torch.net.remote import (
    apply_remote,
    describe,
    fetch,
    migrate_remote,
    owner_of,
    query_counter_export,
    query_counter_stats,
    query_counters,
    run_on,
)

__all__ = [
    "ROOT", "Locality", "NetConfig", "NetRuntime", "UnknownGid", "PortClosed",
    "bootstrap", "current", "require", "running", "httpd",
    "apply_remote", "describe", "fetch", "migrate_remote", "owner_of",
    "query_counter_export", "query_counter_stats", "query_counters", "run_on",
]
