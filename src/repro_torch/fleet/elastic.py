"""Elastic fleet membership: grow / retire engine localities at runtime,
ported from the reference's ``fleet/elastic.py``.

``grow_engine`` is the whole join path in one call: spawn a brand-new OS
process into the *running* fleet (:meth:`NetRuntime.spawn_locality` —
HELLO handshake, AGAS-root registration, TOPO broadcast so every peer
accepts routes to the newcomer), build an engine there by the router's
own construction recipe (``router.spec``), and admit it to dispatch under
an SLO tier.  The new capacity starts taking requests on the next
``pick``.

``retire_engine`` is the inverse, drain-first: the engine leaves dispatch
immediately, the drain loop polls its locality's counters until
``submitted - completed`` reaches zero (nothing in flight to strand),
then the locality is BYEd, reaped, purged from the AGAS root and DOWNed
to peers (:meth:`NetRuntime.retire_locality`).  Anything live-migration
should rescue must be migrated *before* calling this — retirement is for
drained capacity, crash recovery is the router failover's job.

Counters::

    /fleet{elastic}/grown     cumulative
    /fleet{elastic}/retired   cumulative
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.serve.router import RemoteEngine, Router, _spawn_engine

__all__ = ["grow_engine", "retire_engine"]

# a fresh serving locality wants the engine's pool layout, not the worker
# default ({"default": 2, "io": 1})
_SERVE_POOLS = {"default": 2, "prefill": 2, "io": 1}


def _c(name: str):
    return _counters.default().counter(f"/fleet{{elastic}}/{name}")


def grow_engine(net, router: Router, tier: Optional[str] = None,
                pools: Optional[Dict[str, int]] = None,
                timeout: float = 600.0) -> RemoteEngine:
    """Spawn locality + engine + router admission, in that order.  Returns
    the new :class:`RemoteEngine` handle (its name is ``engine#<lid>``)."""
    from repro_torch.net import remote as _remote

    spec = router.spec
    if spec is None:
        raise RuntimeError("router has no construction spec "
                           "(grow requires Router.over_localities)")
    lid = net.spawn_locality(pools=dict(pools or _SERVE_POOLS),
                            timeout=min(timeout, 120.0))
    name = f"engine#{lid}"
    key = _remote.run_on(lid, _spawn_engine, spec["arch"], spec["smoke"],
                         {**spec["scfg_kwargs"], "name": name},
                         spec["device"], spec["dtype"]).get(timeout=timeout)
    engine = RemoteEngine(net, lid, _agas.GID(*key), name)
    router.add_engine(engine, tier)
    _c("grown").increment()
    return engine


def retire_engine(net, router: Router, name: str, timeout: float = 120.0,
                  poll: float = 0.05) -> int:
    """Drain-first retirement of a remote engine's whole locality.
    Returns the retired locality id."""
    from repro_torch.net import remote as _remote

    engine = router.engine(name)
    if not isinstance(engine, RemoteEngine):
        raise ValueError(f"{name!r} is not a remote engine; the root "
                         f"locality cannot retire itself")
    tier = router.tier_of(name)
    router.remove_engine(name)  # out of dispatch before the drain starts
    lid = engine.locality
    sub_name = f"/serve{{{name}}}/requests/submitted"
    done_name = f"/serve{{{name}}}/requests/completed"
    deadline = time.monotonic() + timeout
    while True:
        pairs: Dict[str, Any] = dict(_remote.query_counters(
            lid, f"/serve{{{name}}}/requests/*", timeout=30.0))
        inflight = pairs.get(sub_name, 0.0) - pairs.get(done_name, 0.0)
        if inflight <= 0:
            break
        if time.monotonic() > deadline:
            router.add_engine(engine, tier)  # undo: engine is stuck live
            raise TimeoutError(
                f"retire_engine({name}): {inflight:g} requests still in "
                f"flight after {timeout}s")
        time.sleep(poll)
    net.retire_locality(lid, timeout=min(timeout, 30.0))
    _c("retired").increment()
    return lid
