"""Live engine migration: move a *running* engine — paged KV cache and
in-flight streams included — to another locality, dropping zero tokens.
Ported from the reference's ``fleet/migrate.py``; in the port the KV pages
leave the source card through one device-to-host copy per pool, cross
the parcelport (bf16 as its bits) and are written into the destination's
pool on its card.

This composes three mechanisms built elsewhere:

- ``migrate_remote``'s **no-gap ordering** (repro_torch.net.remote): install at
  the destination under the same GID with generation+1 — which publishes
  the new owner to the AGAS root — *before* the source unregisters (whose
  conditional unpublish then no-ops).  A resolver racing the cutover lands
  at the old owner while the object is still answering, or misses and
  re-resolves to the new one; never in a gap.
- The engine's **pause / take / restore** surface (repro_torch.serve.engine):
  quiesce at a decode-step boundary, drain every request — active slots
  with their block-pool pages (:meth:`PagedKVCache.snapshot_slot`: live
  tokens only, never the whole pool), queued ones as prompts — into a
  picklable snapshot, and rebuild them slot-for-slot at the destination
  (``pos``/``last_tok``/sampling mirrors restored, decode continues
  mid-generation).
- The **relay**'s indexed streams (repro_torch.serve.relay): the destination
  re-attaches each migrated request's stream at ``idx=len(generated)``,
  continuing the numbering the source left off; the client sink's per-index
  dedup + done-parcel backfill make delivery exactly-once across the
  cutover regardless of how parcels interleave.

Timeline (coordinator = locality 0, where the router lives)::

    stage      dest:   build identical engine shell (router.spec), paused
    suspend    root:   router stops dispatching to the engine
    quiesce    source: pause → close_for_migration (submits now answer
                       UnknownGid → callers re-resolve) → take_requests
    install    dest:   restore_requests (+relay re-attach) → AGAS adopt
                       (gen+1, publishes new owner) → resume
    release    source: unregister (conditional unpublish no-ops)
    re-home    root:   RemoteEngine.locality ← dest; sinks re-pinned so a
                       later source retirement can't abort live streams
    resume     root:   router dispatches to the engine again

Counters: ``/fleet{migrate}/engines_moved``, ``/fleet{migrate}/requests_moved``
(plus the per-engine ``/serve{...}/requests/migrated_{in,out}`` pair), and
two the port adds: ``/fleet{migrate}/kv_bytes`` (the KV bytes of the
active slots that travelled) and the timer ``/fleet{migrate}/cutover``
(suspend → resume: the window in which the engine serves nobody).
"""

from __future__ import annotations

import time
from typing import Any, Dict

from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import parcel as _parcel
from repro_torch.serve.router import (
    ENGINE_NAME_PREFIX,
    RemoteEngine,
    Router,
    build_engine,
)

__all__ = ["migrate_engine"]

# destination-side staging area: engines built but not yet AGAS-visible
_staged: Dict[str, Any] = {}


# ------------------------------------------------------------ remote actions
@_parcel.action
def _stage_engine(rt, arch: str, smoke: bool, scfg_kwargs: Dict[str, Any],
                  device=None, dtype=None) -> bool:
    """Destination, phase A: build an identical engine shell (same recipe,
    same name → shared counter identity) and park it paused + unpublished.
    All the expensive work (param init, the page pool) happens here,
    *outside* the cutover window."""
    engine = build_engine(arch, smoke, scfg_kwargs, device, dtype)
    engine.pause()  # nothing runs until install hands it requests
    _staged[engine.scfg.name] = engine
    return True


@_parcel.action
def _unstage_engine(rt, name: str) -> bool:
    """Destination, abort path: drop a staged shell that will never be
    installed (the quiesce failed)."""
    return _staged.pop(name, None) is not None


@_parcel.action
def _quiesce_engine(engine, key) -> Dict[str, Any]:
    """Source, phase B (object-targeted — resolves while the source still
    owns the GID): stop at a step boundary, flip submits to UnknownGid,
    drain everything into the travel snapshot.  The engine object stays
    registered until the destination has adopted."""
    engine.pause()
    engine.close_for_migration(tuple(key))
    return engine.take_requests()


@_parcel.action
def _install_engine(rt, key, name: str, snap: Dict[str, Any],
                    generation: int) -> int:
    """Destination, phase C: adopt the requests, then the identity.

    Order inside matters: requests are restored and their relays
    re-attached *before* the AGAS adopt publishes this locality as owner —
    once a racing submit can land here, the engine must already be whole.
    ``resume`` comes last; the first decode step continues mid-generation
    requests from their shipped ``pos``/``last_tok``."""
    from repro_torch.serve import relay as _relay

    engine = _staged.pop(name)
    n = engine.restore_requests(snap, reattach=_relay.reattach_for(engine))
    _agas.default().adopt(_agas.GID(*key), engine,
                          name=f"{ENGINE_NAME_PREFIX}{name}",
                          generation=generation)
    engine.resume()
    return n


@_parcel.action
def _release_engine(rt, key) -> bool:
    """Source, phase D: drop the husk.  Its unregister's conditional
    unpublish no-ops at the root (the destination's adopt already
    published a newer generation) — exactly ``_migrate_out``'s ordering."""
    a = _agas.default()
    gid = _agas.GID(*key)
    if not a.contains(gid):
        return False
    a.unregister(gid)
    rt.cache_invalidate(tuple(key))
    return True


def _kv_nbytes(snap: Dict[str, Any]) -> int:
    """Bytes of the KV pages an engine snapshot carries (its active slots;
    pages arrive as numpy arrays, bf16 ones as tensors)."""
    n = 0
    for e in snap["active"]:
        for pages in e["kv"]["pages"].values():
            n += (pages.numel() * pages.element_size()
                  if hasattr(pages, "element_size") else pages.nbytes)
    return n


# -------------------------------------------------------------- coordinator
def migrate_engine(net, router: Router, name: str, dest: int,
                   timeout: float = 600.0) -> int:
    """Live-migrate the remote engine ``name`` to locality ``dest``.
    Returns the number of in-flight requests that moved with it.

    The engine keeps its GID, symbolic name and counters; its in-flight
    requests resume mid-generation at the destination; its streams keep
    flowing into the same client channels with zero dropped or duplicated
    tokens (counter-verified: ``/serve{relay}/tokens/duplicates`` stays
    flat across a migration)."""
    from repro_torch.net import remote as _remote
    from repro_torch.net.locality import _gid_key
    from repro_torch.serve import relay as _relay

    if not net.is_root():
        raise RuntimeError("migrate_engine coordinates from the root")
    engine = router.engine(name)
    if not isinstance(engine, RemoteEngine):
        raise ValueError(f"{name!r} is not a remote engine handle")
    if not net.is_live(dest):
        raise ValueError(f"destination locality#{dest} is not live")
    src = engine.locality
    if dest == src:
        return 0
    spec = router.spec
    if spec is None:
        raise RuntimeError("router has no construction spec "
                           "(migration requires Router.over_localities)")
    key = _gid_key(engine.gid)

    reg = _counters.default()
    c_moved = reg.counter("/fleet{migrate}/engines_moved")
    c_reqs = reg.counter("/fleet{migrate}/requests_moved")
    c_kv = reg.counter("/fleet{migrate}/kv_bytes")
    t_cutover = reg.timer("/fleet{migrate}/cutover")

    # A: stage the shell at the destination (slow; cutover not started)
    _remote.run_on(dest, _stage_engine, spec["arch"], spec["smoke"],
                   {**spec["scfg_kwargs"], "name": name}, spec["device"],
                   spec["dtype"]).get(timeout=timeout)

    # cutover starts: router stops feeding the engine
    router.suspend(name)
    t0 = time.perf_counter()
    try:
        try:
            snap = _remote.apply_remote(_quiesce_engine, engine.gid,
                                        list(key)).get(timeout=timeout)
        except BaseException:
            _remote.run_on(dest, _unstage_engine, name)
            raise
        generation = net.lookup_local(key)[1]
        n = _remote.run_on(dest, _install_engine, list(key), name, snap,
                           generation + 1).get(timeout=timeout)
        # destination owns the GID now (adopt published gen+1); the husk
        # at the source can go — racing resolvers self-heal via UnknownGid
        _remote.run_on(src, _release_engine, list(key)).get(timeout=timeout)
        net.cache_invalidate(key)
        # re-pin client-side stream sinks BEFORE anyone may retire src —
        # the peer-down hook must not abort streams dest is now feeding
        _relay.rehome_streams(src, dest)
        engine.locality = dest
    finally:
        router.resume(name)
        t_cutover.add(time.perf_counter() - t0)
    c_moved.increment()
    c_reqs.increment(int(n))
    c_kv.increment(_kv_nbytes(snap))
    return int(n)
