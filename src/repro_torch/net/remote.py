"""Remote invocation over the distributed AGAS tier (HPX §2.2–2.3), ported
from the reference's ``net/remote.py``.

Resolution is two-tier, exactly the paper's AGAS split:

- **root table** (locality 0, authoritative): GID → (owner locality,
  generation), plus the symbolic-name index.  Fed by the AGAS hook every
  locality installs at bootstrap — each ``register`` / ``rebind`` /
  ``unregister`` publishes.
- **per-locality resolution cache**: owner placements learned from root
  lookups.  *Generation-based invalidation*: a parcel landing at a
  locality that no longer holds the object comes back as
  :class:`~repro_torch.net.locality.UnknownGid`; the caller drops its cached
  placement, re-resolves through the root (whose entry carries a strictly
  newer generation after any migration) and retries.  Steady-state
  dispatch therefore costs zero extra messages — the HPX+LCI lens — while
  migration pays one extra round trip only on first touch.

``apply_remote(action, gid, *args) -> Future`` is the user surface:
one-sided, asynchronous, locality-transparent — and what
``repro_torch.core.parcel.apply`` delegates to (via the installed route) when a
target does not resolve locally, so existing call sites gain multi-process
reach without a spelling change.

Cross-process migration (:func:`migrate_remote`) moves the *object*:
host-snapshot at the owner, ``AGAS.adopt`` under the same GID at the
destination with a bumped generation (publishing the new owner), then
unregister at the source (a conditional unpublish that cannot erase the
new owner's entry).  ``repro_torch.core.migration`` keeps working unchanged for
intra-process placement moves; this is the inter-process tier above it.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import parcel as _parcel
from repro_torch.core.future import Future, Promise
from repro_torch.net.locality import (
    ROOT,
    Locality,
    NetRuntime,
    UnknownGid,
    _gid_key,
    current,
    require,
)

_MAX_ATTEMPTS = 6
_RETRY_DELAY = 0.08  # backoff base once staleness repeats (mid-migration)

_Target = Union[_agas.GID, str]


def _locality_id(loc: Union[int, Locality]) -> int:
    return loc.id if isinstance(loc, Locality) else int(loc)


def _action_name(fn: Union[str, Callable[..., Any]]) -> str:
    if isinstance(fn, str):
        return fn
    name = getattr(fn, "_action_name", None)
    return name or _parcel._registry.register(fn)


# ------------------------------------------------------- root-table actions
@_parcel.action
def _root_publish(rt: NetRuntime, key, owner: int, generation: int,
                  name: Optional[str]) -> int:
    return rt.publish_local(tuple(key), owner, generation, name)


@_parcel.action
def _root_unpublish(rt: NetRuntime, key, owner: int) -> bool:
    return rt.unpublish_local(tuple(key), owner)


@_parcel.action
def _root_lookup(rt: NetRuntime, key) -> Tuple[int, int]:
    return rt.lookup_local(tuple(key))


@_parcel.action
def _root_lookup_name(rt: NetRuntime, name: str):
    return list(rt.lookup_name_local(name))


@_parcel.action
def _counters_query(rt: NetRuntime, pattern: str):
    return _counters.default().query(pattern)


@_parcel.action
def _counters_stats(rt: NetRuntime, pattern: str):
    return _counters.default().snapshot_stats(pattern)


@_parcel.action
def _counters_export(rt: NetRuntime, pattern: str):
    return _counters.default().snapshot_export(pattern)


@_parcel.action
def _echo(rt: NetRuntime, value: Any) -> Any:
    """Round-trip probe (latency benchmarks, liveness checks)."""
    return value


@_parcel.action
def _slow_sink(rt: NetRuntime, value: Any, delay_s: float = 0.0) -> int:
    """Deliberately slow consumer: holds its executed parcel for
    ``delay_s`` before acking.  Because CREDIT is returned only after
    execution, flooding this action keeps the sender's budget pinned —
    the probe the backpressure tests and the flood benchmark drive."""
    if delay_s > 0:
        time.sleep(delay_s)
    return len(value) if hasattr(value, "__len__") else 0


@_parcel.action
def _record_meta(rt: NetRuntime, key) -> Dict[str, Any]:
    a = _agas.default()
    gid = _agas.GID(*key)
    if not a.contains(gid):
        raise UnknownGid(tuple(key), rt.locality)
    rec = a.record(gid)
    return {"gid": list(key), "name": rec.name, "generation": rec.generation}


@_parcel.action
def _host_snapshot(obj: Any) -> Any:
    """Object-targeted: ship a host copy of the resolved object's state —
    every tensor of the tree (dicts, lists, tuples) copied to the host,
    blocking, so the snapshot is whole before the parcel leaves."""
    import torch

    def walk(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):  # NamedTuple
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(obj)


@_parcel.action
def _install_state(rt: NetRuntime, name: Optional[str], state: Any):
    """Register (or rebind) ``state`` at this locality; returns the GID key.

    The restore half of by-GID checkpointing: a fresh locality adopts a
    saved object's state under its old symbolic name."""
    a = _agas.default()
    if name is not None and a.contains(name):
        gid = a.gid_of(name)
        a.rebind(gid, state)
        return list(_gid_key(gid))
    return list(_gid_key(a.register(state, name=name)))


@_parcel.action
def _migrate_in(rt: NetRuntime, key, state: Any, name: Optional[str],
                generation: int) -> int:
    rec = _agas.default().adopt(_agas.GID(*key), state, name=name,
                                generation=generation)
    return rec.generation


@_parcel.action
def _migrate_out(rt: NetRuntime, key, dest: int) -> int:
    """Runs at the owner: push the object to ``dest``, then drop it here.

    Ordering is the correctness story: (1) dest holds the object under the
    same GID with generation+1, (2) dest's adopt published the new owner
    to the root, (3) only then does the source unregister (its conditional
    unpublish is a no-op — the root already points at dest).  A resolve
    racing this lands either at the old owner while the object is still
    there, or misses and re-resolves to dest; never in a gap."""
    a = _agas.default()
    gid = _agas.GID(*key)
    if not a.contains(gid):
        raise UnknownGid(tuple(key), rt.locality)
    rec = a.record(gid)
    state = _host_snapshot(rec.obj)
    gen = rt.send_parcel(dest, _MIGRATE_IN_NAME, None,
                         (list(key), state, rec.name, rec.generation + 1)
                         ).get(timeout=120)
    a.unregister(gid)
    rt.cache_invalidate(tuple(key))
    return gen


# Wire names the locality layer references without importing the functions.
ROOT_PUBLISH = _root_publish._action_name
ROOT_UNPUBLISH = _root_unpublish._action_name
_MIGRATE_IN_NAME = _migrate_in._action_name


# -------------------------------------------------------------- resolution
def _resolve_owner(net: NetRuntime, target: _Target,
                   refresh: bool = False) -> Tuple[int, Tuple[int, int]]:
    """Target → (owner locality, GID key); local AGAS wins, then the cache,
    then the root (``refresh=True`` skips the cache — the retry path)."""
    a = _agas.default()
    if isinstance(target, str):
        if a.contains(target):
            return net.locality, _gid_key(a.gid_of(target))
        key = None if refresh else net.name_cache_get(target)
        if key is None:
            if net.is_root():
                key = tuple(net.lookup_name_local(target))
            else:
                key = tuple(net.send_parcel(
                    ROOT, _root_lookup_name._action_name, None,
                    (target,)).get(timeout=60))
            net.name_cache_put(target, key)
    else:
        key = _gid_key(target)
        if a.contains(target):
            return net.locality, key
    if not refresh:
        hit = net.cache_get(key)
        if hit is not None:
            return hit[0], key
    if net.is_root():
        owner, gen = net.lookup_local(key)
    else:
        owner, gen = net.send_parcel(
            ROOT, _root_lookup._action_name, None,
            (list(key),)).get(timeout=60)
    net.c_root_lookups.increment()
    net.cache_put(key, owner, gen)
    return owner, key


# ------------------------------------------------------------ apply_remote
def apply_remote(fn: Union[str, Callable[..., Any]], target: _Target,
                 *args: Any, **kwargs: Any) -> Future:
    """``hpx::async(action, gid, args...)`` across localities.

    Resolves ``target`` (GID or symbolic name) through the distributed
    AGAS tier, ships the invocation to the owning locality, and returns a
    Future completed by the result frame.  Stale cached placements
    (object migrated since the last resolve) self-heal: up to
    ``_MAX_ATTEMPTS`` re-resolve-and-retry rounds through the root.
    ``fn`` must be a module-level function (workers resolve it by dotted
    name, importing the defining module on first use)."""
    net = require()
    return _apply_remote_named(net, _action_name(fn), target, args, kwargs)


def _apply_remote_named(net: NetRuntime, action_name: str, target: _Target,
                        args: Tuple[Any, ...],
                        kwargs: Dict[str, Any]) -> Future:
    promise: Promise = Promise()

    def attempt(n: int) -> None:
        try:
            owner, key = _resolve_owner(net, target, refresh=n > 0)
            fut = net.send_parcel(owner, action_name, key, args, kwargs)
        except BaseException as e:  # noqa: BLE001 — resolution failed
            promise.set_exception(e)
            return

        def done(f: Future) -> None:
            exc = f.exception()
            if isinstance(exc, UnknownGid) and n + 1 < _MAX_ATTEMPTS:
                net.cache_invalidate(key)
                net.c_stale.increment()
                if n == 0:  # ordinary stale cache: re-resolve immediately
                    net._exec.post(attempt, n + 1)
                else:
                    # repeated misses mean the object is mid-cutover (live
                    # migration closed the source before the destination
                    # adopted): exponential backoff stretches the retry
                    # budget across the whole transfer window
                    timer = threading.Timer(_RETRY_DELAY * (2 ** (n - 1)),
                                            net._exec.post, (attempt, n + 1))
                    timer.daemon = True
                    timer.start()
            else:
                promise.set_from(f)

        fut.on_ready(done)

    net._exec.post(attempt, 0)
    return promise.future()


def route_parcel(net: NetRuntime, p: _parcel.Parcel) -> Optional[Future]:
    """The hook :mod:`repro_torch.core.parcel` calls for locally-unresolvable
    targets — makes plain ``parcel.apply`` locality-transparent."""
    return _apply_remote_named(net, p.action_name, p.target, p.args,
                               dict(p.kwargs))


def run_on(locality: Union[int, Locality], fn: Union[str, Callable[..., Any]],
           *args: Any, **kwargs: Any) -> Future:
    """Run a module-level function *at* a locality (target = its runtime).

    The remote first argument is the destination's :class:`NetRuntime` —
    the idiom for control-plane work (spawn an engine, probe counters)."""
    net = require()
    return net.send_parcel(_locality_id(locality), _action_name(fn), None,
                           args, kwargs)


# ------------------------------------------------------------ conveniences
def owner_of(target: _Target) -> int:
    """The locality that currently holds ``target`` (root-fresh when the
    local cache is cold; may be one migration stale otherwise — parcel
    dispatch self-heals, this is for placement *reporting*)."""
    net = require()
    owner, _key = _resolve_owner(net, target)
    return owner


def _counter_sweep(localities, action, local_read, pattern: str,
                   timeout: float) -> Dict[int, Any]:
    """Fan a counter read out to many localities at once and survive any of
    them dying mid-sweep: a dead peer contributes ``{"error": "..."}``
    instead of poisoning the whole read.  The fleet controller keeps
    steering through a failure precisely because this never raises."""
    net = require()
    if localities is None:
        ids = net.live_ids()
    else:
        ids = [_locality_id(loc) for loc in localities]
    futures: Dict[int, Any] = {}
    out: Dict[int, Any] = {}
    for lid in ids:
        if lid == net.locality:
            continue
        try:
            futures[lid] = run_on(lid, action, pattern)
        except BaseException as e:  # noqa: BLE001 — no route: mark, move on
            out[lid] = {"error": repr(e)}
    for lid in ids:
        if lid == net.locality:
            try:
                out[lid] = local_read(pattern)
            except BaseException as e:  # noqa: BLE001
                out[lid] = {"error": repr(e)}
        elif lid in futures:
            try:
                out[lid] = futures[lid].get(timeout=timeout)
            except BaseException as e:  # noqa: BLE001 — died mid-sweep
                out[lid] = {"error": repr(e)}
    return out


def query_counters(locality: Union[int, Locality, list, None],
                   pattern: str = "*", timeout: float = 60.0):
    """Read performance counters over the parcelport (paper §2.4: counters
    are readable from any locality *via AGAS*).

    A single locality returns its ``[(name, value), ...]`` pairs (raising
    if it is unreachable — the strict spelling).  ``None`` (every live
    locality) or a list sweeps in parallel and returns
    ``{locality: pairs | {"error": ...}}`` — a peer dying mid-sweep yields
    an error marker, never an exception, so control loops keep working
    through a failure."""
    if locality is None or isinstance(locality, (list, tuple)):
        return _counter_sweep(locality, _counters_query,
                              _counters.default().query, pattern, timeout)
    net = require()
    lid = _locality_id(locality)
    if lid == net.locality:
        return _counters.default().query(pattern)
    return run_on(lid, _counters_query, pattern).get(timeout=timeout)


def query_counter_stats(locality: Union[int, Locality, list, None],
                        pattern: str = "*", timeout: float = 60.0):
    """Full per-counter statistics: timers and histograms keep
    mean/max/p50/p95/p99 instead of collapsing to one scalar — what
    ``--print-counters`` and the fleet sampler report.  Same single-vs-sweep
    contract as :func:`query_counters` (sweeps tolerate dead peers)."""
    if locality is None or isinstance(locality, (list, tuple)):
        return _counter_sweep(locality, _counters_stats,
                              _counters.default().snapshot_stats,
                              pattern, timeout)
    net = require()
    lid = _locality_id(locality)
    if lid == net.locality:
        return _counters.default().snapshot_stats(pattern)
    return run_on(lid, _counters_stats, pattern).get(timeout=timeout)


def query_counter_export(locality: Union[int, Locality, list, None],
                         pattern: str = "*", timeout: float = 60.0):
    """Typed export records (kind + histogram buckets) — the read the
    OpenMetrics ``/metrics`` endpoint fans out on every scrape.  Same
    single-vs-sweep contract as :func:`query_counters` (sweeps tolerate a
    locality dying mid-scrape: it contributes an ``{"error": ...}``
    marker, which the exposition renders as ``repro_up 0``)."""
    if locality is None or isinstance(locality, (list, tuple)):
        return _counter_sweep(locality, _counters_export,
                              _counters.default().snapshot_export,
                              pattern, timeout)
    net = require()
    lid = _locality_id(locality)
    if lid == net.locality:
        return _counters.default().snapshot_export(pattern)
    return run_on(lid, _counters_export, pattern).get(timeout=timeout)


def fetch(target: _Target, timeout: float = 120.0) -> Any:
    """Host-side snapshot of a (possibly remote) AGAS object's state."""
    return apply_remote(_host_snapshot, target).get(timeout=timeout)


def describe(target: _Target, timeout: float = 60.0) -> Dict[str, Any]:
    """The owner's record metadata (``gid`` key, symbolic name,
    generation) for a possibly-remote AGAS object — the public API by-GID
    checkpointing uses to stamp ``agas.json`` so a respawn keeps the
    object's identity.  Resolution is cached, so a following ``fetch``
    goes straight to the owner."""
    net = require()
    owner, key = _resolve_owner(net, target)
    if owner == net.locality:
        rec = _agas.default().record(_agas.GID(*key))
        return {"gid": list(key), "name": rec.name,
                "generation": rec.generation}
    return run_on(owner, _record_meta, list(key)).get(timeout=timeout)


def migrate_remote(target: _Target, dest: Union[int, Locality],
                   timeout: float = 120.0) -> int:
    """Move an AGAS object to another locality; its GID stays valid.

    Returns the new generation.  Concurrent resolvers never observe a gap:
    they either reach the old owner pre-unregister or retry through the
    root to the new one (see :func:`_migrate_out`)."""
    net = require()
    dest_id = _locality_id(dest)
    last: Optional[BaseException] = None
    for attempt in range(_MAX_ATTEMPTS):
        owner, key = _resolve_owner(net, target, refresh=attempt > 0)
        if owner == dest_id:
            if net.is_root():
                return net.lookup_local(key)[1]
            return net.send_parcel(ROOT, _root_lookup._action_name, None,
                                   (list(key),)).get(timeout=60)[1]
        try:
            gen = run_on(owner, _migrate_out, list(key),
                         dest_id).get(timeout=timeout)
        except UnknownGid as e:  # owner moved under us — re-resolve
            net.cache_invalidate(key)
            last = e
            continue
        net.cache_invalidate(key)
        return gen
    raise last if last is not None else RuntimeError("migrate_remote failed")
