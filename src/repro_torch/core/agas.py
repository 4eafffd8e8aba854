"""AGAS — Active Global Address Space (HPX P3, paper §2.2).

Every distributed object lives in AGAS under a *GID* (global id); access is
location-transparent, and objects may *migrate* between localities for load
balancing, with AGAS responsible for address resolution.

A "locality" is a placement — a device (or host memory).  An AGAS record
therefore binds::

    GID → (symbolic name, dict of tensors, placement metadata, generation)

Migration (:mod:`repro_torch.core.migration`) moves the tensors to a new
placement and bumps the record's generation — the GID is stable across
migrations, exactly the paper's "independence of whether an object is located
remotely or local".  Model/optimizer state, KV caches and performance
counters are all registered here; the checkpoint layer saves/restores *by
GID*, which is what makes elastic restart (restore onto a different mesh)
a pure AGAS operation.

Multi-locality tier (:mod:`repro_torch.net`): when localities are real OS
processes, each process runs one AGAS instance whose ``locality`` id seeds
every GID it mints (``set_default_locality`` pins it before first use in a
worker process).  The net tier observes this instance through *hooks* —
``add_hook(fn)`` registers ``fn(event, record)`` called on ``register`` /
``rebind`` / ``unregister``, always *outside* the AGAS lock so a hook may
send parcels — and installs foreign-minted GIDs after a cross-process
migration via :meth:`AGAS.adopt`.  Core stays transport-free; the hooks are
the entire coupling surface.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class GID:
    """Global identifier: (locality id, sequence number) like HPX msb/lsb."""

    locality: int
    seq: int

    def __repr__(self) -> str:
        return f"gid{{{self.locality:04x}:{self.seq:012x}}}"


@dataclass
class AgasRecord:
    gid: GID
    obj: Any
    name: Optional[str] = None
    placement: Optional[Any] = None  # sharding / mesh descriptor / "host"
    generation: int = 0  # bumped on every migration
    meta: Dict[str, Any] = field(default_factory=dict)


class AGAS:
    """The resolver: GID ↔ object ↔ symbolic name."""

    def __init__(self, locality: int = 0):
        self.locality = locality
        self._seq = itertools.count(1)
        self._records: Dict[GID, AgasRecord] = {}
        self._names: Dict[str, GID] = {}
        self._lock = threading.RLock()
        self._hooks: List[Any] = []  # fn(event, record), fired outside _lock
        # AGAS exposes its own counters (paper: counters are read *via* AGAS)
        from repro_torch.core import counters as _counters

        reg = _counters.default()
        self._c_objects = reg.gauge(f"/agas{{locality#{locality}}}/objects/count")
        self._c_migrations = reg.counter(f"/agas{{locality#{locality}}}/migrations/cumulative")
        self._c_resolutions = reg.counter(f"/agas{{locality#{locality}}}/resolutions/cumulative")

    # --------------------------------------------------------------- hooks
    def add_hook(self, fn) -> None:
        """Observe mutations: ``fn(event, record)`` with event one of
        ``register`` / ``rebind`` / ``unregister``.  Hooks run *outside* the
        AGAS lock, so they may resolve, register, or send parcels."""
        with self._lock:
            self._hooks.append(fn)

    def remove_hook(self, fn) -> None:
        with self._lock:
            if fn in self._hooks:
                self._hooks.remove(fn)

    def _fire(self, event: str, rec: AgasRecord) -> None:
        with self._lock:
            hooks = list(self._hooks)
        for h in hooks:
            h(event, rec)

    # ------------------------------------------------------------ register
    def register(
        self,
        obj: Any,
        name: Optional[str] = None,
        placement: Optional[Any] = None,
        **meta: Any,
    ) -> GID:
        """Give ``obj`` a global identity; optionally bind a symbolic name."""
        with self._lock:
            if name is not None and name in self._names:
                # check BEFORE inserting: a raced bind must not leave an
                # orphan record behind (register_name retries rely on this)
                raise KeyError(f"AGAS name already bound: {name!r}")
            gid = GID(self.locality, next(self._seq))
            rec = AgasRecord(gid=gid, obj=obj, name=name, placement=placement, meta=dict(meta))
            self._records[gid] = rec
            if name is not None:
                self._names[name] = gid
            self._c_objects.set(len(self._records))
        self._fire("register", rec)
        return gid

    def adopt(
        self,
        gid: GID,
        obj: Any,
        name: Optional[str] = None,
        placement: Optional[Any] = None,
        generation: int = 0,
        **meta: Any,
    ) -> AgasRecord:
        """Install an object under a *foreign-minted* GID (the receiving end
        of a cross-locality migration: the GID stays stable, this locality
        becomes the owner, the generation carries over pre-bumped)."""
        with self._lock:
            if gid in self._records:
                raise KeyError(f"AGAS already holds {gid}")
            rec = AgasRecord(gid=gid, obj=obj, name=name, placement=placement,
                             generation=generation, meta=dict(meta))
            self._records[gid] = rec
            if name is not None:
                self._names[name] = gid  # rebind: the name follows the object
            self._c_objects.set(len(self._records))
        self._fire("register", rec)
        return rec

    def register_name(self, name: str, obj: Any, replace: bool = False, **meta: Any) -> GID:
        """Bind-or-rebind a symbolic name (used for counters).

        The fresh-bind path runs ``register`` outside the lock (hooks may
        send parcels), so a concurrent binder can win the name in between;
        with ``replace=True`` the loser retries as a rebind instead of
        surfacing the spurious already-bound error."""
        while True:
            with self._lock:
                existing = self._names.get(name)
                if existing is not None:
                    if not replace:
                        raise KeyError(f"AGAS name already bound: {name!r}")
                    rec = self._records[existing]
                    rec.obj = obj
                    rec.meta.update(meta)
                    return existing
            try:
                return self.register(obj, name=name, **meta)
            except KeyError:
                if not replace:
                    raise
                continue  # lost the bind race — rebind on the next pass

    def unregister(self, gid: GID) -> None:
        with self._lock:
            rec = self._records.pop(gid, None)
            if rec is None:
                raise KeyError(f"unknown {gid}")
            if rec.name is not None and self._names.get(rec.name) == gid:
                # only drop the binding we still own — adopt() may have
                # rebound the name to another record ("the name follows
                # the object"), and that live binding must survive
                del self._names[rec.name]
            self._c_objects.set(len(self._records))
        self._fire("unregister", rec)

    # ------------------------------------------------------------- resolve
    def resolve(self, gid_or_name) -> Any:
        """GID/name → live object (the one-sided access path)."""
        return self.record(gid_or_name).obj

    def record(self, gid_or_name) -> AgasRecord:
        with self._lock:
            self._c_resolutions.increment()
            gid = self._names[gid_or_name] if isinstance(gid_or_name, str) else gid_or_name
            return self._records[gid]

    def gid_of(self, name: str) -> GID:
        with self._lock:
            return self._names[name]

    def contains(self, gid_or_name) -> bool:
        with self._lock:
            if isinstance(gid_or_name, str):
                return gid_or_name in self._names
            return gid_or_name in self._records

    # ------------------------------------------------------------- migrate
    def rebind(self, gid: GID, obj: Any, placement: Optional[Any] = None) -> int:
        """Install a migrated object under the same GID. Returns new generation."""
        with self._lock:
            rec = self._records[gid]
            rec.obj = obj
            if placement is not None:
                rec.placement = placement
            rec.generation += 1
            gen = rec.generation
            self._c_migrations.increment()
        self._fire("rebind", rec)
        return gen

    # ------------------------------------------------------------- queries
    def names(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(n for n in self._names if n.startswith(prefix))

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __iter__(self) -> Iterator[AgasRecord]:
        with self._lock:
            return iter(list(self._records.values()))


_default: Optional[AGAS] = None
_default_locality = 0
_lock = threading.Lock()


def set_default_locality(locality: int) -> None:
    """Pin the locality id the process-wide AGAS instance mints GIDs with.

    Must run before :func:`default` first constructs the instance — worker
    processes call this first thing in their entry point (see
    ``repro_torch.net.locality``) so every GID they mint is attributable."""
    global _default_locality
    with _lock:
        if _default is not None and _default.locality != locality:
            raise RuntimeError(
                f"default AGAS already initialised with locality "
                f"{_default.locality}, cannot re-pin to {locality}")
        _default_locality = locality


def peek() -> Optional[AGAS]:
    """The process-wide instance if it exists, WITHOUT constructing one.

    Counter publishing uses this: during ``AGAS.__init__`` (which creates
    gauges through the counter registry) the instance is not yet visible
    here, so the publish path skips instead of re-entering ``default()``
    and deadlocking on the non-reentrant module lock."""
    return _default


def default() -> AGAS:
    global _default
    created = None
    with _lock:
        if _default is None:
            _default = created = AGAS(locality=_default_locality)
        inst = _default
    if created is not None:
        # Sweep pre-existing counters into the fresh resolver, outside the
        # module lock (register_name takes the instance lock + fires hooks).
        from repro_torch.core import counters as _counters

        _counters.default().republish_to_agas()
    return inst


def register(obj: Any, name: Optional[str] = None, **kw: Any) -> GID:
    return default().register(obj, name=name, **kw)


def resolve(gid_or_name) -> Any:
    return default().resolve(gid_or_name)
