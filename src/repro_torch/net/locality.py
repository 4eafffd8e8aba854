"""Localities as real OS processes (HPX §2.2: the unit of distribution),
ported from the reference's ``net/locality.py``.

In the port each worker process imports ``repro_torch`` fresh and touches
no CUDA until something it runs (an engine build) asks for the card, so
every locality opens its own CUDA context; several localities may share
one card.  Listening ports are ephemeral (bound to port 0), so fleets in
concurrent processes never collide.

Until this subsystem, a "locality" in this repo was a sharding — every
parcel, AGAS record and migration lived inside one OS process.  Here
:func:`bootstrap` makes localities *processes*: it forks ``n-1`` worker
runtimes (``multiprocessing`` spawn — never ``fork``, which would duplicate
live scheduler threads mid-lock) and wires every worker to locality 0 over
the parcelport.  Locality 0 is the **AGAS root**: it owns the authoritative
GID → owner-locality table (see :mod:`repro_torch.net.remote`) and acts as the
frame switch for worker↔worker traffic (hub-and-spoke, the LCI study's
"put the progress engine where the wires meet").

Topology::

        locality#1 ══╗
        locality#2 ══╣══ locality#0 (root: AGAS table + frame switch)
        locality#3 ══╝
         each ══: 1 priority lane + N bulk lanes (NetConfig.stripes)
         each process: NetRuntime + AMT scheduler + parcelport Port

Every process runs the full single-process stack (scheduler pools,
executors, AGAS, counters) plus one :class:`NetRuntime`:

- **send side** — ``send_parcel(dst, action, target, args)`` allocates a
  sequence number, parks a :class:`~repro_torch.core.future.Promise` in the
  pending table and hands the frame to the peer's
  :class:`~repro_torch.net.parcelport.Channel`, which picks the protocol tier
  (eager+coalesced vs rendezvous+striped) and applies backpressure; the
  returned Future is completed by the matching result frame.
- **receive side** — the port's progress thread delivers parsed frames;
  parcel decode+execution is posted into the scheduler's "io" pool (a
  blocked action helps along, so nested remote calls cannot deadlock the
  pool), result frames complete pending promises inline, and each
  executed parcel returns its CREDIT to the sender (the backpressure
  ack).
- **integration** — ``bootstrap`` installs the AGAS hook (registrations
  publish to the root table) and the core parcel remote-route, so
  ``repro_torch.core.parcel.apply`` transparently crosses process boundaries.
"""

from __future__ import annotations

import itertools
import os
import socket
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import executor as _executor
from repro_torch.core import parcel as _parcel
from repro_torch.core.future import Future, Promise
from repro_torch.net import parcelport as _pp
from repro_torch.obs import trace as _trace

ROOT = 0

_GidKey = Tuple[int, int]  # (locality, seq) — the wire form of a GID


@dataclass(frozen=True)
class Locality:
    """Handle to one locality (HPX ``hpx::naming::id_type`` of a locality)."""

    id: int

    def __repr__(self) -> str:
        return f"locality#{self.id}"


class UnknownGid(RuntimeError):
    """The target GID does not resolve at the locality that was asked.

    Carried across the wire as the stale-resolution signal: the caller
    invalidates its cached placement and re-resolves through the root
    (generation-based invalidation — see ``repro_torch.net.remote``).
    """

    @property
    def key(self) -> _GidKey:
        return self.args[0]

    @property
    def locality(self) -> int:
        return self.args[1]


def _gid_key(gid: _agas.GID) -> _GidKey:
    return (gid.locality, gid.seq)


class _RuntimeHooks(_pp.PortHooks):
    """The :class:`NetRuntime` side of the port's callback surface."""

    __slots__ = ("net",)

    def __init__(self, net: "NetRuntime"):
        self.net = net

    def deliver(self, fr: _pp.Frame, channel: _pp.Channel) -> None:
        self.net._on_frame(fr, channel)

    def route(self, dst: int) -> _pp.Channel:
        return self.net._route_to(dst)

    def forward_failed(self, fr: _pp.Frame) -> None:
        self.net._forward_failed(fr)

    def on_forwarded(self) -> None:
        self.net.c_forwarded.increment()

    def on_close(self, channel: _pp.Channel) -> None:
        self.net._on_conn_close(channel)


class NetRuntime:
    """Per-process endpoint of the multi-locality runtime."""

    def __init__(self, locality: int, n_localities: int,
                 config: Optional[_pp.NetConfig] = None):
        self.locality = locality
        self.n_localities = n_localities
        self.config = config or _pp.NetConfig.from_env()
        self._port = _pp.Port(locality, _RuntimeHooks(self), self.config)
        self._conns: Dict[int, _pp.Channel] = {}
        # seq → (promise, destination locality): the dst lets a dead-peer
        # notification fail exactly the calls that can no longer complete
        self._pending: Dict[int, Tuple[Promise, int]] = {}
        self._pending_lock = threading.Lock()
        self._seq = itertools.count(1)
        self._stop = threading.Event()
        self._procs: Dict[int, Any] = {}  # root only: lid → Process handle
        self._hook_installed = False
        # elastic topology (root authoritative, gossiped via TOPO frames):
        # n_localities is the size of the id space ever assigned; retired
        # ids are never reused, so GIDs minted by a dead locality stay
        # unambiguous forever.
        self._retired: set = set()
        self._expect_down: set = set()  # retirements in progress (no re-DOWN)
        self._topo_lock = threading.Lock()
        # observers of peer departure (crash or retirement): the serve/fleet
        # layers abort relay streams and evict engines pinned to the peer
        self._peer_down_hooks: List[Any] = []

        # distributed-AGAS state (root: authoritative; workers: cache only)
        self._table: Dict[_GidKey, Tuple[int, int]] = {}  # key → (owner, gen)
        self._names: Dict[str, _GidKey] = {}
        self._table_lock = threading.Lock()
        self._cache: Dict[_GidKey, Tuple[int, int]] = {}
        self._name_cache: Dict[str, _GidKey] = {}
        self._cache_lock = threading.Lock()

        # parcels execute on the "io" pool (falling back to the default
        # pool on unpartitioned runtimes); help-along keeps blocked actions
        # from wedging it.  Executors are the only sanctioned pool entry.
        self._exec = _executor.get_executor("io", fallback="default")

        reg = _counters.default()
        p = f"/net{{locality#{locality}}}"
        self.c_actions = reg.counter(f"{p}/actions/executed")
        self.c_forwarded = reg.counter(f"{p}/parcels/forwarded")
        self.c_stale = reg.counter(f"{p}/resolutions/stale")
        self.c_cache_hits = reg.counter(f"{p}/resolutions/cache_hits")
        self.c_root_lookups = reg.counter(f"{p}/resolutions/root_lookups")

    # ------------------------------------------------------------- topology
    @property
    def localities(self) -> List[Locality]:
        """Live localities (retired ids are skipped, never reassigned)."""
        return [Locality(i) for i in range(self.n_localities)
                if i not in self._retired]

    def live_ids(self) -> List[int]:
        return [loc.id for loc in self.localities]

    def is_root(self) -> bool:
        return self.locality == ROOT

    def is_live(self, lid: int) -> bool:
        return 0 <= lid < self.n_localities and lid not in self._retired

    def add_peer_down_hook(self, cb) -> None:
        """``cb(lid)`` fires on this locality whenever peer ``lid`` leaves
        the fleet — crash (DOWN broadcast / connection drop) or orderly
        retirement.  May fire more than once per peer; observers must be
        idempotent."""
        self._peer_down_hooks.append(cb)

    def _notify_peer_down(self, lid: int) -> None:
        for cb in list(self._peer_down_hooks):
            try:
                cb(lid)
            except Exception:  # noqa: BLE001 — observers must not break net
                pass

    # ------------------------------------------------------------ send side
    def send_parcel(self, dst: int, action_name: str,
                    target: Optional[_GidKey], args: Tuple[Any, ...] = (),
                    kwargs: Optional[Dict[str, Any]] = None,
                    want_result: bool = True) -> Optional[Future]:
        """One-sided invoke on locality ``dst``: run ``action`` against the
        object at ``target`` (``None`` → the destination's NetRuntime).
        Returns the result Future, or ``None`` for fire-and-forget."""
        if not (0 <= dst < self.n_localities):
            raise ValueError(f"no such locality: {dst}")
        kwargs = kwargs or {}
        promise: Optional[Promise] = Promise() if want_result else None

        if dst == self.locality:  # local shortcut — no wire, no pending slot
            self._exec.post(self._execute_local, action_name, target,
                            args, kwargs, promise)
            return promise.future() if promise else None

        seq = 0
        if want_result:
            seq = next(self._seq)
            with self._pending_lock:
                self._pending[seq] = (promise, dst)

        header = {"t": _pp.PARCEL, "src": self.locality, "dst": dst,
                  "seq": seq, "a": action_name,
                  "g": list(target) if target is not None else None}
        fid = None
        if _trace._enabled:
            # the parcel's trace context: a fresh flow id the receiver uses
            # both as its spans' parent and as the Perfetto flow-arrow id
            fid = _trace.new_id()
            header["tc"] = list(fid)
        try:
            if fid is not None:
                with _trace.span(f"send:{action_name.rsplit('.', 1)[-1]}",
                                 "net", flow_out=fid, dst=dst):
                    self._route_to(dst).send(header, (args, kwargs))
            else:
                self._route_to(dst).send(header, (args, kwargs))
        except BaseException:
            # ANY send-side failure (port closed, unpicklable args,
            # backpressure block timeout) surfaces synchronously — reclaim
            # the pending slot or it leaks for the runtime's lifetime
            if seq:
                with self._pending_lock:
                    self._pending.pop(seq, None)
            raise
        return promise.future() if promise else None

    def _route_to(self, dst: int) -> _pp.Channel:
        conn = self._conns.get(dst)
        if conn is None:
            conn = self._conns.get(ROOT)  # workers reach peers via the root
        if conn is None or conn.closed:
            raise _pp.PortClosed(f"no route to locality#{dst}")
        return conn

    # --------------------------------------------------------- receive side
    def _on_frame(self, fr: _pp.Frame, channel: _pp.Channel) -> None:
        """Progress-thread delivery of one application frame addressed to
        this locality (the port already forwarded, unpacked containers,
        and ran the transport protocols)."""
        header = fr.header
        t = header["t"]
        if t == _pp.PARCEL:
            # decode + execute on the io pool: unpickling user payloads
            # must not stall the progress loop
            self._exec.post(self._handle_parcel, fr)
        elif t == _pp.RESULT:
            # pop BEFORE decoding: a payload that fails to unpickle (e.g.
            # an exception class not importable here) must fail the caller
            # immediately, not leave it blocked until its own timeout
            with self._pending_lock:
                entry = self._pending.pop(header["seq"], None)
            if entry is None:
                return
            promise = entry[0]
            try:
                payload = _pp.decode_payload(header, fr.rest)
            except BaseException as e:  # noqa: BLE001
                promise.set_exception(RuntimeError(
                    f"result from locality#{header.get('src')} could not "
                    f"be decoded: {e!r}"))
                return
            if header.get("ok"):
                promise.set_value(payload)
            else:
                promise.set_exception(payload)
        elif t == _pp.BYE:
            self._stop.set()
        elif t == _pp.DOWN:
            # the root's dead-peer broadcast: in-flight calls to that
            # locality can never complete, nor can rendezvous with it
            peer = header.get("peer")
            if peer is not None:
                with self._topo_lock:
                    self._retired.add(peer)
                self._port.drop_transfers(peer)
                self._fail_pending_for(peer, f"locality#{peer} went away")
                self._notify_peer_down(peer)
        elif t == _pp.TOPO:
            # the root's topology broadcast: the id space grew (elastic
            # join).  FIFO ordering on the root channel guarantees this
            # arrives before any parcel that *mentions* the new locality.
            with self._topo_lock:
                self.n_localities = max(self.n_localities, int(header["n"]))

    def _handle_parcel(self, fr: _pp.Frame) -> None:
        """io-pool side of a received parcel: decode, run, ack credit."""
        header = fr.header
        try:
            payload = _pp.decode_payload(header, fr.rest)
        except BaseException as e:  # noqa: BLE001 — tell the sender
            if header.get("seq"):
                self._send_result(header, None, RuntimeError(
                    f"locality#{self.locality} could not decode parcel "
                    f"args for action {header.get('a')!r}: {e!r}"))
            self._return_credit(header, fr.credit_bytes)
            return
        args, kwargs = payload if payload is not None else ((), {})
        try:
            self._execute_parcel(header, args, kwargs)
        finally:
            # end-to-end flow control: budget bytes flow back only after
            # the parcel *executed* — queue depth here pushes back there
            self._return_credit(header, fr.credit_bytes)

    def _return_credit(self, header: Dict[str, Any], nbytes: int) -> None:
        src = header.get("src", self.locality)
        if nbytes <= 0 or src == self.locality:
            return  # rendezvous-assembled parcels never consumed credit
        try:
            self._route_to(src).send_control(
                {"t": _pp.CREDIT, "src": self.locality, "dst": src,
                 "n": nbytes})
        except _pp.PortClosed:
            pass  # sender is gone; its ledger died with it

    def _forward_failed(self, fr: _pp.Frame) -> None:
        """Root switch could not forward ``fr`` (destination is down):
        bounce an error result to every parcel the frame carried."""
        for h in _pp.failed_parcel_headers(fr):
            if h.get("seq"):
                self._send_result(h, None, _pp.PortClosed(
                    f"locality#{h.get('dst')} is down"))

    def _resolve_target(self, target: Optional[_GidKey]) -> Any:
        if target is None:
            return self
        gid = _agas.GID(*target)
        resolver = _agas.default()
        if not resolver.contains(gid):
            raise UnknownGid(tuple(target), self.locality)
        return resolver.resolve(gid)

    def _execute_parcel(self, header: Dict[str, Any], args: Tuple[Any, ...],
                        kwargs: Dict[str, Any]) -> None:
        """Run one decoded parcel on a pool worker; reply if a result is
        wanted.  Never raises — failures travel back as result frames."""
        if _trace._enabled:
            # adopt the sender's trace context: this span (and everything
            # the action does) records the parcel as its parent, and the
            # flow-finish here matches the sender's flow-start
            tc = header.get("tc")
            fid = tuple(tc) if tc else None
            action = str(header.get("a", "?")).rsplit(".", 1)[-1]
            with _trace.with_context(fid), \
                    _trace.span(f"execute:{action}", "net", flow_in=fid,
                                src=header.get("src", -1)):
                self._execute_parcel_body(header, args, kwargs)
        else:
            self._execute_parcel_body(header, args, kwargs)

    def _execute_parcel_body(self, header: Dict[str, Any],
                             args: Tuple[Any, ...],
                             kwargs: Dict[str, Any]) -> None:
        try:
            target = header.get("g")
            obj = self._resolve_target(tuple(target) if target else None)
            fn = _parcel._registry.resolve(header["a"])
            value, exc = fn(obj, *args, **kwargs), None
            self.c_actions.increment()
        except BaseException as e:  # noqa: BLE001 — ship it back
            value, exc = None, e
            if isinstance(e, UnknownGid):
                self.c_stale.increment()
        if header.get("seq"):
            self._send_result(header, value, exc)
        elif exc is not None:
            import traceback

            traceback.print_exception(type(exc), exc, exc.__traceback__)

    def _execute_local(self, action_name: str, target: Optional[_GidKey],
                       args: Tuple[Any, ...], kwargs: Dict[str, Any],
                       promise: Optional[Promise]) -> None:
        try:
            obj = self._resolve_target(target)
            fn = _parcel._registry.resolve(action_name)
            value = fn(obj, *args, **kwargs)
            self.c_actions.increment()
            if promise is not None:
                promise.set_value(value)
        except BaseException as e:  # noqa: BLE001
            if promise is not None:
                promise.set_exception(e)

    def _send_result(self, req_header: Dict[str, Any], value: Any,
                     exc: Optional[BaseException]) -> None:
        reply = {"t": _pp.RESULT, "src": self.locality,
                 "dst": req_header["src"], "seq": req_header["seq"],
                 "ok": exc is None}
        try:
            if req_header["src"] == self.locality:
                raise _pp.PortClosed("result loop")  # unreachable by design
            # the channel picks the tier: big results (fetch of a large
            # array) take the rendezvous/striped path like any bulk parcel,
            # and unpicklable outcomes degrade to a picklable RuntimeError
            self._route_to(req_header["src"]).send(
                reply, value if exc is None else exc)
        except _pp.PortClosed:
            pass  # requester is gone; nothing to tell

    # ------------------------------------------------ distributed AGAS tier
    # Root-side authoritative table.  Workers call these through the
    # _root_* actions in repro_torch.net.remote; the root's own AGAS hook calls
    # them directly (no wire hop at the root).
    def publish_local(self, key: _GidKey, owner: int, generation: int,
                      name: Optional[str]) -> int:
        with self._table_lock:
            cur = self._table.get(key)
            if cur is not None and cur[1] > generation:
                return cur[1]  # stale publish raced a newer one: keep newest
            self._table[key] = (owner, generation)
            if name is not None:
                self._names[name] = key
            return generation

    def unpublish_local(self, key: _GidKey, owner: int) -> bool:
        """Drop ``key`` only while ``owner`` still owns it (an unregister
        racing a migration must not erase the new owner's entry)."""
        with self._table_lock:
            cur = self._table.get(key)
            if cur is None or cur[0] != owner:
                return False
            del self._table[key]
            for n, k in list(self._names.items()):
                if k == key:
                    del self._names[n]
            return True

    def lookup_local(self, key: _GidKey) -> Tuple[int, int]:
        with self._table_lock:
            cur = self._table.get(key)
        if cur is None:
            raise UnknownGid(tuple(key), self.locality)
        return cur

    def lookup_name_local(self, name: str) -> _GidKey:
        with self._table_lock:
            key = self._names.get(name)
        if key is None:
            raise KeyError(f"AGAS root: name not published: {name!r}")
        return key

    # Per-locality resolution cache (generation-based invalidation).
    def cache_get(self, key: _GidKey) -> Optional[Tuple[int, int]]:
        with self._cache_lock:
            hit = self._cache.get(key)
        if hit is not None:
            self.c_cache_hits.increment()
        return hit

    def cache_put(self, key: _GidKey, owner: int, generation: int) -> None:
        with self._cache_lock:
            cur = self._cache.get(key)
            if cur is None or generation >= cur[1]:
                self._cache[key] = (owner, generation)

    def cache_invalidate(self, key: _GidKey) -> None:
        with self._cache_lock:
            self._cache.pop(key, None)
            for name, k in list(self._name_cache.items()):
                if k == key:
                    del self._name_cache[name]

    def name_cache_get(self, name: str) -> Optional[_GidKey]:
        with self._cache_lock:
            return self._name_cache.get(name)

    def name_cache_put(self, name: str, key: _GidKey) -> None:
        with self._cache_lock:
            self._name_cache[name] = key

    # ------------------------------------------------------------ AGAS hook
    def _agas_hook(self, event: str, rec: _agas.AgasRecord) -> None:
        """Publish local AGAS mutations to the root table.

        Counter registrations (names under ``/counters``) stay local —
        they are read remotely via the counter-snapshot action instead of
        being mirrored (thousands of entries, zero cross-process readers
        of the *objects*)."""
        name = rec.name
        if name is not None and name.startswith("/counters"):
            return
        from repro_torch.net import remote as _remote

        key = _gid_key(rec.gid)
        if event in ("register", "rebind"):
            if self.is_root():
                self.publish_local(key, self.locality, rec.generation, name)
            else:
                self.send_parcel(ROOT, _remote.ROOT_PUBLISH, None,
                                 (list(key), self.locality, rec.generation,
                                  name)).get(timeout=60)
        elif event == "unregister":
            if self.is_root():
                self.unpublish_local(key, self.locality)
            else:
                self.send_parcel(ROOT, _remote.ROOT_UNPUBLISH, None,
                                 (list(key), self.locality),
                                 want_result=False)

    def _install(self) -> None:
        _agas.default().add_hook(self._agas_hook)
        self._hook_installed = True
        from repro_torch.net import remote as _remote

        _parcel.set_remote_route(lambda p: _remote.route_parcel(self, p))
        _set_current(self)
        # publish objects registered before the net came up (root only
        # mutates its own table; workers usually boot before registering)
        for rec in _agas.default():
            self._agas_hook("register", rec)

    # ------------------------------------------------------ elastic topology
    def spawn_locality(self, pools: Optional[Dict[str, int]] = None,
                       timeout: float = 120.0) -> int:
        """Grow the fleet: spawn one new worker locality into the *running*
        runtime (root only).  The worker gets the next never-used id, dials
        home exactly like bootstrap (HELLO per lane), and every existing
        worker learns the enlarged id space through a TOPO broadcast that
        FIFO-precedes any parcel mentioning the newcomer.  Returns the new
        locality id."""
        if not self.is_root():
            raise RuntimeError("spawn_locality is root-only")
        import multiprocessing as _mp

        with self._topo_lock:
            lid = self.n_localities
            self.n_localities = lid + 1
        cfg = self.config
        nlanes = 1 + max(0, cfg.stripes)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", 0))
        listener.listen(nlanes)
        listener.settimeout(timeout)
        port = listener.getsockname()[1]

        ctx = _mp.get_context("spawn")
        proc = ctx.Process(
            target=_worker_main,
            args=(lid, lid + 1, port,
                  dict(pools) if pools else None, cfg),
            daemon=True, name=f"repro-locality-{lid}")
        proc.start()
        half_open: Dict[int, Dict[int, socket.socket]] = {}
        try:
            _accept_worker_lanes(self, listener, 1, nlanes, timeout,
                                 half_open)
        except BaseException as e:
            for lanes in half_open.values():
                for s in lanes.values():
                    try:
                        s.close()
                    except OSError:
                        pass
            proc.terminate()
            proc.join(timeout=5.0)
            with self._topo_lock:
                self._retired.add(lid)  # the id is burned, not reusable
            if isinstance(e, (OSError, socket.timeout)):
                raise RuntimeError(
                    f"spawn_locality: locality#{lid} failed to dial home "
                    f"within {timeout}s") from e
            raise
        finally:
            listener.close()
        self._procs[lid] = proc
        # existing workers must accept parcels addressed to the newcomer
        # before anything can mention it — TOPO rides the same FIFO channel
        for dst, conn in list(self._conns.items()):
            if dst == lid or conn.closed:
                continue
            try:
                conn.send({"t": _pp.TOPO, "src": self.locality, "dst": dst,
                           "seq": 0, "n": self.n_localities})
            except _pp.PortClosed:
                pass
        return lid

    def retire_locality(self, lid: int, timeout: float = 30.0) -> None:
        """Shrink the fleet: orderly shutdown of one worker locality (root
        only).  The caller is responsible for *draining* first — migrating
        or completing everything the locality owns; this layer fails any
        still-pending calls, BYEs the worker, reaps the process, purges its
        entries from the root AGAS table, and broadcasts DOWN so peers drop
        rendezvous state.  The id is never reused."""
        if not self.is_root():
            raise RuntimeError("retire_locality is root-only")
        if lid == ROOT:
            raise ValueError("cannot retire the root locality")
        if not self.is_live(lid):
            raise ValueError(f"locality#{lid} is not live")
        with self._topo_lock:
            self._expect_down.add(lid)
            self._retired.add(lid)
        conn = self._conns.get(lid)
        if conn is not None and not conn.closed:
            try:
                conn.send({"t": _pp.BYE, "src": self.locality, "dst": lid,
                           "seq": 0})
            except _pp.PortClosed:
                pass
            self._port.flush(timeout=min(timeout, 10.0))
        proc = self._procs.pop(lid, None)
        if proc is not None:
            proc.join(timeout=timeout)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
        self._fail_pending_for(lid, f"locality#{lid} retired")
        self._port.drop_transfers(lid)
        self._notify_peer_down(lid)
        # purge everything the dead locality still owned from the root
        # table: resolvers must get UnknownGid, not a route to a ghost
        with self._table_lock:
            doomed = [k for k, (owner, _g) in self._table.items()
                      if owner == lid]
            for k in doomed:
                del self._table[k]
                for n, key in list(self._names.items()):
                    if key == k:
                        del self._names[n]
        for k in doomed:
            self.cache_invalidate(k)
        for dst, other in list(self._conns.items()):
            if dst == lid or other.closed:
                continue
            try:
                other.send({"t": _pp.DOWN, "src": self.locality, "dst": dst,
                            "seq": 0, "peer": lid})
            except _pp.PortClosed:
                pass

    # ------------------------------------------------------------- shutdown
    def shutdown(self, timeout: float = 30.0) -> None:
        """Tear down the net: BYE every worker, join processes, uninstall."""
        if self.is_root():
            for dst, conn in list(self._conns.items()):
                if not conn.closed:
                    try:
                        conn.send({"t": _pp.BYE, "src": self.locality,
                                   "dst": dst, "seq": 0})
                    except _pp.PortClosed:
                        pass
            # the BYE (and anything coalesced ahead of it) must hit the
            # wire before the workers are reaped
            self._port.flush(timeout=min(timeout, 10.0))
            for proc in self._procs.values():
                proc.join(timeout=timeout)
            for proc in self._procs.values():
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=5.0)
        self._port.close()
        if self._hook_installed:
            _agas.default().remove_hook(self._agas_hook)
            self._hook_installed = False
        _parcel.set_remote_route(None)
        with self._pending_lock:
            pending, self._pending = dict(self._pending), {}
        for promise, _dst in pending.values():
            try:
                promise.set_exception(_pp.PortClosed("net runtime shut down"))
            except Exception:  # noqa: BLE001 — already completed
                pass
        _clear_current(self)

    def _fail_pending_for(self, dst: Optional[int], reason: str) -> None:
        """Fail in-flight calls that can no longer complete (``None`` =
        every destination — the worker losing its root link)."""
        with self._pending_lock:
            doomed = [seq for seq, (_p, d) in self._pending.items()
                      if dst is None or d == dst]
            entries = [self._pending.pop(seq) for seq in doomed]
        for promise, _d in entries:
            try:
                promise.set_exception(_pp.PortClosed(reason))
            except Exception:  # noqa: BLE001 — already completed
                pass

    def _on_conn_close(self, conn: _pp.Channel) -> None:
        if not self.is_root() and conn.peer_id == ROOT:
            # root went away: nothing in flight can ever complete
            self._fail_pending_for(None, "lost connection to the root")
            self._notify_peer_down(ROOT)
            self._stop.set()
        elif self.is_root():
            # a worker died: fail fast the calls routed to it (new sends
            # already raise PortClosed synchronously) and broadcast DOWN so
            # the other workers fail their worker↔worker calls too.  An
            # orderly retirement (retire_locality) already did all of this
            # before the connection dropped — don't re-broadcast.
            dead = conn.peer_id
            with self._topo_lock:
                expected = dead in self._expect_down
                self._retired.add(dead)
            if expected:
                return
            self._fail_pending_for(dead, f"locality#{dead} went away")
            self._notify_peer_down(dead)
            for dst, other in list(self._conns.items()):
                if other is conn or other.closed:
                    continue
                try:
                    other.send({"t": _pp.DOWN, "src": self.locality,
                                "dst": dst, "seq": 0, "peer": dead})
                except _pp.PortClosed:
                    pass


# ------------------------------------------------------------ current() api
_current: Optional[NetRuntime] = None
_current_lock = threading.Lock()


def _set_current(net: NetRuntime) -> None:
    global _current
    with _current_lock:
        if _current is not None:
            raise RuntimeError("a multi-locality runtime is already up")
        _current = net


def _clear_current(net: NetRuntime) -> None:
    global _current
    with _current_lock:
        if _current is net:
            _current = None


def current() -> Optional[NetRuntime]:
    return _current


def require() -> NetRuntime:
    net = current()
    if net is None:
        raise RuntimeError(
            "no multi-locality runtime: call repro_torch.net.bootstrap(n) first")
    return net


# ---------------------------------------------------------------- bootstrap
def _accept_worker_lanes(net: NetRuntime, listener: socket.socket,
                         n_workers: int, nlanes: int, timeout: float,
                         half_open: Dict[int, Dict[int, socket.socket]]
                         ) -> None:
    """Accept ``n_workers × nlanes`` HELLO-stamped sockets and register one
    channel per worker as its lane set completes (bootstrap and elastic
    join share this).  ``half_open`` is caller-owned so a failure can close
    partially-dialed lanes."""
    for _ in range(n_workers * nlanes):
        sock, _addr = listener.accept()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(timeout)  # bounded handshake read
        frame = _pp.read_frame(sock)
        header, _ = _pp.decode_frame(frame)
        if header["t"] != _pp.HELLO:
            raise RuntimeError(f"expected HELLO, got {header['t']!r}")
        if header.get("nl", 1) != nlanes:
            raise RuntimeError(
                f"lane-count mismatch: worker {header['src']} dialed "
                f"{header.get('nl')} lanes, root expects {nlanes}")
        peer, lane = header["src"], header.get("lane", 0)
        sock.settimeout(None)
        lanes = half_open.setdefault(peer, {})
        lanes[lane] = sock
        if len(lanes) == nlanes:
            del half_open[peer]
            net._conns[peer] = net._port.add_channel(
                peer, [lanes[i] for i in range(nlanes)])


def bootstrap(n_localities: int, pools: Optional[Dict[str, int]] = None,
              worker_pools: Optional[Dict[str, int]] = None,
              timeout: float = 120.0,
              config: Optional[_pp.NetConfig] = None) -> NetRuntime:
    """Bring up an ``n_localities``-process runtime; the caller becomes
    locality 0 (AGAS root).  Returns the root :class:`NetRuntime`.

    ``pools`` partitions the *root* scheduler (``core.init`` semantics),
    ``worker_pools`` every worker's; ``config`` tunes the transport tier
    (defaults to :meth:`NetConfig.from_env`) and is shipped to every
    worker so both ends agree on thresholds and lane counts.  Workers are
    spawned (never forked) so no live thread or lock state is duplicated;
    each worker imports the stack fresh, pins its AGAS locality id, and
    dials home with one socket per lane.
    """
    import multiprocessing as _mp

    import repro_torch.core as core

    if n_localities < 1:
        raise ValueError("need at least one locality")
    core.init(pools=pools)
    net = NetRuntime(ROOT, n_localities, config=config)
    if n_localities == 1:  # degenerate but useful: uniform API, no workers
        net._install()
        return net
    cfg = net.config
    nlanes = 1 + max(0, cfg.stripes)

    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", 0))
    listener.listen((n_localities - 1) * nlanes)
    listener.settimeout(timeout)
    port = listener.getsockname()[1]

    ctx = _mp.get_context("spawn")
    for lid in range(1, n_localities):
        proc = ctx.Process(target=_worker_main,
                           args=(lid, n_localities, port, worker_pools, cfg),
                           daemon=True, name=f"repro-locality-{lid}")
        proc.start()
        net._procs[lid] = proc

    half_open: Dict[int, Dict[int, socket.socket]] = {}
    try:
        _accept_worker_lanes(net, listener, n_localities - 1, nlanes,
                             timeout, half_open)
    except BaseException as e:
        # ANY handshake failure (timeout, stray client sending garbage,
        # corrupt frame) must reap the already-spawned workers — they would
        # otherwise idle for the parent's lifetime
        for lanes in half_open.values():
            for s in lanes.values():
                try:
                    s.close()
                except OSError:
                    pass
        net.shutdown()
        if isinstance(e, (OSError, socket.timeout)):
            raise RuntimeError(
                f"bootstrap: workers failed to dial home within "
                f"{timeout}s") from e
        raise
    finally:
        listener.close()
    net._install()
    return net


import contextlib


@contextlib.contextmanager
def running(n_localities: int, pools: Optional[Dict[str, int]] = None,
            worker_pools: Optional[Dict[str, int]] = None,
            timeout: float = 120.0,
            config: Optional[_pp.NetConfig] = None):
    """Leak-proof bootstrap: ``with net.running(3) as n: ...`` guarantees
    worker-process teardown even when the body raises — a failing
    multi-locality test cannot strand processes and poison later tests.
    (``bootstrap`` itself already reaps workers on handshake failure; this
    covers everything *after* a successful bootstrap.)"""
    net = bootstrap(n_localities, pools=pools, worker_pools=worker_pools,
                    timeout=timeout, config=config)
    try:
        yield net
    finally:
        net.shutdown()


def _worker_main(locality_id: int, n_localities: int, port: int,
                 pools: Optional[Dict[str, int]],
                 config: Optional[_pp.NetConfig] = None) -> None:
    """Entry point of a worker locality (runs in the spawned process)."""
    from repro_torch.core import agas as agas_mod

    agas_mod.set_default_locality(locality_id)
    import repro_torch.core as core

    core.init(pools=dict(pools) if pools else {"default": 2, "io": 1})
    net = NetRuntime(locality_id, n_localities, config=config)
    nlanes = 1 + max(0, net.config.stripes)
    socks: List[socket.socket] = []
    for lane in range(nlanes):
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        sock.settimeout(None)  # connect timeout only — idle wire is healthy
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # HELLO must be the first frame on each socket: send it raw, before
        # the port owns the socket, so the root's handshake read can't race;
        # it also tells the root which lane slot this socket fills.
        for chunk in _pp.encode_frame({"t": _pp.HELLO, "src": locality_id,
                                       "dst": ROOT, "seq": 0, "lane": lane,
                                       "nl": nlanes}):
            sock.sendall(chunk)
        socks.append(sock)
    net._conns[ROOT] = net._port.add_channel(ROOT, socks)
    net._install()
    net._stop.wait()
    net.shutdown()
    core.finalize()
    os._exit(0)  # skip atexit: daemon threads are already winding down
