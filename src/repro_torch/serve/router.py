"""Multi-engine router: SLO-tiered, fault-tolerant least-loaded dispatch
over local *and remote* engine replicas, ported from the reference's
``serve/router.py``.

Each :class:`~repro_torch.serve.engine.Engine` replica owns its own cache
(a page pool or dense slots, as its ``ServeConfig`` and family choose),
decode continuation chain and performance counters; the router is the
only coordination point and dispatches each request to the least loaded
replica — no messages, no global queue.  Local engines publish
``submitted - completed`` counters; a :class:`RemoteEngine` (an engine on
another locality, built there by :func:`build_engine` through
``over_localities``) keeps a load estimate from this router's own
in-flight submissions and the load **and KV-page occupancy** its locality
gossips back on every completion parcel.  On top of that, as in the
reference:

- **SLO tiers** — engines carry a tier label (``interactive`` / ``batch``
  / untiered); ``submit(..., slo=...)`` prefers same-tier engines, then
  untiered ones, then anything alive.  Batch submits also pass the
  ``admission`` gate when one is installed
  (:class:`repro_torch.fleet.slo.AdmissionController`); gated requests
  park in a FIFO until ``release_gated``.
- **Failover** — an engine that fails a request with a ``ConnectionError``
  (:class:`~repro_torch.net.parcelport.PortClosed` is one: the replica's
  locality is gone) is evicted and the request retried on a healthy peer,
  at most ``max_failover`` times; an ``UnknownGid`` (an engine mid
  migration outlived the resolver's retries) is retried without eviction.
  A streamed request that already delivered tokens comes back as
  :class:`~repro_torch.serve.relay.StreamBroken` and is never re-run.  Any
  other failure is the request's own and is delivered to the caller.
- **Membership** — ``add_engine`` / ``remove_engine`` / ``suspend`` /
  ``resume`` / ``revive`` on a running router (spawn, drain, migrate).

Counters::

    /serve{router}/requests/dispatched           cumulative
    /serve{router}/dispatch/<engine-name>        cumulative per replica
    /serve{router}/load/<engine-name>            gauge, gossiped (remote)
    /serve{router}/failover/{evicted,retried,exhausted}   cumulative
    /serve{router}/admission/{gated,released}    cumulative
    /serve{router}/admission/depth               gauge
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import parcel as _parcel
from repro_torch.core.future import Channel, Future, Promise
from repro_torch.models.model import Model
from repro_torch.obs import trace as _trace
from repro_torch.serve.engine import Engine, SamplingParams, ServeConfig

ENGINE_NAME_PREFIX = "/engines/"

# SLO tier labels (re-exported by repro_torch.fleet.slo — defined here so
# the serve layer never imports the fleet layer)
TIER_INTERACTIVE = "interactive"
TIER_BATCH = "batch"


def engine_name(e: Any) -> str:
    """Display/counter name of a local Engine or RemoteEngine handle."""
    name = getattr(e, "name", None)
    return name if name is not None else e.scfg.name


def default_extra_inputs(cfg, device: Optional[Union[str, torch.device]] = None
                         ) -> Dict[str, Any]:
    """Family-dependent synthetic side inputs, as the reference's: the vlm
    family's ``patches`` (zeros (1, n_patches, D) bf16), the encdec
    family's encoder frames ``enc`` (zeros (1, 64, D) bf16) with their
    count ``enc_len``; none for the other families.  The tensors are made
    on ``device`` (``cuda`` unless the caller asks for the CPU), where the
    engine lives."""
    extra: Dict[str, Any] = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.zeros((1, cfg.n_patches, cfg.d_model),
                                       dtype=torch.bfloat16, device=resolve_device(device))
    if cfg.family == "encdec":
        extra["enc"] = torch.zeros((1, 64, cfg.d_model), dtype=torch.bfloat16,
                                   device=resolve_device(device))
        extra["enc_len"] = 64
    return extra


def build_engine(arch: str, smoke: bool, scfg_kwargs: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: Optional[str] = None) -> Engine:
    """The one engine-construction recipe every locality uses.

    Params come from the shared init seed (``init_compute(0)``, on this
    locality's own ``device``), so replicas built here are identical on
    every locality without ever moving weights — the greedy-parity
    guarantee depends on local and remote spawns sharing this exact path.
    Live migration depends on it too: the destination stages an identical
    engine shell and only the KV pages and request state travel.
    ``dtype`` overrides the config's compute dtype (``float32`` for the
    CPU's parity runs)."""
    from dataclasses import replace

    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=smoke)
    if dtype is not None:
        cfg = replace(cfg, dtype=dtype)
    model = Model(cfg, device=device)
    params = model.init_compute(0)
    return Engine(model, params, ServeConfig(**scfg_kwargs),
                  extra_inputs=default_extra_inputs(cfg, model.device),
                  device=model.device)


# ----------------------------------------------------------- remote actions
@_parcel.action
def _spawn_engine(rt, arch: str, smoke: bool, scfg_kwargs: Dict[str, Any],
                  device: Optional[str] = None,
                  dtype: Optional[str] = None) -> List[int]:
    """Build a full engine at this locality and register it in AGAS; the
    returned GID key is what the root's :class:`RemoteEngine` targets."""
    from repro_torch.net.locality import _gid_key

    engine = build_engine(arch, smoke, scfg_kwargs, device, dtype)
    gid = _agas.default().register(
        engine, name=f"{ENGINE_NAME_PREFIX}{engine.scfg.name}")
    return list(_gid_key(gid))


@_parcel.action
def _engine_submit(engine: Engine, prompt: List[int], max_new: Optional[int],
                   sampling: Optional[SamplingParams]
                   ) -> Tuple[List[int], float]:
    """Blocking submit at the engine's locality (help-along keeps the pool
    live); returns ``(tokens, load)``.  The fleet path uses the
    non-blocking :func:`repro_torch.serve.relay._fleet_submit` instead —
    this remains the minimal one-shot spelling."""
    tokens = engine.submit(prompt, max_new, sampling).get(timeout=600)
    return tokens, engine.load()


class RemoteEngine:
    """Router-side handle to an engine living on another locality.

    ``load()`` needs no wire traffic: it is the max of this router's own
    in-flight count and the engine-side load gossiped back on the last
    completion parcel (both local reads — zero-message dispatch).  The
    same parcel carries the engine's KV-page occupancy, which is what the
    fleet admission controller reads — "gossiped occupancy", not a poll.

    Submits ride the relay (:mod:`repro_torch.serve.relay`): the ack
    parcel is gid-targeted, so after a live migration the UnknownGid retry
    re-routes it to the engine's new home without this handle doing
    anything — ``locality`` is then updated by the migration
    coordinator."""

    def __init__(self, net, locality: int, gid: _agas.GID, name: str):
        self.net = net
        self.locality = locality
        self.gid = gid
        self.name = name
        self._inflight = 0
        self._gossip = 0.0
        self._occ = 0.0
        self._lock = threading.Lock()
        self._c_load = _counters.default().gauge(
            f"/serve{{router}}/load/{name}")

    def submit(self, prompt: List[int], max_new: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               stream: Optional[Channel] = None,
               meta: Optional[Dict[str, Any]] = None) -> Future:
        from repro_torch.net import remote as _remote
        from repro_torch.serve import relay as _relay

        promise: Promise = Promise()

        def on_result(ok: bool, payload: Any,
                      gossip: Optional[Dict[str, float]]) -> None:
            with self._lock:
                self._inflight -= 1
                if gossip:
                    self._gossip = float(gossip.get("load", 0.0))
                    self._occ = float(gossip.get("occ", self._occ))
                if self._inflight == 0:
                    # done-parcels execute on the io pool and can apply out
                    # of order; with nothing outstanding from this (sole)
                    # client, any gossiped load is stale — truth is zero
                    self._gossip = 0.0
                self._c_load.set(self._gossip)
            if ok:
                promise.set_value(payload)
            else:
                promise.set_exception(payload)

        sid = _relay.open_sink(self.net, stream, self.locality, on_result)
        with self._lock:
            self._inflight += 1
        meta = meta or {}
        ack = _remote.apply_remote(_relay._fleet_submit, self.gid,
                                   list(prompt), max_new, sampling,
                                   self.net.locality, sid,
                                   stream is not None,
                                   meta.get("req"), meta.get("slo"))

        def acked(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                # the engine never accepted the request: fail/abort the
                # sink (idempotent — a no-op if a done-parcel landed first)
                _relay.abort(sid, exc)

        ack.on_ready(acked)
        return promise.future()

    def submit_stream(self, prompt: List[int],
                      max_new: Optional[int] = None,
                      sampling: Optional[SamplingParams] = None
                      ) -> Tuple[Channel, Future]:
        ch: Channel = Channel()
        return ch, self.submit(prompt, max_new, sampling, stream=ch)

    def load(self) -> float:
        with self._lock:
            return float(max(self._gossip, self._inflight))

    def occupancy(self) -> float:
        with self._lock:
            return self._occ


class Router:
    def __init__(self, engines: List[Any],
                 tiers: Optional[Dict[str, Optional[str]]] = None):
        if not engines:
            raise ValueError("router needs at least one engine")
        self.engines = list(engines)
        self._tiers: Dict[str, Optional[str]] = {
            engine_name(e): (tiers or {}).get(engine_name(e))
            for e in engines
        }
        self._dead: set = set()       # evicted by failover
        self._suspended: set = set()  # mid-migration: no new dispatch
        self._lock = threading.Lock()
        # construction recipe (over_localities): what migration staging and
        # elastic growth need to build an identical engine elsewhere
        self.spec: Optional[Dict[str, Any]] = None
        # admission gate (AdmissionController-alike with .allow());
        # absent → batch is never gated
        self.admission: Optional[Any] = None
        self.max_failover = 2
        self._gated: deque = deque()
        # request tags ("r<locality>:<seq>") stamped into every span the
        # request touches — the critical-path join key
        self._req_seq = itertools.count(1)

        reg = _counters.default()
        self.c_dispatched = reg.counter("/serve{router}/requests/dispatched")
        self._c_dispatch: Dict[str, Any] = {}
        for e in engines:
            self._dispatch_counter(engine_name(e))
        self.c_evicted = reg.counter("/serve{router}/failover/evicted")
        self.c_retried = reg.counter("/serve{router}/failover/retried")
        self.c_exhausted = reg.counter("/serve{router}/failover/exhausted")
        self.c_gated = reg.counter("/serve{router}/admission/gated")
        self.c_released = reg.counter("/serve{router}/admission/released")
        self.g_gate_depth = reg.gauge("/serve{router}/admission/depth")

    def _dispatch_counter(self, name: str):
        c = self._c_dispatch.get(name)
        if c is None:
            c = _counters.default().counter(
                f"/serve{{router}}/dispatch/{name}")
            self._c_dispatch[name] = c
        return c

    # ------------------------------------------------------------- factory
    @classmethod
    def replicate(cls, model: Model, params: Dict[str, torch.Tensor],
                  scfg: ServeConfig, replicas: int,
                  extra_inputs: Optional[Dict[str, Any]] = None,
                  device: Optional[Union[str, torch.device]] = None) -> "Router":
        """N engine replicas named ``engine#0..N-1`` over shared params.
        The compute-dtype copy of the params is made once, here, and shared."""
        shared = model.compute_params(params)
        engines = [Engine(model, shared,
                          ServeConfig(**{**scfg.__dict__, "name": f"engine#{i}"}),
                          extra_inputs=extra_inputs, device=device)
                   for i in range(replicas)]
        return cls(engines)

    @classmethod
    def over_localities(cls, net, arch: str, scfg: ServeConfig,
                        smoke: bool = True, timeout: float = 600.0,
                        tiers: Optional[Dict[str, Optional[str]]] = None,
                        device: Optional[str] = None,
                        dtype: Optional[str] = None) -> "Router":
        """One engine per locality: a local Engine at this locality, a
        :class:`RemoteEngine` handle per worker locality (spawned through
        ``run_on`` — the engine is built *where it runs*, by the same
        :func:`build_engine` recipe, all localities at once).  ``device``
        (``None`` = ``cuda``) and ``dtype`` (``None`` = the config's)
        travel in ``router.spec`` with the rest of the recipe."""
        from repro_torch.net import remote as _remote

        spawns = []
        for loc in range(net.n_localities):
            if loc == net.locality:
                continue
            name = f"engine#{loc}"
            spawns.append((loc, name, _remote.run_on(
                loc, _spawn_engine, arch, smoke,
                {**scfg.__dict__, "name": name}, device, dtype)))

        engines: List[Any] = [build_engine(
            arch, smoke, {**scfg.__dict__, "name": f"engine#{net.locality}"},
            device, dtype)]
        for loc, name, fut in spawns:
            key = fut.get(timeout=timeout)
            engines.append(RemoteEngine(net, loc, _agas.GID(*key), name))
        router = cls(engines, tiers=tiers)
        router.spec = {"arch": arch, "smoke": smoke, "device": device,
                       "dtype": dtype, "scfg_kwargs": dict(scfg.__dict__)}
        return router

    # ---------------------------------------------------------- membership
    def engine(self, name: str) -> Any:
        for e in self.engines:
            if engine_name(e) == name:
                return e
        raise KeyError(f"no engine named {name!r}")

    def add_engine(self, e: Any, tier: Optional[str] = None) -> None:
        """Admit a replica into a *running* router (elastic growth)."""
        name = engine_name(e)
        self._dispatch_counter(name)
        with self._lock:
            self.engines = [x for x in self.engines
                            if engine_name(x) != name] + [e]
            self._tiers[name] = tier
            self._dead.discard(name)
            self._suspended.discard(name)

    def remove_engine(self, name: str) -> Optional[Any]:
        """Take a replica out of dispatch (retirement drain starts here)."""
        with self._lock:
            found = next((e for e in self.engines
                          if engine_name(e) == name), None)
            self.engines = [e for e in self.engines
                            if engine_name(e) != name]
            self._tiers.pop(name, None)
            self._dead.discard(name)
            self._suspended.discard(name)
        return found

    def set_tier(self, name: str, tier: Optional[str]) -> None:
        with self._lock:
            self._tiers[name] = tier

    def tier_of(self, name: str) -> Optional[str]:
        with self._lock:
            return self._tiers.get(name)

    def suspend(self, name: str) -> None:
        """Stop dispatching to an engine without removing it (the
        migration cutover window)."""
        with self._lock:
            self._suspended.add(name)

    def resume(self, name: str) -> None:
        with self._lock:
            self._suspended.discard(name)

    def _evict(self, name: str) -> None:
        with self._lock:
            if name in self._dead:
                return
            self._dead.add(name)
        self.c_evicted.increment()

    def revive(self, name: str) -> None:
        with self._lock:
            self._dead.discard(name)

    # ------------------------------------------------------------ dispatch
    def loads(self) -> List[float]:
        return [e.load() for e in self.engines]

    def occupancy(self) -> float:
        """Max live-engine KV occupancy: local engines read directly,
        remote ones report what their locality last gossiped.  This is
        the fleet admission signal — zero extra messages."""
        occs = []
        with self._lock:
            engines = [e for e in self.engines
                       if engine_name(e) not in self._dead]
        for e in engines:
            try:
                occs.append(float(e.occupancy()))
            except Exception:  # noqa: BLE001 — engine mid-teardown
                pass
        return max(occs) if occs else 0.0

    def pick(self, local_only: bool = False,
             slo: Optional[str] = None) -> int:
        """Least-loaded replica (first wins ties — stable under no load).

        ``slo``: prefer engines labeled with that tier; fall back to
        untiered engines, then to anything alive — a tier label steers,
        it never strands a request.  ``local_only`` restricts to
        in-process engines."""
        with self._lock:
            dead = set(self._dead) | set(self._suspended)
            tiers = dict(self._tiers)
            engines = list(self.engines)
        candidates = [i for i, e in enumerate(engines)
                      if engine_name(e) not in dead
                      and not (local_only and isinstance(e, RemoteEngine))]
        if not candidates:
            raise ValueError("no engine available for dispatch")
        if slo is not None:
            same = [i for i in candidates
                    if tiers.get(engine_name(engines[i])) == slo]
            neutral = [i for i in candidates
                       if tiers.get(engine_name(engines[i])) is None]
            candidates = same or neutral or candidates
        loads = [engines[i].load() for i in candidates]
        return candidates[loads.index(min(loads))]

    def new_tag(self) -> str:
        """Request tag ``r<locality>:<seq>``: the one id joining every
        span and async event a request touches."""
        return f"r{_trace._detect_locality()}:{next(self._req_seq)}"

    def submit(self, prompt: List[int], max_new: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               stream: Optional[Channel] = None,
               slo: Optional[str] = None) -> Future:
        promise: Promise = Promise()
        tag = self.new_tag()
        if (slo == TIER_BATCH and self.admission is not None
                and not self.admission.allow()):
            # backpressure by occupancy, not queue depth: park until
            # release_gated
            with self._lock:
                self._gated.append((list(prompt), max_new, sampling, stream,
                                    slo, promise, tag))
                depth = len(self._gated)
            self.c_gated.increment()
            self.g_gate_depth.set(float(depth))
            if _trace._enabled:
                # the analyzer reads this instant as the start of the
                # request's Waiting (admission-gate) interval
                _trace.instant("router/gated", "serve", req=tag, slo=slo,
                               depth=depth)
            return promise.future()
        self._dispatch(list(prompt), max_new, sampling, stream, slo,
                       promise, 0, tag=tag)
        return promise.future()

    def release_gated(self, limit: Optional[int] = None) -> int:
        """Dispatch parked batch requests while the admission gate allows.
        Returns how many moved."""
        n = 0
        while limit is None or n < limit:
            if self.admission is not None and not self.admission.allow():
                break
            with self._lock:
                if not self._gated:
                    break
                prompt, max_new, sampling, stream, slo, promise, tag = \
                    self._gated.popleft()
                depth = len(self._gated)
            self.c_released.increment()
            self.g_gate_depth.set(float(depth))
            self._dispatch(prompt, max_new, sampling, stream, slo,
                           promise, 0, tag=tag, gated=True)
            n += 1
        return n

    def gated_depth(self) -> int:
        with self._lock:
            return len(self._gated)

    def _dispatch(self, prompt: List[int], max_new: Optional[int],
                  sampling: Optional[SamplingParams],
                  stream: Optional[Channel], slo: Optional[str],
                  promise: Promise, attempt: int,
                  tag: Optional[str] = None, gated: bool = False) -> None:
        try:
            i = self.pick(slo=slo)
        except ValueError as e:
            self._terminal(stream, promise, e)
            return
        engine = self.engines[i]
        name = engine_name(engine)
        self.c_dispatched.increment()
        self._dispatch_counter(name).increment()
        meta = {"req": tag, "slo": slo} if tag else None
        try:
            if _trace._enabled and tag:
                with _trace.span("router/submit", "serve", req=tag, slo=slo,
                                 engine=name, gated=gated):
                    fut = engine.submit(prompt, max_new, sampling, stream,
                                        meta=meta)
            else:
                fut = engine.submit(prompt, max_new, sampling, stream,
                                    meta=meta)
        except BaseException as exc:  # noqa: BLE001 — sync submit failure
            self._failover(exc, name, prompt, max_new, sampling, stream,
                           slo, promise, attempt, tag)
            return

        def done(f: Future) -> None:
            exc = f.exception()
            if exc is None:
                promise.set_value(f._value)
            else:
                self._failover(exc, name, prompt, max_new, sampling, stream,
                               slo, promise, attempt, tag)

        fut.on_ready(done)

    def _failover(self, exc: BaseException, name: str, prompt: List[int],
                  max_new: Optional[int],
                  sampling: Optional[SamplingParams],
                  stream: Optional[Channel], slo: Optional[str],
                  promise: Promise, attempt: int,
                  tag: Optional[str] = None) -> None:
        """Dead-engine handling: evict and retry on a healthy replica.

        Retriable ⇔ the request observably did nothing and the failure
        names a replica-level cause: a ``ConnectionError`` such as
        ``PortClosed`` (the locality died — evict the engine) or an
        ``UnknownGid`` (an engine mid-migration cutover outlived the
        resolver's retry budget — do NOT evict, it is alive elsewhere).  A
        stream that already delivered tokens comes back as
        ``StreamBroken`` and is never re-run.  Anything else is delivered
        to the caller, as is the last failure once ``max_failover``
        retries are spent."""
        from repro_torch.net.locality import UnknownGid

        if isinstance(exc, (ConnectionError, UnknownGid)):
            if isinstance(exc, ConnectionError):
                self._evict(name)
            if attempt < self.max_failover:
                self.c_retried.increment()
                self._dispatch(prompt, max_new, sampling, stream, slo,
                               promise, attempt + 1, tag=tag)
                return
            self.c_exhausted.increment()
        self._terminal(stream, promise, exc)

    @staticmethod
    def _terminal(stream: Optional[Channel], promise: Promise,
                  exc: BaseException) -> None:
        if stream is not None and not stream.is_closed():
            stream.close(exc)  # blocked readers see the failure, in order
        try:
            promise.set_exception(exc)
        except Exception:  # noqa: BLE001 — already completed
            pass

    def submit_stream(self, prompt: List[int], max_new: Optional[int] = None,
                      sampling: Optional[SamplingParams] = None,
                      slo: Optional[str] = None) -> Tuple[Channel, Future]:
        ch: Channel = Channel()
        return ch, self.submit(prompt, max_new, sampling, stream=ch, slo=slo)
