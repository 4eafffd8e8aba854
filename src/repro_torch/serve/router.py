"""Multi-engine router: SLO-tiered, fault-tolerant least-loaded dispatch
over local engine replicas, ported from the reference's
``serve/router.py``.

Each :class:`~repro_torch.serve.engine.Engine` replica owns its own cache
(a page pool or dense slots, as its ``ServeConfig`` and family choose),
decode continuation chain and performance counters; the router is the
only coordination point and dispatches each request to the least loaded
replica (``submitted - completed``, a local counter read — no messages,
no global queue).  On top of that, as in the reference:

- **SLO tiers** — engines carry a tier label (``interactive`` / ``batch``
  / untiered); ``submit(..., slo=...)`` prefers same-tier engines, then
  untiered ones, then anything alive.  Batch submits also pass the
  ``admission`` gate when one is installed
  (:class:`repro_torch.fleet.slo.AdmissionController`); gated requests
  park in a FIFO until ``release_gated``.
- **Failover** — an engine that fails a request with a ``ConnectionError``
  (the base of the reference's ``PortClosed``: the replica is gone) is
  evicted and the request retried on a healthy peer, at most
  ``max_failover`` times.  Any other failure is the request's own and is
  delivered to the caller.
- **Membership** — ``add_engine`` / ``remove_engine`` / ``suspend`` /
  ``resume`` / ``revive`` on a running router.

The reference's remote replicas (``RemoteEngine``, ``over_localities``)
wait for the port's multi-locality runtime.

Counters::

    /serve{router}/requests/dispatched           cumulative
    /serve{router}/dispatch/<engine-name>        cumulative per replica
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
from repro_torch.core import counters as _counters
from repro_torch.core.future import Channel, Future, Promise
from repro_torch.models.model import Model
from repro_torch.obs import trace as _trace
from repro_torch.serve.engine import Engine, SamplingParams, ServeConfig

# SLO tier labels (re-exported by repro_torch.fleet.slo — defined here so
# the serve layer never imports the fleet layer)
TIER_INTERACTIVE = "interactive"
TIER_BATCH = "batch"


def engine_name(e: Any) -> str:
    """Display/counter name of an engine."""
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


class Router:
    def __init__(self, engines: List[Engine],
                 tiers: Optional[Dict[str, Optional[str]]] = None):
        if not engines:
            raise ValueError("router needs at least one engine")
        self.engines = list(engines)
        self._tiers: Dict[str, Optional[str]] = {
            engine_name(e): (tiers or {}).get(engine_name(e))
            for e in engines
        }
        self._dead: set = set()       # evicted by failover
        self._suspended: set = set()  # no new dispatch
        self._lock = threading.Lock()
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

    # ---------------------------------------------------------- membership
    def engine(self, name: str) -> Any:
        for e in self.engines:
            if engine_name(e) == name:
                return e
        raise KeyError(f"no engine named {name!r}")

    def add_engine(self, e: Any, tier: Optional[str] = None) -> None:
        """Admit a replica into a *running* router."""
        name = engine_name(e)
        self._dispatch_counter(name)
        with self._lock:
            self.engines = [x for x in self.engines
                            if engine_name(x) != name] + [e]
            self._tiers[name] = tier
            self._dead.discard(name)
            self._suspended.discard(name)

    def remove_engine(self, name: str) -> Optional[Any]:
        """Take a replica out of dispatch."""
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
        """Stop dispatching to an engine without removing it."""
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
        """Max live-engine KV occupancy, read from each engine directly —
        the admission signal."""
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

    def pick(self, slo: Optional[str] = None) -> int:
        """Least-loaded replica (first wins ties — stable under no load).

        ``slo``: prefer engines labeled with that tier; fall back to
        untiered engines, then to anything alive — a tier label steers,
        it never strands a request."""
        with self._lock:
            dead = set(self._dead) | set(self._suspended)
            tiers = dict(self._tiers)
            engines = list(self.engines)
        candidates = [i for i, e in enumerate(engines)
                      if engine_name(e) not in dead]
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

        Retriable ⇔ the failure names a replica-level cause: a
        ``ConnectionError`` (the reference's ``PortClosed``: the replica is
        gone — evict it).  The reference's other retriable cause, an
        ``UnknownGid`` from an engine mid-migration, needs a second
        locality and cannot arise here.  Anything else is delivered to the
        caller, as is the last failure once ``max_failover`` retries are
        spent."""
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
