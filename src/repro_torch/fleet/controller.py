"""FleetController — the measure → decide → act loop on locality 0, ported
from the reference's ``fleet/controller.py``.

Each tick (daemon thread, or :meth:`tick` driven synchronously from
tests):

1. **measure** — one fault-tolerant counter sweep across every live
   locality (:meth:`FleetSampler.sample_once`, which rides the sweep form
   of ``query_counters`` — a dying locality yields an error marker, never
   an exception), plus the router's locally-held load/occupancy gossip,
   folded into one :class:`~repro_torch.fleet.policy.FleetView`;
2. **decide** — every :class:`~repro_torch.fleet.policy.Policy` evaluates
   against the view (sustain + cooldown live in the policy);
3. **act** — fired policies name actuators (callables registered on the
   controller: grow, retire, migrate, or anything else); actuator failures
   are counted and contained — a failed grow must not kill the loop;
4. **release** — if the admission gate is open again, parked batch
   requests drain FIFO back into dispatch (``router.release_gated``).

Counters::

    /fleet{controller}/ticks             cumulative
    /fleet{controller}/actions           cumulative (actuator firings)
    /fleet{controller}/action_errors     cumulative
    /fleet{controller}/occupancy         gauge (the view's gate signal)
    /fleet{controller}/released          cumulative (gated → dispatched)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

from repro_torch.core import counters as _counters
from repro_torch.fleet.policy import EngineView, FleetView, Policy
from repro_torch.obs import trace as _trace
from repro_torch.obs.sampler import FleetSampler
from repro_torch.serve.router import RemoteEngine, Router, engine_name

__all__ = ["FleetController"]


class FleetController:
    def __init__(self, net, router: Router,
                 sampler: Optional[FleetSampler] = None,
                 policies: Iterable[Policy] = (),
                 actuators: Optional[Dict[str, Callable[..., Any]]] = None,
                 interval: float = 0.5):
        self.net = net
        self.router = router
        # "*" not "/serve*": policies now also predicate on scheduler
        # health (idle-rate / time-busy clocks) — see FleetView.pool_utilization
        self.sampler = sampler or FleetSampler(
            pattern="*", interval=interval, net=net)
        self.policies = list(policies)
        self.actuators: Dict[str, Callable[..., Any]] = dict(actuators or {})
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_view: Optional[FleetView] = None

        reg = _counters.default()
        self.c_ticks = reg.counter("/fleet{controller}/ticks")
        self.c_actions = reg.counter("/fleet{controller}/actions")
        self.c_action_errors = reg.counter("/fleet{controller}/action_errors")
        self.g_occupancy = reg.gauge("/fleet{controller}/occupancy")
        self.c_released = reg.counter("/fleet{controller}/released")

    # ------------------------------------------------------------- plumbing
    def add_policy(self, policy: Policy) -> "FleetController":
        self.policies.append(policy)
        return self

    def register(self, name: str,
                 fn: Callable[..., Any]) -> "FleetController":
        """Register an actuator; policies refer to it by this name."""
        self.actuators[name] = fn
        return self

    # -------------------------------------------------------------- measure
    def view(self, now: Optional[float] = None) -> FleetView:
        """Fold router gossip + sampler history into this tick's view.
        Reads only locally-held state — building a view costs zero
        messages (the sweep already happened in :meth:`tick`)."""
        now = time.monotonic() if now is None else now
        engines = []
        for e in list(self.router.engines):
            name = engine_name(e)
            loc = e.locality if isinstance(e, RemoteEngine) else \
                self.net.locality
            try:
                load = float(e.load())
                occ = float(e.occupancy())
            except Exception:  # noqa: BLE001 — engine mid-teardown
                continue
            engines.append(EngineView(name=name, locality=loc,
                                      tier=self.router.tier_of(name),
                                      load=load, occupancy=occ))
        view = FleetView(
            now=now, engines=engines,
            occupancy=max((e.occupancy for e in engines), default=0.0),
            gated_depth=self.router.gated_depth(),
            rates=self.sampler.rates(),
        )
        view.latest = {key: pts[-1][1] for key in self.sampler.keys()
                       for pts in [self.sampler.series(*key)] if pts}
        return view

    # ------------------------------------------------------------------ act
    def tick(self) -> FleetView:
        if _trace._enabled:
            with _trace.span("controller/tick", "fleet"):
                return self._tick_body()
        return self._tick_body()

    def _tick_body(self) -> FleetView:
        self.sampler.sample_once()
        view = self.view()
        self.last_view = view
        self.g_occupancy.set(view.occupancy)
        for policy in self.policies:
            action = policy.evaluate(view, view.now)
            if action is None:
                continue
            fn = self.actuators.get(action)
            if fn is None:
                self.c_action_errors.increment()
                if _trace._enabled:
                    _trace.instant("controller/action_error", "fleet",
                                   policy=policy.name, action=action,
                                   missing=True)
                continue
            self.c_actions.increment()
            if _trace._enabled:
                _trace.instant("controller/action", "fleet",
                               policy=policy.name, action=action)
            try:
                fn(view)
            except Exception:  # noqa: BLE001 — one failed actuation must
                self.c_action_errors.increment()  # not kill the loop
                if _trace._enabled:
                    _trace.instant("controller/action_error", "fleet",
                                   policy=policy.name, action=action)
        released = self.router.release_gated()
        if released:
            self.c_released.increment(released)
        self.c_ticks.increment()
        return view

    # ----------------------------------------------------------------- loop
    def start(self) -> "FleetController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-fleet-controller")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(5.0, self.interval * 4))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive a
                self.c_action_errors.increment()  # mid-retirement race
