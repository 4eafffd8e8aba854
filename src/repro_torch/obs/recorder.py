"""Anomaly-triggered fleet flight recorder.

The trace plane (always-on per-thread rings, fleet-merged Chrome
export) and the control plane (a fleet controller's measure → decide → act
tick) meet here.  This module wires them together: the rings run
continuously at low cost, and when the controller's trigger rules fire —
a p99 SLO breach, the admission gate slamming shut, actuator errors —
the ``dump_trace`` actuator *freezes* recording fleet-wide, collects and
clock-corrects every locality's rings, finds the worst offending request,
marks its SLOW-classified critical path into the trace, and writes one
Perfetto-loadable anomaly file.  Recording re-arms afterwards.

The freeze-first ordering matters: the collection round itself sends
parcels, which would overwrite the very ring slots holding the anomaly —
``disable`` is one flag write on each locality, so the window between
trigger and freeze is a single parcel RTT.

Counters::

    /obs{recorder}/dumps        cumulative anomaly dumps written
    /obs{recorder}/suppressed   trigger fired inside the re-arm window
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from repro_torch.core import counters as _counters
from repro_torch.obs import attribution as _attribution
from repro_torch.obs import critical_path as _cp
from repro_torch.obs import export as _export
from repro_torch.obs import trace as _trace

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Always-on rings + anomaly dump-on-trigger.

    ``capacity`` is deliberately small (the "low-cost" contract: a 16k
    ring per thread holds the last few seconds of serving at full tilt);
    ``rearm_s`` rate-limits dumps so a sustained breach produces one
    trace, not one per controller tick."""

    def __init__(self, net=None, out_dir: str = "results",
                 prefix: str = "anomaly", capacity: int = 16384,
                 rearm_s: float = 30.0, probes: int = 3):
        self.net = net
        self.out_dir = out_dir
        self.prefix = prefix
        self.capacity = capacity
        self.rearm_s = rearm_s
        self.probes = probes
        self._seq = 0
        self._last_dump = -float("inf")
        self._lock = threading.Lock()
        self.last_path: Optional[str] = None
        self.last_trace: Optional[Dict[str, Any]] = None
        self.last_offender: Optional[str] = None
        reg = _counters.default()
        self.c_dumps = reg.counter("/obs{recorder}/dumps")
        self.c_suppressed = reg.counter("/obs{recorder}/suppressed")

    # ---------------------------------------------------------------- rings
    def start(self) -> "FlightRecorder":
        """Arm the always-on rings fleet-wide, from an empty window."""
        _export.clear_fleet(self.net)
        _export.enable_fleet(self.net, capacity=self.capacity)
        return self

    def stop(self) -> None:
        _export.disable_fleet(self.net)

    # ----------------------------------------------------------------- dump
    def dump(self, reason: str = "manual",
             detail: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Freeze → collect → blame → write → re-arm.  Returns the path of
        the anomaly trace, or None when suppressed by the re-arm window."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump < self.rearm_s:
                self.c_suppressed.increment()
                return None
            self._last_dump = now
            self._seq += 1
            seq = self._seq

        was_enabled = _trace.enabled()
        _export.disable_fleet(self.net)  # freeze the evidence
        try:
            tr = _export.merged_trace(self.net, probes=self.probes)
            cps = _attribution.analyze_requests(tr)
            offender = None
            if cps:
                offender = max(cps.values(), key=lambda c: c.total_us)
                _cp.mark_critical_path(tr, offender)
            tr["anomaly"] = {
                "reason": reason,
                "detail": detail or {},
                "offender": offender.summary() if offender else None,
                "requests_analyzed": len(cps),
            }
            if cps:  # live blame histograms update with the dump
                _attribution.fold_into_counters(cps)

            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(self.out_dir, f"{self.prefix}-{seq}.json")
            with open(path, "w") as f:
                json.dump(tr, f)
            self.last_path = path
            self.last_trace = tr
            self.last_offender = offender.req if offender else None
            self.c_dumps.increment()
            return path
        finally:
            if was_enabled:  # re-arm for the next anomaly
                _export.enable_fleet(self.net, capacity=self.capacity)

    # ------------------------------------------------------------- triggers
    def install(self, controller, p99_high: Optional[float] = None,
                gate_trigger: bool = True, error_trigger: bool = True,
                sustain: int = 1) -> "FlightRecorder":
        """Register the ``dump_trace`` actuator plus the trigger
        rules on a fleet controller (the reference's ``FleetController``;
        any object with ``register(name, fn)`` and ``add_policy(policy)``):

        - ``p99_high`` (seconds): any engine's live request-latency p99
          gauge (``/serve{...}/request/latency/p99``, swept by the fleet
          sampler) at or above this fires;
        - ``gate_trigger``: the admission gate closed (parked batch
          requests appeared);
        - ``error_trigger``: actuator errors since the last tick.

        Policy cooldowns mirror ``rearm_s`` so triggers and dumps
        rate-limit coherently."""
        from repro_torch.fleet.policy import Policy

        def dump_trace(view) -> None:
            self.dump(reason="controller",
                      detail={"occupancy": getattr(view, "occupancy", 0.0),
                              "gated_depth": getattr(view, "gated_depth", 0)})

        controller.register("dump_trace", dump_trace)

        if p99_high is not None:
            def worst_p99(view) -> float:
                worst = 0.0
                for (_loc, name), val in (view.latest or {}).items():
                    if name.endswith("/request/latency/p99"):
                        worst = max(worst, float(val))
                return worst

            controller.add_policy(Policy(
                "recorder/p99_breach", worst_p99, high=p99_high,
                up="dump_trace", sustain=sustain, cooldown=self.rearm_s))

        if gate_trigger:
            controller.add_policy(Policy(
                "recorder/gate_closed",
                lambda view: float(view.gated_depth), high=1.0,
                up="dump_trace", sustain=sustain, cooldown=self.rearm_s))

        if error_trigger:
            err = _counters.default().counter(
                "/fleet{controller}/action_errors")
            seen = {"n": err.get_value()}

            def error_delta(view) -> float:
                now_n = err.get_value()
                delta = now_n - seen["n"]
                seen["n"] = now_n
                return float(delta)

            controller.add_policy(Policy(
                "recorder/actuator_errors", error_delta, high=1.0,
                up="dump_trace", sustain=sustain, cooldown=self.rearm_s))
        return self
