"""repro_torch.fleet — the serving fleet's policy and SLO logic, ported from
the reference's ``repro.fleet``.

- :mod:`repro_torch.fleet.policy`: declarative :class:`Policy` rules (a
  counter threshold held for ``sustain`` ticks, then a ``cooldown``) over a
  :class:`FleetView` snapshot;
- :mod:`repro_torch.fleet.slo`: the ``interactive`` / ``batch`` request
  tiers and the occupancy-gated :class:`AdmissionController`.

The reference's controller, elastic growth and live migration act on
remote localities and wait for the port's multi-locality runtime.
"""

from repro_torch.fleet.policy import (
    EngineView,
    FleetView,
    Policy,
    utilization_policy,
)
from repro_torch.fleet.slo import BATCH, INTERACTIVE, AdmissionController

__all__ = [
    "AdmissionController", "BATCH", "EngineView", "FleetView", "INTERACTIVE",
    "Policy", "utilization_policy",
]
