"""repro_torch.fleet — counter-driven adaptive serving control plane, ported
from the reference's ``repro.fleet``.

On locality 0 a :class:`~repro_torch.fleet.controller.FleetController`
polls the fleet's counters (:class:`~repro_torch.obs.sampler.FleetSampler`
histories + router gossip), evaluates declarative
:class:`~repro_torch.fleet.policy.Policy` rules with hysteresis, and
actuates —

- **SLO tiers** (:mod:`repro_torch.fleet.slo`): interactive vs batch
  request classes routed to different engines; batch admission gated on
  *gossiped* KV-page occupancy, not queue depth.
- **Elasticity** (:mod:`repro_torch.fleet.elastic`): spawn a whole new
  locality (+engine) into the running fleet, or drain and retire one.
- **Live migration** (:mod:`repro_torch.fleet.migrate`): move a *running*
  engine — paged KV and in-flight streams included — to another locality
  with zero dropped or duplicated tokens.
"""

from repro_torch.fleet.controller import FleetController
from repro_torch.fleet.elastic import grow_engine, retire_engine
from repro_torch.fleet.migrate import migrate_engine
from repro_torch.fleet.policy import (
    EngineView,
    FleetView,
    Policy,
    utilization_policy,
)
from repro_torch.fleet.slo import BATCH, INTERACTIVE, AdmissionController

__all__ = [
    "AdmissionController", "BATCH", "EngineView", "FleetController",
    "FleetView", "INTERACTIVE", "Policy", "grow_engine", "migrate_engine",
    "retire_engine", "utilization_policy",
]
