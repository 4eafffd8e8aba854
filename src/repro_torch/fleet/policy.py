"""Declarative fleet policies: counter thresholds → actuator firings.
Ported from the reference's ``fleet/policy.py`` (pure logic).

A :class:`Policy` is a rule the controller evaluates every tick against a
:class:`FleetView` (the tick's consistent snapshot of fleet state): a
``metric`` callable reduces the view to one number, and crossing ``high``
(or falling to ``low``) for ``sustain`` consecutive ticks fires the
``up`` (or ``down``) actuator — subject to a per-policy ``cooldown`` so
one burst cannot fire grow-then-shrink-then-grow in three ticks.

The shape mirrors the paper's adaptivity loop: *measure* (counters →
view), *decide* (threshold + hysteresis-by-sustain), *act* (a named
actuator the controller owns: grow an engine, migrate one, shed load).
Policies never actuate directly — they return the actuator's name, which
keeps them trivially unit-testable with a synthetic view.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["EngineView", "FleetView", "Policy", "utilization_policy"]


@dataclass
class EngineView:
    """One engine as the controller saw it this tick."""
    name: str
    locality: int
    tier: Optional[str]
    load: float
    occupancy: float


@dataclass
class FleetView:
    """Per-tick snapshot the policies evaluate against.  ``rates`` carries
    the sampler's per-(locality, counter) rates for anything the metric
    wants beyond load/occupancy (token throughput, step p99, …)."""
    now: float
    engines: List[EngineView] = field(default_factory=list)
    occupancy: float = 0.0      # max across live engines (the gate signal)
    gated_depth: int = 0        # batch requests parked at the admission gate
    rates: Dict[Tuple[int, str], float] = field(default_factory=dict)
    latest: Dict[Tuple[int, str], float] = field(default_factory=dict)

    def total_load(self) -> float:
        return sum(e.load for e in self.engines)

    def tier_load(self, tier: Optional[str]) -> float:
        return sum(e.load for e in self.engines if e.tier == tier)

    def rate(self, locality: int, name: str) -> float:
        return self.rates.get((locality, name), 0.0)

    # ------------------------------------------- scheduler health signals
    def pool_utilization(self, locality: int, pool: str = "default") -> float:
        """Windowed utilization of one locality's pool, derived from the
        cumulative ``time/busy`` / ``time/idle`` clock rates the sampler
        retained — the fraction of worker wall-time spent running tasks
        over the sampler's window.  0.0 when the counters were never
        sampled (an unreachable locality reads as idle, not saturated,
        so a grow policy can't be spooked by a dead peer)."""
        busy = self.rate(locality, f"/scheduler{{{pool}}}/time/busy")
        idle = self.rate(locality, f"/scheduler{{{pool}}}/time/idle")
        total = busy + idle
        return busy / total if total > 0.0 else 0.0

    def pool_idle_rate(self, locality: int, pool: str = "default") -> float:
        busy = self.rate(locality, f"/scheduler{{{pool}}}/time/busy")
        idle = self.rate(locality, f"/scheduler{{{pool}}}/time/idle")
        total = busy + idle
        return idle / total if total > 0.0 else 1.0

    def mean_utilization(self, pool: str = "default") -> float:
        """Fleet-wide mean pool utilization across every locality the
        sampler has busy/idle clocks for — the saturation signal a
        grow-on-starvation policy predicates on."""
        suffix = f"/scheduler{{{pool}}}/time/busy"
        locs = sorted({loc for (loc, name) in self.rates if name == suffix})
        if not locs:
            return 0.0
        return sum(self.pool_utilization(loc, pool) for loc in locs) / len(locs)


def utilization_policy(high: float = 0.85, low: float = 0.15,
                       up: Optional[str] = "grow",
                       down: Optional[str] = "shrink",
                       pool: str = "default", sustain: int = 3,
                       cooldown: float = 10.0) -> "Policy":
    """The canonical scale-on-saturation rule: fleet mean utilization of
    ``pool`` sustained ≥ ``high`` fires ``up``; sustained ≤ ``low`` fires
    ``down``.  Starvation (SLOW's S) measured by the scheduler itself —
    the idle-rate counters — rather than inferred from queue proxies."""
    return Policy(f"utilization:{pool}",
                  lambda view: view.mean_utilization(pool),
                  high=high, up=up, low=low, down=down,
                  sustain=sustain, cooldown=cooldown)


class Policy:
    """Threshold rule with sustain + cooldown.

    ``metric(view) -> float`` is evaluated every tick.  After ``sustain``
    consecutive ticks at or above ``high`` the policy proposes ``up``;
    after ``sustain`` consecutive ticks at or below ``low`` it proposes
    ``down``.  A firing starts the ``cooldown`` clock; the policy stays
    silent (and keeps its streak counters frozen at zero) until it
    expires.  ``high``/``up`` or ``low``/``down`` may be omitted for
    one-sided rules."""

    def __init__(self, name: str, metric: Callable[[FleetView], float],
                 high: Optional[float] = None, low: Optional[float] = None,
                 up: Optional[str] = None, down: Optional[str] = None,
                 sustain: int = 2, cooldown: float = 5.0):
        assert (high is None) == (up is None), "high and up come together"
        assert (low is None) == (down is None), "low and down come together"
        self.name = name
        self.metric = metric
        self.high = high
        self.low = low
        self.up = up
        self.down = down
        self.sustain = max(1, sustain)
        self.cooldown = cooldown
        self.last_value: Optional[float] = None
        self._hi_streak = 0
        self._lo_streak = 0
        self._last_fired = -float("inf")

    def evaluate(self, view: FleetView,
                 now: Optional[float] = None) -> Optional[str]:
        """Returns the actuator name to fire this tick, or ``None``."""
        now = time.monotonic() if now is None else now
        value = float(self.metric(view))
        self.last_value = value
        if self.high is not None and value >= self.high:
            self._hi_streak += 1
            self._lo_streak = 0
        elif self.low is not None and value <= self.low:
            self._lo_streak += 1
            self._hi_streak = 0
        else:
            self._hi_streak = 0
            self._lo_streak = 0
        if now - self._last_fired < self.cooldown:
            return None
        if self.up is not None and self._hi_streak >= self.sustain:
            self._fire(now)
            return self.up
        if self.down is not None and self._lo_streak >= self.sustain:
            self._fire(now)
            return self.down
        return None

    def _fire(self, now: float) -> None:
        self._last_fired = now
        self._hi_streak = 0
        self._lo_streak = 0
