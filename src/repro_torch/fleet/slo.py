"""SLO tiers + occupancy-gated batch admission, ported from the
reference's ``fleet/slo.py``.

Two request classes cross the fleet: **interactive** (a human is waiting —
p99 first-token latency is the SLO) and **batch** (throughput work that
tolerates queueing).  The router steers each class to engines labeled with
its tier (:data:`~repro_torch.serve.router.TIER_INTERACTIVE` /
:data:`~repro_torch.serve.router.TIER_BATCH`), so a batch flood deepens batch
queues without ever sitting in front of an interactive request.

Admission control is the second half: batch requests are *gated on
KV-page occupancy*, not queue depth.  Queue depth says how many requests
wait; occupancy says whether the engines' page pools — the resource that
actually runs out and stalls decode for everyone — are near exhaustion.
The signal costs zero extra messages: :meth:`Router.occupancy` reads each
local engine's ``pages_in_use / capacity`` directly (the reference's
remote engines gossip it back on every completion parcel).

:class:`AdmissionController` is a hysteresis gate over that signal: it
closes at ``high`` and only reopens at ``low``, so occupancy hovering
around one threshold cannot flap the gate (and with it the parked-request
FIFO) open and shut every tick.

Counters::

    /fleet{admission}/closed_edges   cumulative (open → closed transitions)
    /fleet{admission}/opened_edges   cumulative (closed → open transitions)
    /fleet{admission}/open           gauge (1 = admitting)
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.core import counters as _counters
from repro_torch.serve.router import TIER_BATCH, TIER_INTERACTIVE

INTERACTIVE = TIER_INTERACTIVE
BATCH = TIER_BATCH

__all__ = ["INTERACTIVE", "BATCH", "AdmissionController"]


class AdmissionController:
    """Hysteresis gate: ``allow()`` is True until the occupancy signal
    reaches ``high``; it stays False until the signal falls back to
    ``low``.  ``occupancy_fn`` is any zero-argument callable returning the
    current signal — usually ``router.occupancy`` (gossiped max KV-page
    occupancy across live engines)."""

    def __init__(self, occupancy_fn: Callable[[], float],
                 high: float = 0.85, low: float = 0.60):
        assert low <= high, (low, high)
        self._fn = occupancy_fn
        self.high = high
        self.low = low
        self._open = True
        self._lock = threading.Lock()
        self.last_signal: Optional[float] = None
        reg = _counters.default()
        self.c_closed = reg.counter("/fleet{admission}/closed_edges")
        self.c_opened = reg.counter("/fleet{admission}/opened_edges")
        self.g_open = reg.gauge("/fleet{admission}/open")
        self.g_open.set(1.0)

    def allow(self) -> bool:
        try:
            occ = float(self._fn())
        except Exception:  # noqa: BLE001 — no signal: fail open
            return True
        with self._lock:
            self.last_signal = occ
            if self._open and occ >= self.high:
                self._open = False
                self.c_closed.increment()
                self.g_open.set(0.0)
            elif not self._open and occ <= self.low:
                self._open = True
                self.c_opened.increment()
                self.g_open.set(1.0)
            return self._open

    def is_open(self) -> bool:
        with self._lock:
            return self._open

    @classmethod
    def for_router(cls, router, high: float = 0.85,
                   low: float = 0.60) -> "AdmissionController":
        """Gate on the router's gossiped occupancy and install the gate on
        the router (``submit(slo=BATCH)`` consults it from then on)."""
        ctl = cls(router.occupancy, high=high, low=low)
        router.admission = ctl
        return ctl
