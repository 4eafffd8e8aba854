"""A steady stretch of a run under ``torch.profiler``, reduced to plain
tuples: the device's operations, the host's operators (from every
thread) and the stretch's bounds, all on the profiler's clock
(nanoseconds of the Unix epoch).  ``to_ns`` maps a ``time.perf_counter``
reading, the clock of the program's spans, onto it."""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Profile:
    t0_ns: int = 0
    t1_ns: int = 0
    offset_ns: int = 0                      # epoch ns − perf_counter ns
    # (name, start_ns, end_ns, linked host correlation id)
    device: List[Tuple[str, int, int, int]] = field(default_factory=list)
    # (name, start_ns, end_ns, thread, correlation id, input shapes)
    host: List[Tuple[str, int, int, int, int, list]] = field(default_factory=list)
    # the program's spans in the stretch, on this clock: (name, start_ns, end_ns)
    names: List[Tuple[str, int, int]] = field(default_factory=list)

    def to_ns(self, perf_s: float) -> int:
        return int(perf_s * 1e9) + self.offset_ns

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def _offset_ns() -> int:
    a = time.time_ns()
    p = time.perf_counter_ns()
    b = time.time_ns()
    return (a + b) // 2 - p


class Profiler:
    """start() / stop() around a stretch, from one thread; ``result``
    (reduced on first read, which can take seconds: read it once the
    measured window has closed)."""

    def __init__(self, record_shapes: bool = False):
        import torch
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            # the program's threads (engine, prefill pool, autograd) predate
            # the profiler: only this records their operators
            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             record_shapes=record_shapes, **kw)
        self._result: Optional[Profile] = None
        self._t0 = self._t1 = 0

    def start(self) -> None:
        self._prof.start()
        self._t0 = time.time_ns()

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self._t1 = time.time_ns()
        self._prof.stop()

    def stretch(self, start: float, end: float) -> None:
        """Profile from ``time.perf_counter()`` = start to end (run it on
        a thread of its own, so that nobody waits for it)."""
        time.sleep(max(0.0, start - time.perf_counter()))
        self.start()
        time.sleep(max(0.0, end - time.perf_counter()))
        self.stop()

    @property
    def result(self) -> Profile:
        if self._result is None:
            self._result = _reduce(self._prof, self._t0, self._t1)
            self._prof = None
        return self._result


def _reduce(prof, t0_ns: int, t1_ns: int) -> Profile:
    from torch.autograd import DeviceType

    out = Profile(t0_ns=t0_ns, t1_ns=t1_ns, offset_ns=_offset_ns())
    for ev in prof.profiler.kineto_results.events():
        if ev.is_hidden_event():
            continue
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.duration_ns() > 0:
                out.device.append((ev.name(), start, end, ev.linked_correlation_id()))
        else:
            out.host.append((ev.name(), start, end, ev.start_thread_id(),
                             ev.correlation_id(), ev.shapes()))
    return out


def warm(torch) -> None:
    """One empty stretch, so that the profiler's first start (which loads
    CUPTI) is paid in set-up."""
    p = Profiler()
    p.start()
    torch.zeros(1, device="cuda").add_(1)
    p.stop()


def device_time_within(p: Profile, range_name: str) -> Tuple[float, int]:
    """(seconds of device operations launched by any host operator nested
    inside a host range named ``range_name`` on the same thread, number
    of such ranges).  Ranges of one name on one thread do not overlap."""
    by_thread = {}
    for h in p.host:
        if h[0] == range_name:
            by_thread.setdefault(h[3], []).append((h[1], h[2]))
    starts = {th: sorted(rs) for th, rs in by_thread.items()}
    keys = {th: [a for a, _ in rs] for th, rs in starts.items()}
    ids = set()
    for _name, a, b, th, corr, _shapes in p.host:
        rs = starts.get(th)
        if rs is None:
            continue
        i = bisect.bisect_right(keys[th], a) - 1
        if i >= 0 and b <= rs[i][1]:
            ids.add(corr)
    n = sum(len(rs) for rs in starts.values())
    return sum(b - a for _, a, b, c in p.device if c in ids) / 1e9, n
