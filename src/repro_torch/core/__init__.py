"""repro_torch.core — the HPX-style AMT runtime, as far as the serving
path needs it.

    init / finalize / Runtime            hpx::init / hpx::finalize
    spawn / async_                       hpx::async            -> Future
    Future / Promise / Channel / when_all / when_any / make_ready_future
    agas                                 Active Global Address Space
    counters                             APEX-style performance counters
    executor                             executors + execution policies

``dataflow``, ``algorithms``, ``parcel`` and ``migration`` follow in later
slices of the port.
"""

from repro_torch.core import agas, counters, executor
from repro_torch.core.executor import (
    ExecutionPolicy,
    Executor,
    PriorityExecutor,
    SequencedExecutor,
    ThreadPoolExecutor,
    get_executor,
)
from repro_torch.core.future import (
    Channel,
    ChannelClosed,
    Future,
    FutureError,
    Promise,
    make_exceptional_future,
    make_ready_future,
    unwrap,
    wait_all,
    when_all,
    when_any,
)
from repro_torch.core.scheduler import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    Runtime,
    ThreadPool,
    async_,
    current_runtime,
    finalize,
    get_runtime,
    init,
    spawn,
)

__all__ = [
    "agas", "counters", "executor",
    "ExecutionPolicy", "Executor", "PriorityExecutor",
    "SequencedExecutor", "ThreadPoolExecutor", "get_executor",
    "Channel", "ChannelClosed",
    "Future", "FutureError", "Promise", "make_exceptional_future",
    "make_ready_future", "unwrap", "wait_all", "when_all", "when_any",
    "PRIORITY_HIGH", "PRIORITY_LOW", "PRIORITY_NORMAL", "Runtime",
    "ThreadPool", "async_",
    "current_runtime", "finalize", "get_runtime", "init", "spawn",
]
