"""repro_torch.core — the HPX-style AMT runtime, ported from
``repro.core``.

    init / finalize / Runtime            hpx::init / hpx::finalize
    spawn / async_                       hpx::async            -> Future
    dataflow / futurize / TaskGraph      hpx::dataflow         (futurization)
    Future / Promise / Channel / when_all / when_any / make_ready_future
    agas                                 Active Global Address Space
    parcel                               active messages (send work to data)
    counters                             APEX-style performance counters
    algorithms / executor                C++17 parallel algorithms + policies
    migration                            object migration

The device-mesh parts of the reference (``MeshExecutor``,
``parcel.shard_parcel``, ``migration.migrate_to_mesh``) wait for the port's
mesh.
"""

from repro_torch.core import agas, algorithms, counters, executor, migration, parcel
from repro_torch.core.dataflow import TaskGraph, dataflow, futurize
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
    "agas", "algorithms", "counters", "executor", "migration", "parcel",
    "TaskGraph", "dataflow", "futurize",
    "ExecutionPolicy", "Executor", "PriorityExecutor",
    "SequencedExecutor", "ThreadPoolExecutor", "get_executor",
    "Channel", "ChannelClosed",
    "Future", "FutureError", "Promise", "make_exceptional_future",
    "make_ready_future", "unwrap", "wait_all", "when_all", "when_any",
    "PRIORITY_HIGH", "PRIORITY_LOW", "PRIORITY_NORMAL", "Runtime",
    "ThreadPool", "async_",
    "current_runtime", "finalize", "get_runtime", "init", "spawn",
]
