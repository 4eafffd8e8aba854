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
    MeshExecutor / mesh_policy           the device plane (a DeviceMesh)
    parcel.shard_parcel                  a body run at every shard
    migration.migrate_to_mesh            elastic resharding
"""

from repro_torch.core import agas, algorithms, counters, executor, migration, parcel
from repro_torch.core.dataflow import TaskGraph, dataflow, futurize
from repro_torch.core.executor import (
    ExecutionPolicy,
    Executor,
    MeshExecutor,
    PriorityExecutor,
    SequencedExecutor,
    ThreadPoolExecutor,
    get_executor,
    mesh_policy,
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
    "ExecutionPolicy", "Executor", "MeshExecutor", "PriorityExecutor",
    "SequencedExecutor", "ThreadPoolExecutor", "get_executor", "mesh_policy",
    "Channel", "ChannelClosed",
    "Future", "FutureError", "Promise", "make_exceptional_future",
    "make_ready_future", "unwrap", "wait_all", "when_all", "when_any",
    "PRIORITY_HIGH", "PRIORITY_LOW", "PRIORITY_NORMAL", "Runtime",
    "ThreadPool", "async_",
    "current_runtime", "finalize", "get_runtime", "init", "spawn",
]
