"""repro_torch.container — distributed containers: send work to data;
ported from the reference's ``repro.container``.

The paper names "sending work to data instead of data to work" as a core
HPX design pattern; this package is its data-structure half:

    PartitionedVector.create(name, n, ...)   AGAS-backed distributed array
    PartitionedVector.attach(name)           handle from any locality
    pv.get/set/slice/to_array                element access over parcels
    pv.fill_with(fn, ...)                    owner-side bulk init (0 bytes)
    pv.move_segment/rebalance                placement moves (GIDs stable)
    distribution.block/cyclic/explicit       segment geometry policies

Each segment is a tensor in its owner's device memory: ``cuda`` unless a
vector is created with ``device="cpu"`` (``create`` raises without CUDA).

The algorithm half lives in :mod:`repro_torch.container.segmented` and is
reached through ``repro_torch.core.algorithms``: every parallel algorithm
(``for_each``/``transform``/``reduce``/``transform_reduce``/scans/
``count_if``/``all_of``/``any_of``/``sort``/``fill``/``min_element``/
``max_element``) detects a partitioned vector and lowers to per-segment
parcels executed where each segment lives, partials combined on the
caller through ``dataflow``.

Requires a multi-locality runtime (``repro_torch.net.bootstrap``) — the
degenerate 1-locality bootstrap gives the same API in one process.
"""

from repro_torch.container import distribution, segmented
from repro_torch.container.distribution import Distribution, block, cyclic, explicit
from repro_torch.container.partitioned_vector import PartitionedVector

__all__ = [
    "Distribution", "PartitionedVector",
    "block", "cyclic", "explicit",
    "distribution", "segmented",
]
