"""Device meshes and the process group under them — ported from the
reference's ``launch/mesh.py``.

The reference builds single-controller ``jax.sharding`` meshes over the
devices one process sees.  The port is SPMD: every process (rank) builds
the same torch ``DeviceMesh`` over the ranks of one ``torch.distributed``
process group, and runs the same program on its own shards.  A mesh's
``device_type`` is the caller's device: ``cuda`` (NCCL, one rank per card)
unless the caller asks for ``cpu`` (gloo).  NCCL will not put two ranks on
one card, so one card hosts only a one-rank mesh; multi-rank meshes on one
host run as gloo ranks on the CPU.

Process-group set-up and teardown live here and nowhere else:

    init_process_group(rank, world_size, device_type, store_path=...)
    make_mesh_shape((2, 2), ("data", "model"), device_type="cpu")
    ...
    destroy_process_group()

Nothing in the port initialises ``torch.distributed`` on its own: a mesh
function called without a process group raises.

The reference's ambient mesh (``with mesh:``) is :func:`use`: model code
that groups work by the mesh's batch degree (``models/moe.py``) reads
:func:`active`.

The hardware constants at the end are one H100 SXM5's, in the place of
the reference's v5e ones; ``analysis/roofline.py`` and the kernel table's
bounds (``chip_smoke.py``) read the same peak and HBM figures.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import math
from typing import Any, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


# ------------------------------------------------------------ process group
def init_process_group(rank: int = 0, world_size: int = 1, device_type: str = "cuda",
                       store_path: Optional[str] = None,
                       timeout_s: float = 120.0) -> None:
    """Join a ``world_size``-rank process group as ``rank``: NCCL for
    ``cuda`` (the rank's card is ``cuda:rank mod device_count``), gloo for
    ``cpu``.  The rendezvous is a ``FileStore`` at ``store_path`` (every
    rank names the same file), or, for a one-rank group, a ``TCPStore`` on
    a free port of ``localhost``.  Collectives time out after
    ``timeout_s`` seconds, so a lost rank fails its peers instead of
    hanging them."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; call "
                           "destroy_process_group() first")
    if device_type not in BACKENDS:
        raise ValueError(f"unsupported mesh device {device_type!r}; use 'cuda' or 'cpu'")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                               "to run gloo ranks on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if store_path is not None:
        store = dist.FileStore(str(store_path), world_size)
    elif world_size == 1:
        store = dist.TCPStore("localhost", 0, 1, is_master=True,
                              timeout=datetime.timedelta(seconds=timeout_s))
    else:
        raise ValueError("a group of more than one rank needs a store_path "
                         "that every rank shares")
    dist.init_process_group(BACKENDS[device_type], store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def destroy_process_group() -> None:
    """Tear the process group down (and every mesh's subgroups with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_process_group "
                           "first (the port never initialises one on its own)")
    return dist.get_world_size()


# ------------------------------------------------------------------- meshes
def make_mesh_shape(shape: Sequence[int], axes: Sequence[str],
                    device_type: str = "cuda") -> Any:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the process group (every rank must call it,
    members or not: it creates the per-axis groups).  A ``fake`` process
    group (the dry run's) takes either device type."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n, world = math.prod(shape), _world()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group "
                         f"has {world}")
    backend = dist.get_backend()
    if backend != "fake" and BACKENDS.get(device_type) != backend:
        raise ValueError(f"a {device_type} mesh over a {backend} process group")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda") -> Any:
    """Small ``(data, model)`` mesh over however many ranks exist, clamped
    as the reference clamps to the devices there are — tests/examples."""
    n = _world()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return make_mesh_shape((data, model), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> Any:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks), the
    reference's shapes and axis names; raises unless the process group has
    exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _world() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {_world()}")
    return make_mesh_shape(shape, axes, device_type)


# -------------------------------------------------------------- active mesh
@contextlib.contextmanager
def use(mesh: Any) -> Iterator[Any]:
    """Make ``mesh`` the active mesh for the block (the reference's
    ``with mesh:``)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Any]:
    """The mesh of the innermost :func:`use` block, or None."""
    return _ACTIVE.get()


def replicating() -> contextlib.AbstractContextManager:
    """DTensor's ``implicit_replication`` (plain tensors beside DTensors
    taken as replicated: positions, RoPE tables, masks — the same on every
    rank), re-entrant: its own exit turns the mode off, so a nested block
    must not enter it again."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        return contextlib.nullcontext()
    return implicit_replication()


# ------------------------------------------------- H100 hardware constants
POD_SIZE = 256  # ranks per pod (16×16), as in the reference; dist/hlo_analysis
                # classifies a collective whose group spans pods as cross-pod
PEAK_FLOPS_BF16 = 989e12  # per GPU, dense bf16 (NVIDIA H100 SXM5 data sheet)
HBM_BW = 3.35e12  # bytes/s per GPU (NVIDIA H100 SXM5 data sheet, HBM3)
ICI_BW = 50e9  # bytes/s per GPU within a pod: a 256-rank pod spans 32
               # eight-GPU nodes, so its rings cross NDR InfiniBand, 400 Gb/s
               # a GPU (NVIDIA ConnectX-7 / DGX H100 documentation)
DCI_BW = 25e9  # bytes/s per GPU across pods: the reference's documented
               # assumption, kept as one
