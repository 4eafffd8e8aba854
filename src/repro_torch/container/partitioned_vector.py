"""PartitionedVector — an AGAS-backed distributed array (HPX
``hpx::partitioned_vector``), ported from the reference's
``container/partitioned_vector.py``.

The paper's "send work to data instead of data to work" needs a data
structure whose pieces *live somewhere*: a partitioned vector has a fixed
global length cut into segments by a :class:`~repro_torch.container.
distribution.Distribution`; each segment is a tensor registered in AGAS at
its owning locality, in that locality's device memory — ``cuda`` unless the
vector was created with ``device="cpu"`` (the reference's segments are
numpy arrays in their owner's host memory).  The client object here is a
*handle* — plain data (name, geometry, dtype, device kind, segment GIDs),
picklable, valid on any locality:

- **geometry** (which global indices live in which segment) is immutable
  and cached forever — :func:`attach` resolves a name to a handle once per
  locality and caches it;
- **placement** (which locality holds a segment *now*) is never stored in
  the handle at all: every segment op is an object-targeted parcel on the
  segment's GID, riding the net tier's generation-invalidated resolution
  cache — a segment moved by :meth:`move_segment` / :meth:`rebalance`
  self-heals on first touch, exactly like any migrated AGAS object, and
  lands on the vector's device kind at its new owner.

Element access (``get``/``set``/``slice``) ships index ranges out and raw
bytes back through the parcelport's zero-copy buffer path (a CUDA slice
takes one copy to the host before its parcel leaves); ``fill_with`` ships
a *generator function* out instead, so bulk initialization moves ~zero
element bytes.  Whole-container reads (:meth:`to_array`) exist as the
explicit fetch-all baseline.  Reads return CPU tensors where the
reference returns numpy arrays, and Python scalars where it returns one.

Element dtypes are numpy's (the reference's segments are numpy arrays):
``dtype`` takes a numpy dtype, its string, or the matching ``torch.dtype``;
bf16, which numpy lacks, is refused.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.container import distribution as _dist
from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import parcel as _parcel
from repro_torch.core.dataflow import dataflow
from repro_torch.core.future import Future

_TIMEOUT = 120.0


# ------------------------------------------------------------------ dtypes
def np_dtype(dtype: Any) -> np.dtype:
    """A vector's element dtype as numpy names it (refuses bf16)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            raise TypeError("partitioned vectors hold numpy dtypes; numpy has "
                            "no bfloat16")
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def torch_dtype(dtype: Any) -> torch.dtype:
    """The ``torch.dtype`` of a numpy dtype (or its string)."""
    if isinstance(dtype, torch.dtype):
        np_dtype(dtype)  # refuses bf16
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def host_tensor(values: Any) -> torch.Tensor:
    """``values`` as a tensor: a tensor stays as it is; anything else goes
    through ``np.asarray`` (the reference's conversion, so Python floats
    are float64) — read-only wire buffers are copied once."""
    if isinstance(values, torch.Tensor):
        return values
    arr = np.asarray(values)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


# ---------------------------------------------------------- segment actions
# Module-level: worker localities resolve these by dotted name.  Selections
# are ``None`` (whole segment), ``("range", lo, hi)`` (contiguous), or an
# index array (cyclic covers).
def _select(obj: torch.Tensor, sel: Any) -> torch.Tensor:
    if sel is None:
        return obj
    if isinstance(sel, (tuple, list)) and len(sel) == 3 and sel[0] == "range":
        return obj[int(sel[1]):int(sel[2])]
    return obj[torch.as_tensor(np.asarray(sel, dtype=np.int64), device=obj.device)]


@_parcel.action
def _create_segment(rt: Any, name: str, size: int, dtype: str,
                    element_shape: Sequence[int], device: str) -> List[int]:
    """Runs at the owner: allocate a zeroed segment on the owner's
    ``device``, register it in AGAS (publishing to the root table), return
    its GID key."""
    seg = torch.zeros((size, *element_shape), dtype=torch_dtype(dtype),
                      device=resolve_device(device))
    gid = _agas.default().register(seg, name=name)
    return [gid.locality, gid.seq]


@_parcel.action
def _seg_read(obj: torch.Tensor, sel: Any = None) -> torch.Tensor:
    """Object-targeted: ship selected elements home — a CUDA selection is
    copied to the host once here, and rides the wire as zero-copy buffers."""
    return _select(obj, sel).cpu()


@_parcel.action
def _seg_write(obj: torch.Tensor, sel: Any, values: Any) -> int:
    values = host_tensor(values).to(device=obj.device, dtype=obj.dtype)
    if sel is None:
        obj[...] = values
    elif isinstance(sel, (tuple, list)) and len(sel) == 3 and sel[0] == "range":
        obj[int(sel[1]):int(sel[2])] = values
    else:
        obj[torch.as_tensor(np.asarray(sel, dtype=np.int64), device=obj.device)] = values
    return int(values.shape[0]) if values.ndim else 1


@_parcel.action
def _seg_free(obj: torch.Tensor, key: List[int]) -> bool:
    """Object-targeted: drop the segment from its owner's AGAS (and the
    root table, via the unregister hook)."""
    _agas.default().unregister(_agas.GID(*key))
    return True


@_parcel.action
def _unregister_name(rt: Any, name: str) -> bool:
    a = _agas.default()
    if not a.contains(name):
        return False
    a.unregister(a.gid_of(name))
    return True


@_parcel.action
def _seg_generate(obj: torch.Tensor, fn: Callable[..., Any], dist_meta: Dict,
                  seg: int, args: Tuple[Any, ...]) -> int:
    """Work-to-data bulk init: the *generator* crosses the wire (a pickled
    function reference), the element bytes never do.  ``fn(global_idx,
    *args)`` gets numpy int64 global indices and must return
    ``(len(global_idx), *element_shape)`` values; they are copied onto the
    segment's device."""
    idx = _dist.Distribution.from_meta(dist_meta).global_indices(seg)
    obj[...] = host_tensor(fn(idx, *args)).to(device=obj.device, dtype=obj.dtype)
    return int(idx.shape[0])


# ------------------------------------------------------------------- handle
_attach_cache: Dict[str, "PartitionedVector"] = {}
_attach_lock = threading.Lock()
_derived_seq = itertools.count(1)


def _publish_descriptor(name: str, dist: _dist.Distribution, dtype: str,
                        element_shape: Tuple[int, ...],
                        keys: List[Tuple[int, int]], device: str) -> None:
    _agas.default().register(
        {"container": "partitioned_vector", "dtype": dtype, "device": device,
         "element_shape": list(element_shape), "dist": dist.to_meta(),
         "segments": [list(k) for k in keys]}, name=name)


def derived_name(base: str) -> str:
    """Collision-free name for a container derived from ``base`` (transform
    / scan results): unique per (locality, counter)."""
    return f"{base}~d{_agas.default().locality}.{next(_derived_seq)}"


def _base_name(name: str) -> str:
    """Counter key: derived vectors share their source's counters, so a
    loop of transforms/scans never grows the counter registry."""
    return name.split("~d", 1)[0]


def _check_shippable(body: Any) -> None:
    """Bodies/ops cross the wire pickled *by reference* (module.qualname);
    a lambda or closure would fail deep in the parcelport — fail loudly at
    the call site instead, with the fix in the message."""
    if callable(body) and "<" in getattr(body, "__qualname__", ""):
        raise ValueError(
            f"partitioned-vector bodies ship to the data: "
            f"{getattr(body, '__qualname__', body)!r} is a lambda/closure, "
            f"which cannot cross localities. Define it at module level.")


def _device_kind(device: Any) -> str:
    """``"cuda"`` or ``"cpu"``: the caller's device resolved here (raises
    without CUDA), as each owner resolves it in its own process."""
    return resolve_device(device).type


class PartitionedVector:
    """Client handle to a distributed vector; see module docstring."""

    is_segmented = True  # duck-typed dispatch marker for core.algorithms

    def __init__(self, name: str, dist: _dist.Distribution, dtype: Any,
                 element_shape: Tuple[int, ...],
                 segment_keys: List[Tuple[int, int]], device: str):
        self.name = name
        self.dist = dist
        self.dtype = torch_dtype(dtype)
        self.element_shape = tuple(element_shape)
        self.segment_keys = [tuple(k) for k in segment_keys]
        self.device = device
        self._c_ops = _counters.counter(
            f"/container{{{_base_name(name)}}}/parcels/segment_ops")

    @property
    def dtype_str(self) -> str:
        """The element dtype as numpy spells it (descriptors, manifests)."""
        return np_dtype(self.dtype).str

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, name: str, length: int, dtype: Any = np.float64,
               distribution: Any = "block",
               localities: Optional[Sequence[int]] = None,
               element_shape: Sequence[int] = (),
               device: Any = None,
               timeout: float = _TIMEOUT) -> "PartitionedVector":
        """Allocate segments at their owners (parallel parcels) on
        ``device`` (``cuda`` unless given ``"cpu"``; raises without CUDA),
        publish a descriptor under ``name`` so any locality can
        :func:`attach`."""
        from repro_torch import net as _net

        kind = _device_kind(device)
        net = _net.require()
        if localities is None:
            localities = [loc.id for loc in net.localities]
        dist = _dist.make(distribution, length, localities)
        dt = np_dtype(dtype).str
        futs = [
            _net.run_on(dist.owners[j], _create_segment, f"{name}/seg{j}",
                        dist.sizes[j], dt, tuple(element_shape), kind)
            for j in range(dist.nsegments)
        ]
        keys = [tuple(f.get(timeout=timeout)) for f in futs]
        pv = cls(name, dist, dt, tuple(element_shape), keys, kind)
        _publish_descriptor(name, dist, dt, pv.element_shape, keys, kind)
        _counters.gauge(f"/container{{{name}}}/elements/total").set(length)
        with _attach_lock:  # a re-created name must not serve a stale handle
            _attach_cache.pop(name, None)
        return pv

    @classmethod
    def from_parts(cls, name: str, dist: _dist.Distribution, dtype: Any,
                   element_shape: Sequence[int],
                   segment_keys: List[Tuple[int, int]],
                   device: Any = None,
                   publish: bool = True) -> "PartitionedVector":
        """Assemble a handle around segments that already exist in AGAS
        (checkpoint restore, derived results) on ``device`` (``cuda``
        unless ``"cpu"``), and optionally publish its descriptor so other
        localities can :func:`attach`."""
        kind = _device_kind(device)
        dt = np_dtype(dtype).str
        pv = cls(name, dist, dt, tuple(element_shape), segment_keys, kind)
        if publish:
            _publish_descriptor(name, dist, dt, pv.element_shape,
                                pv.segment_keys, kind)
        return pv

    @classmethod
    def attach(cls, name: str, timeout: float = _TIMEOUT,
               refresh: bool = False) -> "PartitionedVector":
        """Resolve ``name`` → handle from any locality.  The geometry is
        immutable, so the handle is cached per process; segment placement
        is *not* part of the handle and stays fresh via the net tier's
        resolution cache.  The cache covers a vector's lifetime, not a
        name's: if a name was freed and re-created *by another locality*,
        pass ``refresh=True`` to re-fetch the descriptor (the creating
        locality's own cache is invalidated automatically)."""
        if refresh:
            with _attach_lock:
                _attach_cache.pop(name, None)
        with _attach_lock:
            hit = _attach_cache.get(name)
        if hit is not None:
            return hit
        from repro_torch import net as _net

        meta = _net.fetch(name, timeout=timeout)
        if not (isinstance(meta, dict)
                and meta.get("container") == "partitioned_vector"):
            raise TypeError(f"{name!r} is not a partitioned vector")
        pv = cls(name, _dist.Distribution.from_meta(meta["dist"]),
                 meta["dtype"], tuple(meta["element_shape"]),
                 [tuple(k) for k in meta["segments"]], meta["device"])
        with _attach_lock:
            _attach_cache.setdefault(name, pv)
        return pv

    # ------------------------------------------------------------- geometry
    def __len__(self) -> int:
        return self.dist.length

    @property
    def nsegments(self) -> int:
        return self.dist.nsegments

    def segment_gid(self, j: int) -> _agas.GID:
        return _agas.GID(*self.segment_keys[j])

    def __repr__(self) -> str:
        return (f"PartitionedVector({self.name!r}, len={len(self)}, "
                f"dtype={np_dtype(self.dtype).name}, {self.dist.kind}"
                f"x{self.nsegments}, {self.device})")

    # ------------------------------------------------------------ transport
    def _apply(self, fn: Callable[..., Any], j: int, *args: Any) -> Future:
        """Object-targeted parcel on segment ``j`` — runs wherever the
        segment lives *now* (stale placements self-heal via the root)."""
        from repro_torch import net as _net

        self._c_ops.increment()
        return _net.apply_remote(fn, self.segment_gid(j), *args)

    # -------------------------------------------------------- element access
    def _norm_index(self, i: int) -> int:
        return i + len(self) if i < 0 else i  # python-sequence semantics

    def get(self, i: int, timeout: float = _TIMEOUT) -> Any:
        seg, loc = self.dist.segment_of(self._norm_index(i))
        out = host_tensor(self._apply(_seg_read, seg, ("range", loc, loc + 1)
                                      ).get(timeout=timeout))[0]
        return out.item() if self.element_shape == () else out

    def set(self, i: int, value: Any, timeout: float = _TIMEOUT) -> None:
        seg, loc = self.dist.segment_of(self._norm_index(i))
        self._apply(_seg_write, seg, ("range", loc, loc + 1),
                    np.asarray([value])).get(timeout=timeout)

    def __getitem__(self, i):
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self))
            if step != 1:
                raise IndexError("partitioned vectors support unit-step slices")
            return self.slice(lo, hi)
        return self.get(int(i))

    def __setitem__(self, i, value) -> None:
        if isinstance(i, slice):
            lo, hi, step = i.indices(len(self))
            if step != 1:
                raise IndexError("partitioned vectors support unit-step slices")
            self.set_slice(lo, hi, value)
        else:
            self.set(int(i), value)

    def slice(self, lo: int, hi: int, timeout: float = _TIMEOUT) -> torch.Tensor:
        """Gather ``[lo, hi)`` in global order as a CPU tensor (parallel
        segment reads, combined on the caller through ``dataflow``)."""
        runs = self.dist.locate_range(lo, hi)
        out = torch.empty((hi - lo, *self.element_shape), dtype=self.dtype)
        futs = [self._apply(_seg_read, s, _as_sel(local)) for s, local, _ in runs]

        def place(*parts):
            for (_s, _local, pos), part in zip(runs, parts):
                out[torch.from_numpy(pos)] = host_tensor(part).to(self.dtype)
            return out

        return dataflow(place, *futs).get(timeout=timeout)

    def set_slice(self, lo: int, hi: int, values: Any,
                  timeout: float = _TIMEOUT) -> None:
        values = host_tensor(values)
        if tuple(values.shape[:1]) != (hi - lo,):
            raise ValueError(
                f"set_slice: {hi - lo} elements expected, got {tuple(values.shape)}")
        runs = self.dist.locate_range(lo, hi)
        futs = [self._apply(_seg_write, s, _as_sel(local),
                            values[torch.as_tensor(pos, device=values.device)])
                for s, local, pos in runs]
        for f in futs:
            f.get(timeout=timeout)

    def to_array(self, timeout: float = _TIMEOUT) -> torch.Tensor:
        """Fetch-all as a CPU tensor: every element travels to the caller.
        This is the data-to-work baseline — segmented algorithms exist to
        avoid it."""
        futs = [self._apply(_seg_read, j) for j in range(self.nsegments)]

        def place(*parts):
            parts = [host_tensor(p) for p in parts]
            dt = (torch_dtype(np.result_type(*[np_dtype(p.dtype) for p in parts]))
                  if parts else self.dtype)
            out = torch.empty((len(self), *self.element_shape), dtype=dt)
            for j, part in enumerate(parts):
                out[torch.from_numpy(self.dist.global_indices(j))] = part.to(dt)
            return out

        return dataflow(place, *futs).get(timeout=timeout)

    def fill_with(self, fn: Callable[..., Any], *args: Any,
                  timeout: float = _TIMEOUT) -> "PartitionedVector":
        """Bulk init where the data lives: ``fn(global_idx, *args)`` runs at
        each owner against its own segment.  ``fn`` must be a module-level
        (picklable-by-reference) function."""
        _check_shippable(fn)
        meta = self.dist.to_meta()
        futs = [self._apply(_seg_generate, j, fn, meta, j, args)
                for j in range(self.nsegments)]
        for f in futs:
            f.get(timeout=timeout)
        return self

    def local_segments(self) -> List[Tuple[int, torch.Tensor]]:
        """Segments owned by *this* locality, as the live tensors (on the
        vector's device)."""
        a = _agas.default()
        return [(j, a.resolve(self.segment_gid(j)))
                for j in range(self.nsegments) if a.contains(self.segment_gid(j))]

    def free(self, timeout: float = _TIMEOUT) -> None:
        """Release the vector: unregister every segment at its owner and
        drop the published descriptor.  Derived results (``transform``,
        the scans) are fresh vectors — free them when transient, or they
        live for the runtime's lifetime."""
        from repro_torch import net as _net

        futs = [self._apply(_seg_free, j, list(self.segment_keys[j]))
                for j in range(self.nsegments)]
        for f in futs:
            f.get(timeout=timeout)
        a = _agas.default()
        if a.contains(self.name):
            a.unregister(a.gid_of(self.name))
        else:  # descriptor published from another locality
            try:
                from repro_torch.net import remote as _remote

                _net.run_on(_remote.owner_of(self.name), _unregister_name,
                            self.name).get(timeout=timeout)
            except Exception:  # noqa: BLE001 — already gone
                pass
        with _attach_lock:
            _attach_cache.pop(self.name, None)

    # ------------------------------------------------------------- placement
    def owner_of(self, j: int) -> int:
        from repro_torch.net import remote as _remote

        return _remote.owner_of(self.segment_gid(j))

    def owners(self) -> List[int]:
        return [self.owner_of(j) for j in range(self.nsegments)]

    def move_segment(self, j: int, dest: int,
                     timeout: float = _TIMEOUT) -> int:
        """Relocate one segment (GID stays valid; generation bumps); it
        lands on the vector's device kind at ``dest``."""
        from repro_torch import net as _net

        return _net.migrate_remote(self.segment_gid(j), dest, timeout=timeout,
                                   device=self.device)

    def rebalance(self, localities: Optional[Sequence[int]] = None,
                  timeout: float = _TIMEOUT) -> List[int]:
        """Spread segments round-robin over ``localities`` (default: all).
        Concurrent readers never observe a gap — each move rides
        ``migrate_remote``'s install-publish-unregister ordering."""
        from repro_torch import net as _net

        if localities is None:
            localities = [loc.id for loc in _net.require().localities]
        targets = [localities[j % len(localities)] for j in range(self.nsegments)]
        for j, dest in enumerate(targets):
            self.move_segment(j, dest, timeout=timeout)
        return targets


def _as_sel(local_idx: np.ndarray) -> Any:
    """Compact wire form of a local-index cover: contiguous runs travel as
    ``("range", lo, hi)`` (3 ints), scattered covers as the index array."""
    if local_idx.size and np.all(np.diff(local_idx) == 1):
        return ("range", int(local_idx[0]), int(local_idx[-1]) + 1)
    return local_idx
