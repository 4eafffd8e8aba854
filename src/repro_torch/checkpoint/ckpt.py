"""Checkpointing, local part: save, async save through the AMT scheduler,
latest step, restore — ported from the reference's ``checkpoint/ckpt.py``
with its on-disk layout, so that a checkpoint written by one package
restores in the other:

- ``<dir>/step_XXXXXXXX/`` holding one ``leaf_NNNNN.npy`` per leaf (leaves
  sorted by their flattened path, nested keys joined by ``_SEP``) and
  ``manifest.json`` (step, per-leaf file/shape/dtype, a fingerprint of the
  shapes and dtypes);
- the manifest is written last and the directory renamed into place, so a
  torn write has no manifest and ``latest_step`` skips it.

numpy has no bfloat16 of its own: a bf16 leaf is stored as its uint16
bits, with ``"bfloat16"`` as its dtype in the manifest, and restored as
bf16 (a reference-written bf16 leaf, two raw bytes, reads the same way).
``restore`` returns CPU tensors, or with ``shardings=`` places them as
DTensors on a target mesh — which may differ from the mesh they were
saved on (elastic restart).  A state of DTensors is saved through each
leaf's full value: every rank of its mesh takes part (SPMD), and only the
mesh's first rank writes.

Checkpoints by GID (``save_gid``/``restore_gid``) cover objects in this
process and, through :mod:`repro_torch.net`, objects owned by another
locality (fetched to the host by GID; restored onto a chosen locality).
Partitioned vectors (``save_partitioned``/``restore_partitioned``) are
written one shard per segment by the segment's owner, in
``<dir>/pvec_XXXXXXXX/`` beside ``partitioned.json``, the reference's
layout and shard encoding, so either package restores the other's.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import executor as _executor
from repro_torch.core import migration as _migration
from repro_torch.core import parcel as _parcel
from repro_torch.core.future import Future, make_ready_future

_SEP = "\x1f"  # unit separator: cannot collide with "/" in param paths
_BF16 = "bfloat16"


def _fingerprint(host: Dict[str, Tuple[np.ndarray, str]]) -> str:
    desc = json.dumps({k: [list(a.shape), dt] for k, (a, dt) in sorted(host.items())},
                      sort_keys=True)
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[: -len(_SEP)]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split(_SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to write, dtype name for the manifest); a copy on the host.
    A DTensor's full value is gathered by its mesh's ranks."""
    if isinstance(leaf, DTensor):
        leaf = leaf.detach().full_tensor()
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write(ckpt_dir: Path, step: int, host: Dict[str, Tuple[np.ndarray, str]]) -> Path:
    ckpt_dir = Path(ckpt_dir)
    out = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}, "fingerprint": _fingerprint(host)}
    for i, (path, (arr, dtype)) in enumerate(sorted(host.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][path] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": dtype}
    # manifest last: presence ⇒ checkpoint complete (torn-write detection)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    _counters.counter("/checkpoint{store#0}/saves/cumulative").increment()
    return out


def _writes(flat: Dict[str, Any]) -> bool:
    """False on a rank that only helps gather a DTensor state: the first
    rank of the (first) mesh writes it."""
    for v in flat.values():
        if isinstance(v, DTensor):
            return dist.get_rank() == int(v.device_mesh.mesh.flatten()[0])
    return True


def save(ckpt_dir: Path, step: int, state: Dict[str, Any]) -> Path:
    """Synchronous save of a nested dict of tensors (params/opt/etc)."""
    flat = _flatten(state)
    host = {k: _to_host(v) for k, v in flat.items()}
    if not _writes(flat):
        return Path(ckpt_dir) / f"step_{step:08d}"
    return _write(ckpt_dir, step, host)


def save_async(ckpt_dir: Path, step: int, state: Dict[str, Any]) -> Future:
    """Snapshot to the host now (the caller may then update the state in
    place); write from the resource partitioner's "io" pool, so the
    trainer keeps going and disk I/O never steals compute slots."""
    flat = _flatten(state)
    host = {k: _to_host(v) for k, v in flat.items()}
    if not _writes(flat):
        return make_ready_future(Path(ckpt_dir) / f"step_{step:08d}")
    return _executor.get_executor("io", fallback="default").async_execute(
        _write, ckpt_dir, step, host)


def latest_step(ckpt_dir: Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _load(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: Path, step: Optional[int] = None,
            shardings: Optional[Any] = None,
            mesh: Any = None) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint (the latest when ``step`` is None) as a nested dict
    of CPU tensors; raises ``FileNotFoundError`` when there is none.  With
    ``shardings`` (a tree of DTensor placements matching the state's, or
    part of it) each such leaf is placed onto ``mesh`` — elastic restart;
    every rank of ``mesh`` reads the same files, so nothing crosses ranks."""
    if shardings is not None and mesh is None:
        raise ValueError("restore(shardings=...) needs the target mesh")
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {path: _load(d / meta["file"], meta["dtype"])
            for path, meta in manifest["leaves"].items()}
    if shardings is not None:
        flat_sh = {p: pl for p, pl in _flatten(shardings).items() if p in flat}
        flat.update(_migration.migrate_tree({p: flat[p] for p in flat_sh}, flat_sh, mesh))
    state = _unflatten(flat)
    _counters.counter("/checkpoint{store#0}/restores/cumulative").increment()
    return manifest["step"], state


def save_gid(ckpt_dir: Path, step: int, target: Any,
             timeout: float = 120.0) -> Path:
    """Save an AGAS-registered object's state by GID or symbolic name.

    A locally-resolvable target is snapshotted in-process; otherwise the
    multi-locality runtime (``repro_torch.net``) resolves the owner through
    the root AGAS table and fetches a host copy over the parcelport (bf16
    crosses as its bits).  The checkpoint directory gains an ``agas.json``
    recording the GID and name so ``restore_gid`` can re-install the
    object under its old identity."""
    a = _agas.default()
    name: Optional[str] = target if isinstance(target, str) else None
    if a.contains(target):
        rec = a.record(target)
        state, gid, name = rec.obj, rec.gid, rec.name
    else:
        from repro_torch import net as _net

        _net.require()
        meta = _net.describe(target, timeout=timeout)
        gid = _agas.GID(*meta["gid"])
        name = name if name is not None else meta["name"]
        # describe cached the resolution: the fetch goes straight to the owner
        state = _net.fetch(gid, timeout=timeout)
    out = save(ckpt_dir, step, state)
    (out / "agas.json").write_text(json.dumps(
        {"gid": [gid.locality, gid.seq], "name": name}))
    return out


def restore_gid(ckpt_dir: Path, step: Optional[int] = None,
                locality: Optional[int] = None,
                timeout: float = 120.0) -> Tuple[int, Any]:
    """Restore a ``save_gid`` checkpoint onto ``locality`` (default: here),
    as CPU tensors, as ``restore`` gives them → (step, GID).

    The state is registered (or rebound) under the checkpoint's symbolic
    name at the target locality — publishing through the root AGAS table —
    and the *new* GID is returned: the object was re-homed, so it carries
    the identity of the locality that now owns it (elastic respawn, not
    resurrection of a dead process's address space)."""
    step, state = restore(ckpt_dir, step)
    meta_path = Path(ckpt_dir) / f"step_{step:08d}" / "agas.json"
    name = json.loads(meta_path.read_text()).get("name") if meta_path.exists() else None

    from repro_torch import net as _net

    net = _net.current()
    if locality is not None and net is None:
        raise RuntimeError(
            f"restore_gid(locality={locality}) needs a multi-locality "
            "runtime: call repro_torch.net.bootstrap(n) first")
    if net is None or locality is None or locality == net.locality:
        a = _agas.default()
        if name is not None and a.contains(name):
            gid = a.gid_of(name)
            a.rebind(gid, state)
        else:
            gid = a.register(state, name=name)
        return step, gid
    from repro_torch.net import remote as _remote

    key = _net.run_on(locality, _remote._install_state, name, state,
                      "cpu").get(timeout=timeout)
    return step, _agas.GID(*key)


# --------------------------------------------------- partitioned containers
@_parcel.action
def _write_segment_shard(obj: Any, dirpath: str, fname: str) -> Dict[str, Any]:
    """Object-targeted: runs at the segment's owner — each locality writes
    its own shard (a CUDA segment takes one copy to its owner's host)."""
    arr, dtype = _to_host(obj)
    np.save(Path(dirpath) / fname, arr)
    return {"file": fname, "shape": list(arr.shape), "dtype": dtype,
            "locality": _agas.default().locality}


@_parcel.action
def _read_segment_shard(rt: Any, dirpath: str, fname: str, dtype: str,
                        seg_name: str, device: str) -> list:
    """Runs at the chosen restore owner: load the shard onto its
    ``device``, register it."""
    from repro_torch._device import resolve_device

    seg = _load(Path(dirpath) / fname, dtype).to(resolve_device(device))
    gid = _agas.default().register(seg, name=seg_name)
    return [gid.locality, gid.seq]


def save_partitioned(ckpt_dir: Path, step: int, pv: Any,
                     timeout: float = 120.0) -> Path:
    """Checkpoint a PartitionedVector segment-parallel: one parcel per
    segment, the *owner* writes its shard (zero element bytes on the wire,
    I/O overlapped across localities).  Torn writes are detected the same
    way as :func:`save`: ``partitioned.json`` is written last."""
    from repro_torch import net as _net

    ckpt_dir = Path(ckpt_dir)
    out = ckpt_dir / f"pvec_{step:08d}"
    tmp = ckpt_dir / f".tmp_pvec_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    futs = [_net.apply_remote(_write_segment_shard, pv.segment_gid(j),
                              str(tmp), f"shard_{j:05d}.npy")
            for j in range(pv.nsegments)]
    shards = [f.get(timeout=timeout) for f in futs]
    manifest = {"step": step, "name": pv.name, "dtype": pv.dtype_str,
                "element_shape": list(pv.element_shape),
                "dist": pv.dist.to_meta(), "shards": shards}
    (tmp / "partitioned.json").write_text(json.dumps(manifest))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    _counters.counter("/checkpoint{store#0}/saves/cumulative").increment()
    return out


def latest_partitioned_step(ckpt_dir: Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("pvec_*")
             if (p / "partitioned.json").exists()]
    return max(steps) if steps else None


def restore_partitioned(ckpt_dir: Path, step: Optional[int] = None,
                        name: Optional[str] = None, device: Any = None,
                        timeout: float = 120.0) -> Tuple[int, Any]:
    """Rebuild a PartitionedVector from its shards on ``device`` (``cuda``
    unless ``"cpu"``), each read by the locality that will own it (owner
    ``o`` of the saving run maps to ``o % n_localities`` of this run —
    elastic restore across different locality counts).  ``name``
    overrides the saved symbolic name (e.g. to restore next to a
    still-live original)."""
    from repro_torch import net as _net
    from repro_torch._device import resolve_device
    from repro_torch.container.distribution import Distribution
    from repro_torch.container.partitioned_vector import PartitionedVector

    kind = resolve_device(device).type
    net = _net.require()
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_partitioned_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no partitioned checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"pvec_{step:08d}"
    manifest = json.loads((d / "partitioned.json").read_text())
    name = name or manifest["name"]
    meta = dict(manifest["dist"])
    # restore where the data lived at SAVE time (each shard records the
    # locality that wrote it — rebalances survive a save/restore cycle),
    # not the creation-time owners the geometry happens to carry
    meta["owners"] = [s["locality"] % net.n_localities
                      for s in manifest["shards"]]
    dist = Distribution.from_meta(meta)
    futs = [_net.run_on(dist.owners[j], _read_segment_shard, str(d),
                        shard["file"], shard["dtype"], f"{name}/seg{j}", kind)
            for j, shard in enumerate(manifest["shards"])]
    keys = [tuple(f.get(timeout=timeout)) for f in futs]
    pv = PartitionedVector.from_parts(name, dist, manifest["dtype"],
                                      tuple(manifest["element_shape"]), keys,
                                      device=kind)
    _counters.counter("/checkpoint{store#0}/restores/cumulative").increment()
    return manifest["step"], pv
