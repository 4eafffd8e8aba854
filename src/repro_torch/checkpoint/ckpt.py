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
``restore`` returns CPU tensors; the caller places them.

Checkpoints by GID (``save_gid``/``restore_gid``) cover objects that live
in this process; their remote branches (an object owned by another
locality) raise until the port has a multi-locality runtime, and so wait
partitioned checkpoints for the port of ``container``.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.core import executor as _executor
from repro_torch.core.future import Future

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
    """(array to write, dtype name for the manifest); a copy on the host."""
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


def save(ckpt_dir: Path, step: int, state: Dict[str, Any]) -> Path:
    """Synchronous save of a nested dict of tensors (params/opt/etc)."""
    return _write(ckpt_dir, step, {k: _to_host(v) for k, v in _flatten(state).items()})


def save_async(ckpt_dir: Path, step: int, state: Dict[str, Any]) -> Future:
    """Snapshot to the host now (the caller may then update the state in
    place); write from the resource partitioner's "io" pool, so the
    trainer keeps going and disk I/O never steals compute slots."""
    host = {k: _to_host(v) for k, v in _flatten(state).items()}
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


def restore(ckpt_dir: Path, step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint (the latest when ``step`` is None) as a nested dict
    of CPU tensors; raises ``FileNotFoundError`` when there is none."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    state = _unflatten({path: _load(d / meta["file"], meta["dtype"])
                        for path, meta in manifest["leaves"].items()})
    _counters.counter("/checkpoint{store#0}/restores/cumulative").increment()
    return manifest["step"], state


def _no_net(what: str) -> RuntimeError:
    return RuntimeError(
        f"{what} needs a multi-locality runtime, which the port does not have "
        f"yet: only objects registered in this process can be checkpointed "
        f"by GID")


def save_gid(ckpt_dir: Path, step: int, target: Any) -> Path:
    """Save an AGAS-registered object's state by GID or symbolic name.

    The target is snapshotted in-process; the checkpoint directory gains an
    ``agas.json`` recording the GID and name so ``restore_gid`` can
    re-install the object under its old identity.  A target that does not
    resolve here would live at another locality: that raises."""
    a = _agas.default()
    if not a.contains(target):
        raise _no_net(f"save_gid({target!r}) of an object not registered here")
    rec = a.record(target)
    out = save(ckpt_dir, step, rec.obj)
    (out / "agas.json").write_text(json.dumps(
        {"gid": [rec.gid.locality, rec.gid.seq], "name": rec.name}))
    return out


def restore_gid(ckpt_dir: Path, step: Optional[int] = None,
                locality: Optional[int] = None) -> Tuple[int, Any]:
    """Restore a ``save_gid`` checkpoint here (as CPU tensors, as
    ``restore`` gives them) → (step, GID).

    The state is registered under the checkpoint's symbolic name, or
    rebound where that name is taken, and the *new* GID is returned: the
    object was re-homed, so it carries the identity of the locality that
    now owns it.  Restoring onto another ``locality`` raises."""
    if locality is not None:
        raise _no_net(f"restore_gid(locality={locality})")
    step, state = restore(ckpt_dir, step)
    meta_path = Path(ckpt_dir) / f"step_{step:08d}" / "agas.json"
    name = json.loads(meta_path.read_text()).get("name") if meta_path.exists() else None
    a = _agas.default()
    if name is not None and a.contains(name):
        gid = a.gid_of(name)
        a.rebind(gid, state)
    else:
        gid = a.register(state, name=name)
    return step, gid
