"""Object migration (HPX P3: "load balancing through object migration") —
ported from the reference's ``core/migration.py``.

In HPX an object migrates between process address spaces while its GID
stays valid.  Here an object is a tree (dicts, lists, tuples) of tensors and
a "locality" is a placement: a ``torch.device``, or a tree of devices that
matches the object's tree — the one-host counterpart of the reference's
shardings.  Migration copies every leaf onto its new device and bumps the
object's AGAS generation; the GID stays.

Every copy is blocking: a ``non_blocking`` copy from the card to the host
returns before the bytes land, and a reader that re-resolves the record
after the rebind must never see a half-copied leaf.

The reference's ``migrate_to_mesh`` (elastic resharding onto another
device mesh) waits for the port's mesh.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters


def _move(tree: Any, placement: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _move(v, placement[k] if isinstance(placement, dict) else placement)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        places = (placement if isinstance(placement, (list, tuple))
                  else [placement] * len(tree))
        if len(places) != len(tree):
            raise ValueError(f"placement tree of {len(places)} entries for a "
                             f"tree of {len(tree)}")
        return type(tree)(_move(v, p) for v, p in zip(tree, places))
    if isinstance(placement, (dict, list, tuple)):
        raise ValueError(f"placement {placement!r} does not match a leaf")
    # a leaf: to() copies blocking; it returns the tensor itself when it is
    # already on the placement (nothing moves)
    return torch.as_tensor(tree).to(resolve_device(placement))


def migrate_tree(tree: Any, placement: Any) -> Any:
    """Copy every leaf of ``tree`` onto its placement.

    ``placement`` is either a single device (applied to all leaves) or a
    tree of devices matching ``tree``'s structure.  Non-tensor leaves
    become tensors there, as the reference's ``device_put`` makes arrays.
    """
    _counters.counter("/migration/trees/cumulative").increment()
    return _move(tree, placement)


def migrate(gid_or_name, placement: Any, resolver: Optional[_agas.AGAS] = None) -> int:
    """Migrate an AGAS-registered object to a new placement.

    The GID remains valid; readers that re-resolve see the new placement
    (HPX semantics: AGAS is responsible for address resolution after
    migration), and only once every byte has landed.  Returns the new
    generation number.
    """
    resolver = resolver or _agas.default()
    rec = resolver.record(gid_or_name)
    moved = migrate_tree(rec.obj, placement)
    return resolver.rebind(rec.gid, moved, placement=placement)
