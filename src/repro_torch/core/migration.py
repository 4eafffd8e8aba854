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

On a device mesh (``mesh=``) a placement is a list of DTensor placements,
one per mesh dim (``dist.plan.placements``), or a tree of such lists: the
reference's ``NamedSharding`` against that mesh.  A DTensor on the same
mesh is redistributed; a DTensor on another mesh moves through its full
value, gathered by the source mesh's ranks, then ``distribute_tensor``
from the destination's first rank (which must hold that value); a plain
tensor, the same on every rank, is split in place with no collective.
:func:`migrate_to_mesh` is elastic resharding: every leaf onto a new mesh
by a spec function, then one AGAS rebind.  Every rank of both meshes
takes part (SPMD), members or not.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Placement, distribute_tensor

from repro_torch._device import resolve_device
from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters
from repro_torch.dist.plan import placements


def _is_placements(x: Any) -> bool:
    return (isinstance(x, (list, tuple)) and len(x) > 0
            and all(isinstance(p, Placement) for p in x))


def _mesh_device(mesh: Any) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _to_mesh(leaf: Any, mesh: Any, pl: Any) -> DTensor:
    """One leaf as a DTensor of placements ``pl`` on ``mesh``."""
    pl = list(pl)
    if isinstance(leaf, DTensor):
        if leaf.device_mesh == mesh:
            return leaf.redistribute(mesh, pl)
        full = leaf.full_tensor()  # every source rank takes part
        if leaf.device_mesh.get_coordinate() is None:  # not a source rank
            full = torch.empty(tuple(leaf.shape), dtype=leaf.dtype)
        if int(mesh.mesh.flatten()[0]) not in leaf.device_mesh.mesh.flatten().tolist():
            raise ValueError("the destination mesh's first rank must hold the "
                             "leaf's full value (be a rank of the source mesh)")
        return distribute_tensor(full.to(_mesh_device(mesh)), mesh, pl, src_data_rank=0)
    t = torch.as_tensor(leaf).to(_mesh_device(mesh))
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def _move(tree: Any, placement: Any, mesh: Any = None, in_place: bool = False) -> Any:
    if mesh is not None and _is_placements(placement) and \
            not isinstance(tree, (dict, list, tuple)):
        return _to_mesh(tree, mesh, placement)
    if isinstance(tree, dict):
        out = tree if in_place else {}
        for k in list(tree):
            out[k] = _move(tree[k], placement[k] if isinstance(placement, dict) else placement,
                           mesh, in_place)
        return out
    if isinstance(tree, (list, tuple)):
        places = (placement if isinstance(placement, (list, tuple))
                  and not _is_placements(placement) else [placement] * len(tree))
        if len(places) != len(tree):
            raise ValueError(f"placement tree of {len(places)} entries for a "
                             f"tree of {len(tree)}")
        return type(tree)(_move(v, p, mesh) for v, p in zip(tree, places))
    if isinstance(placement, (dict, list, tuple)):
        raise ValueError(f"placement {placement!r} does not match a leaf")
    # a leaf: to() copies blocking; it returns the tensor itself when it is
    # already on the placement (nothing moves)
    return torch.as_tensor(tree).to(resolve_device(placement))


def migrate_tree(tree: Any, placement: Any, mesh: Any = None,
                 in_place: bool = False) -> Any:
    """Copy every leaf of ``tree`` onto its placement.

    ``placement`` is either a single device (applied to all leaves) or a
    tree of devices matching ``tree``'s structure; with ``mesh``, a list
    of DTensor placements (applied to all leaves) or a tree of them.
    Non-tensor leaves become tensors there, as the reference's
    ``device_put`` makes arrays.  ``in_place`` stores each moved leaf in
    the tree's own dicts as it lands, so the old leaf can go at once: the
    move then needs room for one leaf beyond the tree, not a second tree
    (the owner must not be read meanwhile).
    """
    _counters.counter("/migration/trees/cumulative").increment()
    return _move(tree, placement, mesh, in_place)


def migrate(gid_or_name, placement: Any, resolver: Optional[_agas.AGAS] = None,
            mesh: Any = None) -> int:
    """Migrate an AGAS-registered object to a new placement (on ``mesh``
    when given).

    The GID remains valid; readers that re-resolve see the new placement
    (HPX semantics: AGAS is responsible for address resolution after
    migration), and only once every byte has landed.  Returns the new
    generation number.
    """
    resolver = resolver or _agas.default()
    rec = resolver.record(gid_or_name)
    moved = migrate_tree(rec.obj, placement, mesh)
    return resolver.rebind(rec.gid, moved,
                           placement=placement if mesh is None else mesh)


def _leaf_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _leaf_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaf_map(fn, v) for v in tree)
    return fn(tree)


def migrate_to_mesh(gid_or_name, new_mesh: Any, spec_fn: Callable[[Any], Any],
                    resolver: Optional[_agas.AGAS] = None) -> int:
    """Migrate onto a *different mesh* (elastic scaling).

    ``spec_fn(path_free_leaf) -> spec`` is usually ``lambda leaf:
    plan.sharding_for(leaf, new_mesh)`` from :mod:`repro_torch.dist.plan`
    (bind the TARGET mesh: the divisibility guard must see the destination
    axis sizes); each spec becomes placements against ``new_mesh``.  The
    generation is bumped once, after every leaf has landed.
    """
    resolver = resolver or _agas.default()
    rec = resolver.record(gid_or_name)
    shardings = _leaf_map(lambda leaf: placements(spec_fn(leaf), new_mesh), rec.obj)
    moved = migrate_tree(rec.obj, shardings, new_mesh)
    return resolver.rebind(rec.gid, moved, placement=new_mesh)
