"""Distribution policies for partitioned containers (HPX
``hpx::container_distribution_policy``) — ported from the reference's
``container/distribution.py``; pure geometry, so the port's copy is the
reference's, and global indices stay numpy int64 (``fill_with``
generators take them).

A distribution fixes the *geometry* of a :class:`PartitionedVector`: how a
global index space of ``length`` elements is cut into segments and which
locality initially owns each segment.  Geometry is immutable for the
container's lifetime — segments may *move* between localities
(``move_segment`` / ``rebalance``), but which global indices live in which
segment never changes, so the client-side segment map can be cached
forever; only the owner placement is subject to the net tier's
generation-based resolution-cache invalidation.

Three policies, matching HPX:

- ``block``    — near-equal contiguous chunks, one per target locality
  (``container_layout(localities)``);
- ``cyclic``   — element ``i`` lives in segment ``i % S`` at local offset
  ``i // S`` (round-robin dealing);
- ``explicit`` — caller-supplied contiguous segment sizes and owners
  (``container_layout(block_sizes, localities)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Distribution:
    """Immutable segment geometry: ``kind`` ∈ {block, cyclic, explicit}."""

    kind: str
    length: int
    sizes: Tuple[int, ...]   # per-segment element counts
    owners: Tuple[int, ...]  # *initial* owner locality per segment

    @property
    def nsegments(self) -> int:
        return len(self.sizes)

    @property
    def contiguous(self) -> bool:
        """True when every segment holds one contiguous global range (block
        and explicit layouts) — the precondition for the distributed
        two-pass scan; cyclic interleaves and falls back to gather."""
        return self.kind != "cyclic"

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Contiguous layouts: global index of each segment's first slot."""
        out, acc = [], 0
        for s in self.sizes:
            out.append(acc)
            acc += s
        return tuple(out)

    # ------------------------------------------------------------- mapping
    def segment_of(self, i: int) -> Tuple[int, int]:
        """Global index → (segment, local offset)."""
        if not 0 <= i < self.length:
            raise IndexError(f"index {i} out of range [0, {self.length})")
        if self.kind == "cyclic":
            s = self.nsegments
            return i % s, i // s
        cum = np.cumsum(self.sizes)
        seg = int(np.searchsorted(cum, i, side="right"))
        return seg, i - (int(cum[seg - 1]) if seg else 0)

    def global_indices(self, seg: int) -> np.ndarray:
        """Global index of each local slot of ``seg`` (increasing order)."""
        n = self.sizes[seg]
        if self.kind == "cyclic":
            return seg + self.nsegments * np.arange(n, dtype=np.int64)
        return self.offsets[seg] + np.arange(n, dtype=np.int64)

    def locate_range(self, lo: int, hi: int) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """Cover ``[lo, hi)`` → ``[(segment, local_idx, out_pos), ...]``:
        read segment[local_idx] and place it at out_pos of the result."""
        if not 0 <= lo <= hi <= self.length:
            raise IndexError(f"slice [{lo}, {hi}) out of range [0, {self.length})")
        out: List[Tuple[int, np.ndarray, np.ndarray]] = []
        if lo == hi:
            return out
        if self.kind == "cyclic":
            g = np.arange(lo, hi, dtype=np.int64)
            segs = g % self.nsegments
            for s in range(self.nsegments):
                mask = segs == s
                if mask.any():
                    out.append((s, g[mask] // self.nsegments,
                                np.nonzero(mask)[0]))
            return out
        offs = self.offsets
        for s, size in enumerate(self.sizes):
            a, b = max(lo, offs[s]), min(hi, offs[s] + size)
            if a < b:
                out.append((s, np.arange(a - offs[s], b - offs[s], dtype=np.int64),
                            np.arange(a - lo, b - lo, dtype=np.int64)))
        return out

    def to_meta(self) -> dict:
        return {"kind": self.kind, "length": self.length,
                "sizes": list(self.sizes), "owners": list(self.owners)}

    @classmethod
    def from_meta(cls, meta: dict) -> "Distribution":
        return cls(meta["kind"], meta["length"], tuple(meta["sizes"]),
                   tuple(meta["owners"]))


def _split(length: int, parts: int) -> List[int]:
    q, r = divmod(length, parts)
    return [q + 1 if i < r else q for i in range(parts)]


def block(length: int, localities: Sequence[int]) -> Distribution:
    """Near-equal contiguous chunks, one segment per locality."""
    owners = tuple(localities)
    if not owners:
        raise ValueError("block distribution needs at least one locality")
    return Distribution("block", length, tuple(_split(length, len(owners))), owners)


def cyclic(length: int, localities: Sequence[int]) -> Distribution:
    """Round-robin: element ``i`` → segment ``i % S``, offset ``i // S``."""
    owners = tuple(localities)
    if not owners:
        raise ValueError("cyclic distribution needs at least one locality")
    s = len(owners)
    sizes = tuple((length - j + s - 1) // s for j in range(s))
    return Distribution("cyclic", length, sizes, owners)


def explicit(sizes: Sequence[int], owners: Sequence[int]) -> Distribution:
    """Caller-chosen contiguous segment sizes and initial owners."""
    if len(sizes) != len(owners):
        raise ValueError("explicit distribution: len(sizes) != len(owners)")
    if any(s < 0 for s in sizes):
        raise ValueError("explicit distribution: negative segment size")
    return Distribution("explicit", int(sum(sizes)), tuple(int(s) for s in sizes),
                        tuple(int(o) for o in owners))


def make(policy, length: int, localities: Sequence[int]) -> Distribution:
    """Normalize a policy spec: a Distribution passes through, ``"block"`` /
    ``"cyclic"`` build over ``localities``, a sequence of sizes builds an
    explicit layout round-robined over ``localities``."""
    if isinstance(policy, Distribution):
        if policy.length != length:
            raise ValueError(
                f"distribution length {policy.length} != vector length {length}")
        return policy
    if policy == "block":
        return block(length, localities)
    if policy == "cyclic":
        return cyclic(length, localities)
    if isinstance(policy, (list, tuple)):
        owners = [localities[j % len(localities)] for j in range(len(policy))]
        d = explicit(policy, owners)
        if d.length != length:
            raise ValueError(
                f"explicit sizes sum to {d.length}, expected {length}")
        return d
    raise ValueError(f"unknown distribution policy: {policy!r}")
