"""Block-pool paged KV cache (the serving stack's cache layer), ported
from the reference's ``serve/kv_cache.py``.

KV lives in ``num_pages`` fixed-size pages shared by all requests and all
layers (page ``p`` holds a request's tokens in *every* layer array), a
LIFO free list hands pages out on demand, and each batch slot owns a page
list mirrored into a ``(max_batch, max_pages_per_req)`` page table that the
paged decode kernel walks.  Memory therefore scales with live tokens.

Page 0 is reserved as a scratch page: idle slots' page tables point at it,
so the batched decode step can write their (discarded) K/V somewhere
harmless without per-slot branching.

Ownership split with the engine: this class owns *allocation* (host-side
free list, page-table / pos mirrors, prefill scatter) and the device page
pools; the engine drives the decode step, passing :meth:`device_cache` in,
and the step writes each new token's K/V into the pools in place (the
reference's jitted step donated the pools and returned new ones).  The
page table and positions stay authoritative on the host and are uploaded
each step (a few hundred bytes).  The pool dict is AGAS-registered.

Performance counters::

    /serve{<name>}/pages/in_use        gauge
    /serve{<name>}/pages/capacity      gauge
    /serve{<name>}/pages/allocated     cumulative
    /serve{<name>}/pages/freed         cumulative
    /serve{<name>}/pages/alloc_failures cumulative
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import agas as _agas
from repro_torch.core import counters as _counters

_POOL_KEYS = ("k", "v", "k0", "v0")  # k0/v0: the leading dense layers' pools


def _scatter_pages(pool: torch.Tensor, src: torch.Tensor,
                   page_ids: torch.Tensor) -> None:
    """pool (L,P,page,KV,Dh) ← src (L,npg,page,KV,Dh) at pages ``page_ids``.

    The reference's jitted scatter donated the pool buffer and returned a
    new one; the port writes into the pool in place (an indexed copy), so
    no second pool-sized buffer ever exists."""
    pool[:, page_ids] = src.to(pool.dtype)


class PagedKVCache:
    """Fixed-page block pool + free list + per-slot page tables."""

    def __init__(self, model, *, num_pages: int, page_size: int,
                 max_batch: int, max_pages_per_req: int,
                 name: str = "engine#0"):
        if num_pages < 2:
            raise ValueError("need at least the scratch page plus one")
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_batch = max_batch
        self.max_pages_per_req = max_pages_per_req
        self.device = model.device
        specs = model.paged_cache_specs(num_pages, page_size, max_batch,
                                        max_pages_per_req)
        self.pools: Dict[str, torch.Tensor] = {
            k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
            for k, s in specs.items() if k in _POOL_KEYS
        }
        # host-authoritative mirrors (admission mutates them between steps)
        self.page_table = np.zeros((max_batch, max_pages_per_req), np.int32)
        self.pos = np.zeros((max_batch,), np.int32)
        # LIFO free list; page 0 reserved as the idle-slot scratch page
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {i: [] for i in range(max_batch)}

        reg = _counters.default()
        self.g_in_use = reg.gauge(f"/serve{{{name}}}/pages/in_use")
        self.g_capacity = reg.gauge(f"/serve{{{name}}}/pages/capacity")
        self.g_capacity.set(float(num_pages - 1))
        self.c_alloc = reg.counter(f"/serve{{{name}}}/pages/allocated")
        self.c_freed = reg.counter(f"/serve{{{name}}}/pages/freed")
        self.c_fail = reg.counter(f"/serve{{{name}}}/pages/alloc_failures")
        self.gid = _agas.default().register(self.pools, name=None,
                                            placement=str(self.device))

    def close(self) -> None:
        """Drop the pools' AGAS record, which otherwise holds them for the
        life of the process."""
        reg = _agas.default()
        if reg.contains(self.gid):
            reg.unregister(self.gid)

    # ------------------------------------------------------------ free list
    def free_pages(self) -> int:
        return len(self._free)

    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def _take(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            self.c_fail.increment()
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.c_alloc.increment(n)
        self.g_in_use.set(float(self.pages_in_use()))
        return pages

    # ------------------------------------------------------------ slot api
    def admit(self, slot: int, prefill_cache: Dict[str, torch.Tensor],
              length: int) -> bool:
        """Bind ``slot`` to a freshly prefilled request: allocate pages for
        its ``length`` valid tokens and scatter the (possibly right-padded)
        prefill K/V into them.  Returns False if the pool is exhausted
        (caller retries after the next completion frees pages)."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} still owns pages")
        npg = -(-length // self.page_size)  # ceil
        if npg > self.max_pages_per_req:
            return False
        pages = self._take(npg)
        if pages is None:
            return False
        ids = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        n = npg * self.page_size
        for key, pool in self.pools.items():
            src = prefill_cache[key][:, 0]  # (L, S_bucket, KV, Dh)
            L, S, KV, Dh = src.shape
            if n > S:
                src = F.pad(src, (0, 0, 0, 0, 0, n - S))
            src = src[:, :n].reshape(L, npg, self.page_size, KV, Dh)
            _scatter_pages(pool, src, ids)
        self._owned[slot] = pages
        self.page_table[slot, :] = 0
        self.page_table[slot, :npg] = pages
        self.pos[slot] = length
        return True

    def ensure_next_token(self, slot: int) -> bool:
        """Make sure the page holding token index ``pos[slot]`` exists.
        Returns False when the slot can no longer grow (page-table capacity
        or pool exhaustion) — the engine finishes the request."""
        idx = int(self.pos[slot]) // self.page_size
        owned = self._owned[slot]
        if idx < len(owned):
            return True
        if idx >= self.max_pages_per_req:
            return False
        pages = self._take(1)
        if pages is None:
            return False
        owned.append(pages[0])
        self.page_table[slot, idx] = pages[0]
        return True

    def release(self, slot: int) -> None:
        """Return the slot's pages to the free list (admission churn path)."""
        pages, self._owned[slot] = self._owned[slot], []
        if pages:
            self._free.extend(reversed(pages))
            self.c_freed.increment(len(pages))
            self.g_in_use.set(float(self.pages_in_use()))
        self.page_table[slot, :] = 0
        self.pos[slot] = 0

    # ------------------------------------------------------- migration i/o
    def snapshot_slot(self, slot: int) -> Dict[str, Any]:
        """Host copy of one slot's live KV state: the pages it owns (in
        page-table order) gathered out of every pool, plus its position.
        This is the unit live engine migration ships — pages for *live
        tokens only*, never the whole pool.  The copy to the host is
        blocking: the snapshot is whole when this returns."""
        pages = self._owned[slot]
        out: Dict[str, Any] = {"pos": int(self.pos[slot]), "pages": {},
                               "n_pages": len(pages)}
        if pages:
            ids = torch.as_tensor(pages, dtype=torch.long, device=self.device)
            out["pages"] = {k: pool[:, ids].cpu() for k, pool in self.pools.items()}
        return out

    def restore_slot(self, slot: int, snap: Dict[str, Any]) -> bool:
        """Re-home a snapshotted slot into *this* pool: take fresh pages
        from the free list (page ids are locality-local — only the contents
        travel) and write the shipped KV into them in place.  Returns False
        when this pool cannot hold the slot (the caller must not have
        dropped the source yet).

        The writes are enqueued on this thread's current stream; the
        stream is synchronized before returning, so the first decode step
        after the engine resumes — on another thread, maybe another
        stream — reads the restored pages."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} still owns pages")
        npg = int(snap["n_pages"])
        if npg == 0:
            self.pos[slot] = snap["pos"]
            return True
        if npg > self.max_pages_per_req:
            return False
        pages = self._take(npg)
        if pages is None:
            return False
        ids = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for key, pool in self.pools.items():
            _scatter_pages(pool, torch.as_tensor(snap["pages"][key]).to(self.device), ids)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._owned[slot] = pages
        self.page_table[slot, :] = 0
        self.page_table[slot, :npg] = pages
        self.pos[slot] = snap["pos"]
        return True

    # ------------------------------------------------------------- step i/o
    def device_cache(self) -> Dict[str, torch.Tensor]:
        """What the paged decode step consumes: the pools, and the page
        table / positions uploaded from the host mirrors."""
        cache = dict(self.pools)
        cache["page_table"] = torch.from_numpy(self.page_table.copy()).to(self.device)
        cache["pos"] = torch.from_numpy(self.pos.copy()).to(self.device)
        return cache
