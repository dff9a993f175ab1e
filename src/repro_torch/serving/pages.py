"""Paged KV-cache bookkeeping: a fixed page pool + per-request page tables
(a copy of ``repro.serving.pages``; numpy only).

The paged serving engine stores every *length-scaling* cache leaf (the full
KV buffers of global-attention layers) in one flat pool of fixed-size pages
instead of one dense ``(batch, ..., max_len, ...)`` buffer per decode slot.
A :class:`PageTable` maps each live request to an ordered page list; token
position ``t`` of a request lives at pool row ``pages[t // page_size] *
page_size + t % page_size``.  Decode gathers each lane's rows into a dense
per-lane view (so the model's decode step is *numerically identical* to the
contiguous cache) and scatters only the newly written row back.

Page 0 is reserved as the *trash page*: inactive decode lanes and
positions beyond a request's allocation map to it, so masked writes need no
branches — garbage lands in rows nothing ever attends to.

Ring (windowed) and recurrent-state leaves are O(window)/O(1) per lane and
stay dense per lane — paging them would buy nothing.
"""
from __future__ import annotations

import numpy as np


class PagesExhausted(RuntimeError):
    """Raised when an allocation needs more pages than the pool has free —
    the engine's preemption signal (evict a request or defer the work)."""


class PageTable:
    """Fixed pool of ``num_pages`` pages of ``page_size`` token slots each.

    Page 0 is reserved (the trash page); ``usable_pages`` is what requests
    can actually hold.  Allocation is deterministic — lowest-numbered free
    page first — so identical request streams produce identical layouts.
    """

    TRASH_PAGE = 0

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(1, num_pages))  # kept sorted
        self._pages: dict[int, list[int]] = {}             # uid -> page list
        self.allocs = 0
        self.releases = 0
        self.defrags = 0

    # -- accounting -----------------------------------------------------------
    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    @property
    def capacity_tokens(self) -> int:
        """Token slots the pool can hold (trash page excluded)."""
        return self.usable_pages * self.page_size

    def pages(self, uid: int) -> list[int]:
        return list(self._pages.get(uid, ()))

    def holders(self) -> list[int]:
        """uids currently holding pages (insertion order)."""
        return list(self._pages)

    def held_tokens(self, uid: int) -> int:
        """Token capacity of the pages ``uid`` holds."""
        return len(self._pages.get(uid, ())) * self.page_size

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` token slots."""
        return -(-max(tokens, 0) // self.page_size)

    # -- alloc / free ----------------------------------------------------------
    def ensure(self, uid: int, tokens: int) -> list[int]:
        """Grow ``uid``'s allocation to cover ``tokens`` token positions.

        Returns the pages newly allocated (empty when already covered).
        Raises :class:`PagesExhausted` — without allocating anything — when
        the pool cannot satisfy the growth.
        """
        have = self._pages.setdefault(uid, [])
        need = self.pages_for(tokens) - len(have)
        if need <= 0:
            return []
        if need > len(self._free):
            if not have:
                del self._pages[uid]
            raise PagesExhausted(
                f"uid {uid} needs {need} pages, {len(self._free)} free")
        new = self._free[:need]
        del self._free[:need]
        have.extend(new)
        self.allocs += len(new)
        return new

    def release(self, uid: int) -> int:
        """Free every page ``uid`` holds; returns the count freed."""
        pages = self._pages.pop(uid, [])
        if pages:
            self._free.extend(pages)
            self._free.sort()
            self.releases += len(pages)
        return len(pages)

    # -- pool-row addressing ---------------------------------------------------
    def flat_rows(self, uid: int, length: int) -> np.ndarray:
        """Pool-flat row index per token position ``0..length-1``.

        Positions beyond ``uid``'s allocation (or of an unknown uid) map to
        the trash page — the caller masks them, so any value is safe.
        """
        ps = self.page_size
        rows = np.zeros(length, np.int32)  # trash rows by default
        pages = self._pages.get(uid)
        if not pages:
            return rows
        pos = np.arange(length)
        page_idx = pos // ps
        valid = page_idx < len(pages)
        page_arr = np.asarray(pages, np.int32)
        rows[valid] = page_arr[page_idx[valid]] * ps + (pos[valid] % ps)
        return rows

    # -- fragmentation ---------------------------------------------------------
    def fragmentation(self) -> float:
        """1 − (longest contiguous free run / free pages): 0.0 when the free
        space is one block (or empty), approaching 1.0 when it is shredded
        into single pages — the gauge the defragmenter watches."""
        if not self._free:
            return 0.0
        longest = run = 1
        for a, b in zip(self._free, self._free[1:]):
            run = run + 1 if b == a + 1 else 1
            longest = max(longest, run)
        return 1.0 - longest / len(self._free)

    def defrag(self) -> list[tuple[int, int]]:
        """Compact allocations into the lowest page numbers.

        Only pages *above* the compaction watermark move, and they move into
        pages that are currently free — so the returned ``(src, dst)`` moves
        never overwrite live data and may be applied in any order (the owner
        of the physical pool copies src rows over dst rows).  The table is
        already rewritten when this returns; allocation order per request is
        preserved, so ``flat_rows`` stays position-consistent.
        """
        used = [p for pages in self._pages.values() for p in pages]
        k = len(used)
        target = set(range(1, k + 1))
        dst_slots = sorted(target.difference(used))     # free low pages
        movers = sorted(p for p in used if p > k)       # high pages to move
        mapping = dict(zip(movers, dst_slots))
        moves = sorted(mapping.items())
        if moves:
            for pages in self._pages.values():
                for i, p in enumerate(pages):
                    if p in mapping:
                        pages[i] = mapping[p]
            self.defrags += 1
        self._free = list(range(k + 1, self.num_pages))
        return moves

    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "used_pages": self.used_pages,
            "free_pages": self.free_pages,
            "holders": len(self._pages),
            "fragmentation": self.fragmentation(),
            "allocs": self.allocs,
            "releases": self.releases,
            "defrags": self.defrags,
        }
