"""Paged KV-cache bookkeeping (copy of ``repro.serving.kvcache``).

Each layer's K and V live in ``(n_pages, page_size, n_kv_heads, head_dim)``
pools shared by every slot (allocated by ``models.transformer.
init_paged_cache``; this module only does the bookkeeping). Pages are
granted on demand from a free list and reclaimed wholesale on finish,
preemption, shedding, cancellation and recovery. The
host page table ``(n_slots + 1, max_pages)`` int32 maps (slot, page index)
to a physical page; unmapped entries and the whole sentinel row ``n_slots``
(packed-step padding tokens) carry ``n_pages``. Position ``p`` of a slot
lives at entry ``p // page_size``, offset ``p % page_size``, so a slot's
pages in list order are its contiguous buffer, virtually.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PagedKVCache", "pages_for"]


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache positions."""
    return -(-max(int(n_tokens), 0) // page_size)


class PagedKVCache:
    """Host-side page allocator + slot page tables for the paged KV cache."""

    def __init__(self, n_slots: int, page_size: int, n_pages: int,
                 max_pages: int, page_bytes: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages < max_pages:
            raise ValueError(
                f"pool of {n_pages} pages cannot hold one full slot "
                f"({max_pages} pages): admission could never complete any "
                f"near-capacity request")
        self.S = n_slots
        self.ps = page_size
        self.P = n_pages
        self.max_pages = max_pages
        self.page_bytes = page_bytes     # device bytes per page (all layers)
        # LIFO free list arranged so fresh pools allocate page 0 first
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]
        self.page_table = np.full((n_slots + 1, max_pages), n_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.P - len(self._free)

    @property
    def used_bytes(self) -> int:
        return self.used_pages * self.page_bytes

    @property
    def total_bytes(self) -> int:
        return self.P * self.page_bytes

    def slot_pages(self, slot: int) -> tuple:
        return tuple(self._slot_pages[slot])

    def pages_needed(self, slot: int, new_len: int) -> int:
        """Additional pages slot needs to hold ``new_len`` tokens."""
        return max(pages_for(new_len, self.ps) - len(self._slot_pages[slot]),
                   0)

    def grant(self, slot: int, new_len: int) -> bool:
        """Grow slot's granted capacity to ``new_len`` tokens. All-or-
        nothing: False (allocating nothing) when the free list falls short."""
        total = pages_for(new_len, self.ps)
        if total > self.max_pages:
            raise ValueError(
                f"slot {slot} would need {total} pages for {new_len} tokens "
                f"(> max_pages={self.max_pages}): admission should have "
                f"rejected this request")
        need = total - len(self._slot_pages[slot])
        if need > len(self._free):
            return False
        for _ in range(max(need, 0)):
            pid = self._free.pop()
            j = len(self._slot_pages[slot])
            self._slot_pages[slot].append(pid)
            self.page_table[slot, j] = pid
        return True

    def release(self, slot: int) -> int:
        """Return all of slot's pages to the free list."""
        pages = self._slot_pages[slot]
        n = len(pages)
        self._free.extend(reversed(pages))
        self._slot_pages[slot] = []
        self.page_table[slot, :] = self.P
        return n

    def release_all(self) -> int:
        return sum(self.release(i) for i in range(self.S))
