"""Block pool and prefix trie for the paged KV cache.

The paper's thesis is that latency-critical code lives or dies by its
memory behavior: Relic microtasks only pay off once cache misses are
under control. At serving scale the analogous resource is KV-cache
memory — a slot-granular pool reserves ``max_seq`` tokens per request
(worst-case footprint) and recomputes identical prompt prefixes per
request. This module provides the two pieces that fix both:

* ``BlockAllocator`` — a fixed pool of fixed-size cache blocks with
  per-block refcounts. Blocks are *live* (refcount > 0), *free*, or
  *parked*: a parked block has no referents but still holds reusable
  prefix data, sitting in an LRU bench from which ``alloc`` evicts when
  the free list runs dry. Evicting a referenced block is impossible by
  construction (the property tests pin this).

* ``PrefixCache`` — a trie over block-granular token keys. Each node is
  one immutable, fully-written block of some request's prompt;
  ``match`` walks the longest chain of cached blocks equal to a new
  prompt's prefix so the scheduler can alias them (refcount++) instead
  of recomputing, and ``insert`` registers a new prompt's full blocks
  for future requests. Dropping a block drops its whole subtree — a
  child block's data is only addressable through its parent chain.

Shared blocks are immutable: the scheduler never hands out a partially
filled ("divergence") block for sharing, so decode writes always land
in blocks owned by exactly one request — copy-on-write realized as
*copy-on-join* (a joining request recomputes its divergence block
rather than mutating a shared one). See DESIGN.md §3.
"""
from __future__ import annotations

import bisect
from typing import Callable, Optional


class BlockAllocator:
    """Refcounted fixed pool of KV-cache blocks with LRU eviction of
    parked (unreferenced but data-bearing) blocks."""

    def __init__(
        self,
        num_blocks: int,
        on_evict: Optional[Callable] = None,
        is_leaf: Optional[Callable] = None,
        metrics=None,
    ):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        self.num_blocks = int(num_blocks)
        self.refcount = [0] * self.num_blocks
        self._free: list[int] = list(range(self.num_blocks))  # ascending
        self._parked: dict[int, int] = {}  # block → park tick (LRU order)
        self._tick = 0
        # on_evict(block) → iterable of *descendant* parked blocks that
        # become unreachable and must be evicted too (set by PrefixCache)
        self.on_evict = on_evict
        # is_leaf(block) → True when evicting the block cannot cascade;
        # alloc() prefers such victims so reclaiming ONE block never
        # destroys a whole cached prefix chain (prefix hit rates degrade
        # from the divergence tails inward, not root-first)
        self.is_leaf = is_leaf
        # optional telemetry.MetricsRegistry (DESIGN.md §8): alloc /
        # park / evict rates. Counter handles are cached here so
        # the instrumented path is one predictable branch + inc; with
        # metrics=None (telemetry off) nothing is recorded.
        self._m_alloc = metrics.counter("pool.alloc") if metrics else None
        self._m_park = metrics.counter("pool.park") if metrics else None
        self._m_evict = metrics.counter("pool.evict") if metrics else None

    # ------------------------------------------------------------------
    # occupancy
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_parked(self) -> int:
        return len(self._parked)

    @property
    def n_live(self) -> int:
        return self.num_blocks - self.n_free - self.n_parked

    @property
    def n_available(self) -> int:
        """Blocks obtainable by ``alloc`` right now: free + evictable."""
        return self.n_free + self.n_parked

    def is_parked(self, block: int) -> bool:
        return block in self._parked

    def parked_lru(self) -> list[int]:
        """Parked blocks, least-recently-parked first (eviction order)."""
        return sorted(self._parked, key=self._parked.get)

    # ------------------------------------------------------------------
    # lifecycle
    def alloc(self) -> int:
        """Claim a fresh block (refcount 1): lowest free block, else evict
        the least-recently-parked *leaf* block (oldest parked overall
        when no leaf oracle is installed) and reuse it."""
        if not self._free and self._parked:
            lru = self.parked_lru()
            victim = next(
                (b for b in lru if self.is_leaf is None or self.is_leaf(b)), lru[0]
            )
            self.evict(victim)
        if not self._free:
            raise RuntimeError(
                f"no free KV block ({self.n_live} live, 0 parked, "
                f"pool={self.num_blocks})"
            )
        block = self._free.pop(0)
        self.refcount[block] = 1
        if self._m_alloc is not None:
            self._m_alloc.inc()
        return block

    def share(self, block: int) -> None:
        """Add a referent to ``block``. Reactivates a parked block (a
        prefix hit on a retired request's prompt); sharing a free block
        is a bug."""
        self._check_range(block)
        if self.refcount[block] == 0:
            if block not in self._parked:
                raise RuntimeError(f"sharing free block {block}")
            del self._parked[block]
        self.refcount[block] += 1

    def free(self, block: int, park: bool = False) -> None:
        """Drop one referent. At refcount 0 the block returns to the free
        list, or — with ``park=True`` (it is registered in a prefix
        trie) — to the LRU bench, evictable but still reusable."""
        self._check_range(block)
        if self.refcount[block] <= 0:
            raise RuntimeError(f"double free of block {block}")
        self.refcount[block] -= 1
        if self.refcount[block] == 0:
            if park:
                self._tick += 1
                self._parked[block] = self._tick
                if self._m_park is not None:
                    self._m_park.inc()
            else:
                bisect.insort(self._free, block)

    def evict(self, block: int) -> None:
        """Reclaim a parked block (and any parked descendants its trie
        drop reports). Evicting a referenced block is impossible."""
        self._check_range(block)
        if self.refcount[block] > 0:
            raise RuntimeError(
                f"evicting block {block} with refcount {self.refcount[block]}"
            )
        if block not in self._parked:
            raise RuntimeError(f"evicting block {block} that is not parked")
        cascade = [block]
        if self.on_evict is not None:
            cascade += [b for b in self.on_evict(block) if b != block]
        for b in cascade:
            if b in self._parked:  # descendants are parked by closure
                del self._parked[b]
                bisect.insort(self._free, b)
                if self._m_evict is not None:
                    self._m_evict.inc()

    def _check_range(self, block: int) -> None:
        if not 0 <= block < self.num_blocks:
            raise IndexError(f"block {block} out of range")

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """{live, parked, free} partition the pool; refcounts are never
        negative; parked blocks are exactly the refcount-0 non-free ones;
        the free list is sorted and duplicate-free."""
        free = set(self._free)
        parked = set(self._parked)
        live = {b for b in range(self.num_blocks) if self.refcount[b] > 0}
        assert len(self._free) == len(free), "duplicate in free list"
        assert self._free == sorted(self._free), "free list unsorted"
        assert all(r >= 0 for r in self.refcount), "negative refcount"
        assert not (free & parked), "block both free and parked"
        assert not (free & live), "block both free and referenced"
        assert not (parked & live), "block both parked and referenced"
        assert free | parked | live == set(range(self.num_blocks)), "block leaked"


class _TrieNode:
    __slots__ = ("key", "block", "parent", "children")

    def __init__(self, key, block, parent):
        self.key = key  # tuple of this block's tokens
        self.block = block  # block id holding this node's KV rows
        self.parent = parent
        self.children: dict[tuple, "_TrieNode"] = {}


class PrefixCache:
    """Trie of immutable prompt blocks, keyed block-by-block on tokens."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._root = _TrieNode(None, None, None)
        self._by_block: dict[int, _TrieNode] = {}

    @property
    def n_blocks(self) -> int:
        return len(self._by_block)

    def registered(self, block: int) -> bool:
        return block in self._by_block

    def is_leaf(self, block: int) -> bool:
        """True when evicting ``block`` cannot cascade: it has no trie
        children (an unregistered block trivially qualifies). A parked
        node's children are themselves parked (refcounts are monotone
        down a chain), so evicting leaves first shrinks cached chains
        from their divergence tails inward."""
        node = self._by_block.get(block)
        return node is None or not node.children

    # ------------------------------------------------------------------
    def _keys(self, tokens, n_blocks: int):
        bs = self.block_size
        return [tuple(tokens[j * bs : (j + 1) * bs]) for j in range(n_blocks)]

    def match(self, tokens) -> list[int]:
        """Block ids of the longest cached chain equal to a prefix of
        ``tokens``. Capped at ``(len(tokens) - 1) // block_size`` blocks:
        at least one suffix token must remain to prefill, so the request
        has logits to sample its first token from."""
        out: list[int] = []
        node = self._root
        for key in self._keys(tokens, (len(tokens) - 1) // self.block_size):
            child = node.children.get(key)
            if child is None:
                break
            out.append(child.block)
            node = child
        return out

    def insert(self, tokens, block_ids) -> None:
        """Register a prompt's immutable blocks: ``block_ids[j]`` holds
        tokens ``[j*bs, (j+1)*bs)``. Only blocks the request will never
        write into may be passed (full blocks strictly before the decode
        write position). Chains already present keep their first
        registration — a duplicate block stays private to its request."""
        node = self._root
        for key, block in zip(self._keys(tokens, len(block_ids)), block_ids):
            child = node.children.get(key)
            if child is None:
                if block in self._by_block:
                    raise RuntimeError(f"block {block} registered twice")
                child = _TrieNode(key, block, node)
                node.children[key] = child
                self._by_block[block] = child
            node = child

    def drop_block(self, block: int) -> list[int]:
        """Remove ``block``'s node and its whole subtree (children are
        unreachable without their parent chain). Returns the descendant
        block ids so the allocator can evict them in cascade."""
        node = self._by_block.get(block)
        if node is None:
            return []
        del node.parent.children[node.key]
        dropped: list[int] = []
        stack = [node]
        while stack:
            n = stack.pop()
            del self._by_block[n.block]
            if n.block != block:
                dropped.append(n.block)
            stack.extend(n.children.values())
        return dropped
