"""KV-cache pools for continuous batching: slotted and block-paged.

Port of the JAX package's ``serve/kv_cache.py``. ``SlotKVCache`` owns a fixed
pool of ``max_batch`` decode-cache slots; ``PagedKVCache`` maps
``max_batch`` decode rows through per-row block tables into a pool of
fixed-size blocks (attention families only: the model refuses to page
an SSM state), with a prefix trie that lets prompts sharing a prefix
alias the same immutable blocks (``PREFIX_FAMILIES`` only: a MoE suffix
routes with another capacity than its cold prompt, and VLM patch rows are
not token-addressable). Pool tensors live on the model's device
and are updated in place; block tables and lengths are host numpy, with
device copies refreshed only when they change (``kernel_inputs``).
Speculation rewinds both pools by the rejected tail (``truncate_row``,
``truncate_rows``); preemption evicts a row (``preempt_row``), the paged
pool first parking its committed full blocks in the trie so that the
resume recomputes only the partial tail block.

On a serving mesh (``PagedKVCache(mesh=)``) each rank allocates only its
shard of the pool: its kv heads over the ``"model"`` axis, its blocks over
the ``"seq"`` axis. The allocator, tables and lengths are host data every
rank keeps alike (every rank runs the same schedule); ``_slot`` lays the
allocator's ids out over the seq shards so that each shard ends in one
scratch slot no id maps to, and ``local_table_view`` turns the replicated
tables into a rank's view of its shard. Every rank runs the same
unsharded prefill and writes only its own shard (``write_prefill``); a
prefix hit gathers the chain's rows from their owners (``gather_prefix``).

The compiled steps (``models/step_graph.py``) capture state by address,
so an engine keeps its state in a ``StateStorage`` and each pool it makes
takes its tensors from there (``storage=``): a pool takes the storage of
its shape when no other live pool holds it, zeroed as a new one would be,
and allocates its own otherwise. The reference builds fresh caches for
every scheduler; a jit trace binds no address.
"""
from __future__ import annotations

import bisect
import math
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.models.attention import dequantize_kv
from repro_torch.models.model import PREFIX_FAMILIES
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import mesh_shape
from repro_torch.serve.block import BlockAllocator, PrefixCache


def local_table_view(tables, nb_loc: int, rank: int):
    """A rank's view of the replicated block tables under the kv-sequence
    split. ``PagedKVCache`` lays slots out in contiguous shards of
    ``nb_loc`` slots, each ending in a scratch slot no id maps to; rank
    ``rank`` owns global slots [rank·nb_loc, (rank+1)·nb_loc). Owned
    entries become their in-shard offset, every other entry the rank's
    scratch slot ``nb_loc - 1``: a safe source (its positions are skipped
    through ``owned``) and a safe write target (the owner writes the real
    row, every other rank its scratch). Returns (local tables [B, MB] in
    the tables' dtype, owned [B, MB] bool)."""
    owned = torch.div(tables, nb_loc, rounding_mode="floor") == rank
    local = torch.where(owned, tables % nb_loc, torch.full_like(tables, nb_loc - 1))
    return local, owned


def _zeroed(tree):
    """Zero every tensor of a nested cache dict in place; returns it."""
    for v in tree.values():
        if isinstance(v, dict):
            _zeroed(v)
        else:
            v.zero_()
    return tree


class StateStorage:
    """Address-stable state for the compiled steps: the slot caches,
    paged pools, draft caches and chunked prefill's staging caches that the
    schedulers of one engine serve on, so that every serve (and
    ``prime()``) reuses the same storage and the same captured graphs.

    ``take(key, holder, make)`` gives ``holder`` the storage kept under
    ``key`` when no other live holder has it (zeroed in place, as a fresh
    allocation would be), else a fresh ``make()`` that it does not keep; a
    holder is held by weak reference, so a finished scheduler's pools go
    back with it. ``staging`` / ``give_back`` keep a free list of batch-1
    dense caches a length."""

    def __init__(self):
        self._held: dict = {}  # key → (tensors, weakref to holder)
        self._free: dict = {}  # (model, max_seq) → free batch-1 caches

    def take(self, key, holder, make):
        got = self._held.get(key)
        if got is not None and got[1]() is not None:
            return make()
        tensors = make() if got is None else _zeroed(got[0])
        self._held[key] = (tensors, weakref.ref(holder))
        return tensors

    def staging(self, model, max_seq: int):
        """A zeroed batch-1 dense cache of ``max_seq`` (``len`` 0)."""
        free = self._free.get((model, int(max_seq)))
        return _zeroed(free.pop()) if free else model.init_cache(1, int(max_seq))

    def give_back(self, model, max_seq: int, cache) -> None:
        self._free.setdefault((model, int(max_seq)), []).append(cache)


class SlotKVCache:
    """Fixed pool of cache slots: allocate on admit, free on finish. The
    pool is the model's decode cache (k/v rows, or the SSM family's
    per-layer states) in ``dtype`` (the model's by default); ``write``
    replaces a slot's leaves whole and refuses a slot cache whose leaves do
    not match the pool's. ``storage``: a ``StateStorage`` to take the
    pool's tensors from."""

    def __init__(self, model, max_batch: int, max_seq: int, dtype=None, *, storage=None):
        self.model = model
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")

        def make():
            return model.init_cache(self.max_batch, self.max_seq, dtype=dtype)

        self.cache = (make() if storage is None else
                      storage.take(("slot", self.max_batch, self.max_seq, dtype), self, make))
        self._free: list[int] = list(range(self.max_batch))  # ascending
        self._owner: list[Optional[int]] = [None] * self.max_batch  # slot → rid

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return self.max_batch - len(self._free)

    @property
    def occupancy(self) -> float:
        """Pool-pressure gauge in [0, 1]: the fraction of slots live (the
        slotted layout's only capacity axis)."""
        return self.n_live / self.max_batch

    def owner(self, slot: int) -> Optional[int]:
        return self._owner[slot]

    def live_mask(self) -> np.ndarray:
        """[max_batch] bool: which slots hold live requests."""
        return np.array([o is not None for o in self._owner])

    def live_slots(self) -> list[int]:
        return [i for i, o in enumerate(self._owner) if o is not None]

    def alloc(self, rid: int) -> int:
        """Claim the lowest free slot for request ``rid``."""
        if not self._free:
            raise RuntimeError("no free cache slot (pool exhausted)")
        slot = self._free.pop(0)
        self._owner[slot] = rid
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.max_batch:
            raise IndexError(f"slot {slot} out of range")
        if self._owner[slot] is None:
            raise RuntimeError(f"double free of slot {slot}")
        self._owner[slot] = None
        bisect.insort(self._free, slot)

    def write(self, slot: int, slot_cache) -> None:
        """Install a batch=1 cache (a request's prefill) into ``slot``."""
        if self._owner[slot] is None:
            raise RuntimeError(f"write into free slot {slot}")
        self.model.write_cache_slot(self.cache, slot_cache, slot)

    def read(self, slot: int):
        """Slot ``slot`` as a batch=1 cache (views into the pool)."""
        return self.model.read_cache_slot(self.cache, slot)

    # ------------------------------------------------------------------
    # speculative rollback
    def truncate_row(self, slot: int, n_rejected: int) -> None:
        """Rewind ``n_rejected`` rejected speculative entries off slot
        ``slot``: the committed length drops; the stale rows past it are
        masked off by ``len`` and overwritten by later writes."""
        if self._owner[slot] is None:
            raise RuntimeError(f"truncate of free slot {slot}")
        lens = self.cache["len"]
        lens[slot] = torch.clamp(lens[slot] - int(n_rejected), min=0)

    def truncate_rows(self, n_rejected) -> None:
        """Every row's length drops by its ``n_rejected`` [max_batch]
        entry in one update, at 0 at least (dead and just-retired rows
        pass the whole verify width, so their lengths return to the value
        before the verify and never drift)."""
        lens = self.cache["len"]
        vec = torch.as_tensor(np.asarray(n_rejected, np.int32), device=lens.device)
        self.cache["len"] = torch.clamp(lens - vec, min=0)

    # ------------------------------------------------------------------
    # preemption: the slot layout has no trie, so eviction frees the slot
    # and the resume is a cold re-prefill
    def preempt_row(self, slot: int, tokens=None) -> None:
        del tokens
        self.free(slot)

    def check_invariants(self) -> None:
        """Free and live slots partition the pool; the free list is sorted
        and duplicate-free."""
        live = {i for i, o in enumerate(self._owner) if o is not None}
        free = set(self._free)
        assert len(self._free) == len(free), "duplicate in free list"
        assert not (free & live), "slot both free and live"
        assert free | live == set(range(self.max_batch)), "slot leaked"
        assert self._free == sorted(self._free), "free list unsorted"


class PagedKVCache:
    """Block-paged KV cache with shared-prefix reuse.

    ``max_batch`` decode rows map through per-row block tables into a
    pool of ``num_blocks`` blocks of ``block_size`` tokens, plus one null
    block (id ``num_blocks``) that unowned table entries point at, so dead
    rows' writes land in scratch. Admission charges the worst-case block
    budget; physical blocks are claimed as a request reaches them, and
    prefix-shared blocks are charged once. ``dtype`` overrides the pool's
    type; ``storage``: a ``StateStorage`` to take the pool from. ``mesh``: a
    serving mesh, whose ``"model"`` axis shards the pool's kv heads and
    whose ``"seq"`` axis its blocks; this rank allocates its shard only."""

    def __init__(
        self,
        model,
        max_batch: int,
        max_seq: int,
        *,
        block_size: int = 8,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        metrics=None,
        dtype=None,
        storage=None,
        mesh=None,
    ):
        self.model = model
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.block_size = int(block_size)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_seq % self.block_size:
            raise ValueError(
                f"max_seq={max_seq} must be a multiple of block_size={block_size}"
            )
        self.blocks_per_row = self.max_seq // self.block_size
        if num_blocks is None:
            num_blocks = self.max_batch * self.blocks_per_row
        self.num_blocks = int(num_blocks)
        # The slot layout: the allocator hands out ids [0, num_blocks) and
        # the null id num_blocks; ``_slot`` maps them onto pool slots. One
        # shard: the identity (dead rows' entries point at the null slot,
        # so their writes land in scratch). A "seq" axis of sp > 1: sp
        # contiguous shards of d data slots plus one scratch slot each,
        # never the image of an id, where a rank's view sends every entry
        # it does not own (``local_table_view``).
        self.mesh = mesh
        shape = mesh_shape(mesh)
        sp, tp = shape.get("seq", 1), shape.get("model", 1)
        self.seq_shards, self.head_shards = sp, tp
        ids = self.num_blocks + 1
        arange = np.arange(ids, dtype=np.int32)
        if sp > 1:
            d = math.ceil(ids / sp)  # data slots a shard
            self._slot = ((arange // d) * (d + 1) + arange % d).astype(np.int32)
            self.total_blocks = sp * (d + 1)
        else:
            self._slot = arange
            self.total_blocks = ids
        self.null_block = int(self._slot[self.num_blocks])
        KV = model.cfg.n_kv_heads
        if KV % tp:
            raise ValueError(f"n_kv_heads={KV} does not divide the mesh's 'model' axis ({tp})")
        self.local_blocks = self.total_blocks // sp  # this rank's pool slots
        self.kv_heads = KV // tp  # this rank's kv heads
        self.seq_rank = collectives.axis_index(mesh, "seq") if sp > 1 else 0
        self.head_rank = collectives.axis_index(mesh, "model") if tp > 1 else 0

        def make():
            return model.init_paged_cache(self.local_blocks, self.block_size, dtype=dtype,
                                          kv_heads=self.kv_heads)

        key = ("paged", self.local_blocks, self.block_size, dtype, self.kv_heads)
        self.pool = make() if storage is None else storage.take(key, self, make)
        # only PREFIX_FAMILIES' suffix prefill equals a cold prefill, so
        # only their prompts may alias a shared prefix's blocks (the model's
        # prefill_with_prefix refuses the others as well)
        self.prefix = (PrefixCache(self.block_size)
                       if prefix_cache and model.cfg.family in PREFIX_FAMILIES else None)
        # an optional telemetry MetricsRegistry: the allocator records its
        # alloc/park/evict counts; None (telemetry off) records nothing
        self.allocator = BlockAllocator(
            self.num_blocks,
            on_evict=self.prefix.drop_block if self.prefix is not None else None,
            is_leaf=self.prefix.is_leaf if self.prefix is not None else None,
            metrics=metrics,
        )
        self.block_tables = np.full(
            (self.max_batch, self.blocks_per_row), self.null_block, np.int32
        )
        self.cache_len = np.zeros((self.max_batch,), np.int32)
        # kernel_inputs() device copies, refreshed by version counter:
        # tables change only on admission / tail claim / free, so a steady
        # decode step uploads only the lengths vector
        self._tables_version = 0
        self._dev_tables = None
        self._dev_tables_version = -1
        self._len_version = 0
        self._dev_len = None
        self._dev_len_version = -1
        self._row_free: list[int] = list(range(self.max_batch))  # ascending
        self._row_owner: list[Optional[int]] = [None] * self.max_batch
        self._row_blocks: list[list[int]] = [[] for _ in range(self.max_batch)]
        self._row_outstanding = [0] * self.max_batch  # reserved, unallocated
        self._outstanding_total = 0

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_size)

    # ------------------------------------------------------------------
    # occupancy (the row API mirrors SlotKVCache's)
    @property
    def n_free(self) -> int:
        return len(self._row_free)

    @property
    def n_live(self) -> int:
        return self.max_batch - len(self._row_free)

    @property
    def n_free_blocks(self) -> int:
        """Blocks an arriving request could claim now: free and
        LRU-evictable cached ones, less the live rows' reservations."""
        return self.allocator.n_available - self._outstanding_total

    @property
    def occupancy(self) -> float:
        """Pool-pressure gauge in [0, 1]: the fraction of physical blocks
        holding data (live and parked; reservations are a promise, not
        bytes)."""
        return 1.0 - self.allocator.n_free / self.num_blocks

    def owner(self, row: int) -> Optional[int]:
        return self._row_owner[row]

    def live_mask(self) -> np.ndarray:
        """[max_batch] bool: which rows hold live requests."""
        return np.array([o is not None for o in self._row_owner])

    def live_rows(self) -> list[int]:
        return [i for i, o in enumerate(self._row_owner) if o is not None]

    # ------------------------------------------------------------------
    # admission
    def lookup(self, tokens) -> list[int]:
        """Block ids of the longest cached full-block prefix of ``tokens``."""
        if self.prefix is None:
            return []
        return self.prefix.match(tokens)

    def try_admit(self, rid: int, tokens, budget: int, n_tokens: Optional[int] = None,
                  register: bool = True):
        """Admit ``rid`` into a free row if its block budget fits: returns
        (row, hit_ids) or None. Shared prefix blocks alias (refcount++),
        fresh prompt blocks are allocated now, the decode tail is only
        reserved (claimed lazily by ``ensure_tail``). ``n_tokens``: the
        cache rows the prefill fills, where they are more than ``tokens``
        (a VLM prompt's patch rows). ``register=False``
        defers the trie registration to ``register_prompt`` (chunked
        prefill: the prompt blocks hold no KV yet, and a concurrent
        admission must not alias half-written blocks)."""
        if not self._row_free:
            return None
        S = len(tokens) if n_tokens is None else int(n_tokens)
        hit_ids = self.lookup(tokens)
        n_total = self.blocks_for(S + budget)
        n_prompt = self.blocks_for(S)
        n_parked_hits = sum(self.allocator.is_parked(b) for b in hit_ids)
        # after reactivating parked hits, enough must remain for this
        # request's fresh blocks AND every live row's reservations
        need = (n_total - len(hit_ids)) + n_parked_hits
        if self.allocator.n_available < self._outstanding_total + need:
            return None
        for b in hit_ids:  # alias FIRST so eviction can't take them
            self.allocator.share(b)
        blocks = list(hit_ids)
        for _ in range(n_prompt - len(hit_ids)):
            blocks.append(self.allocator.alloc())
        row = self._row_free.pop(0)
        self._row_owner[row] = rid
        self._row_blocks[row] = blocks
        self._row_outstanding[row] = n_total - n_prompt
        self._outstanding_total += self._row_outstanding[row]
        self.block_tables[row, : len(blocks)] = self._slot[blocks]
        self.cache_len[row] = S
        self._tables_version += 1
        self._len_version += 1
        if register and self.prefix is not None:
            # the prompt's full blocks are immutable: decode never writes
            # before position S
            self.prefix.insert(tokens, blocks[: S // self.block_size])
        return row, hit_ids

    def register_prompt(self, row: int, tokens) -> None:
        """Register a live row's now-written prompt blocks in the trie
        (the deferred half of ``try_admit(register=False)``); ``tokens``
        is the prompt whose KV the row's leading blocks hold."""
        if self._row_owner[row] is None:
            raise RuntimeError(f"register_prompt on free row {row}")
        if self.prefix is None:
            return
        n_full = min(len(tokens) // self.block_size, len(self._row_blocks[row]))
        if n_full:
            self.prefix.insert(tuple(tokens)[: n_full * self.block_size],
                               self._row_blocks[row][:n_full])

    # ------------------------------------------------------------------
    # cache I/O
    def kernel_inputs(self):
        """``(pool, block_tables, cache_len)`` with tables/lengths as
        device int32 tensors — what ``Model.decode_step_paged`` and the
        paged kernel take. Pool leaves are ``[L, NB+1, BS, KV, hd]``."""
        dev = self.model.device
        if self._dev_tables_version != self._tables_version:
            self._dev_tables = torch.from_numpy(self.block_tables.copy()).to(dev)
            self._dev_tables_version = self._tables_version
        if self._dev_len_version != self._len_version:
            self._dev_len = torch.from_numpy(self.cache_len.copy()).to(dev)
            self._dev_len_version = self._len_version
        return self.pool, self._dev_tables, self._dev_len

    def _own(self, ids):
        """(local slots, owned) of allocator ``ids`` on this rank: each
        id's slot and whether this rank's seq shard holds it."""
        slots = self._slot[np.asarray(ids, np.int64)]
        own = slots // self.local_blocks == self.seq_rank
        return slots % self.local_blocks, own

    def gather_prefix(self, hit_ids: list[int]):
        """(k, v) [L, 1, h, KV, hd] — a hit chain's post-RoPE KV rows,
        gathered on the device for ``Model.prefill_with_prefix``. An int8
        pool dequantizes here with the chain's scales, to the model's dtype,
        so the suffix prefill always sees dense K/V. On a mesh each rank
        contributes the blocks and heads it holds: the seq shards sum
        (every block has one owner, the others add zeros), the head shards
        gather in head order; both are exact."""
        local, own = self._own(hit_ids)
        dev = self.model.device
        idx = torch.as_tensor(local, dtype=torch.long, device=dev)
        L, _, BS = self.pool["k"].shape[:3]
        h = len(hit_ids) * BS

        def rows(name):
            return self.pool[name][:, idx]  # [L, n, BS, KV_loc, ...]

        if "k_scale" in self.pool:
            dt = self.model.dtype
            kv = [dequantize_kv(rows(n), rows(n + "_scale"), dt) for n in ("k", "v")]
        else:
            kv = [rows("k"), rows("v")]
        if self.seq_shards > 1:
            keep = torch.as_tensor(own, device=dev).view(1, -1, 1, 1, 1)
            # the sum runs in float32: exact for every pool dtype
            kv = [collectives.all_reduce(torch.where(keep, t, torch.zeros_like(t)).float(),
                                         self.mesh, "seq").to(t.dtype) for t in kv]
        if self.head_shards > 1:
            kv = [collectives.all_gather(t, self.mesh, "model", dim=3) for t in kv]
        return tuple(t.reshape((L, 1, h) + tuple(t.shape[3:])) for t in kv)

    def write_prefill(self, row: int, dense_cache, skip_blocks: int = 0) -> None:
        """Install a request's batch=1 dense prefill cache into its fresh
        prompt blocks, on the device. ``skip_blocks`` leading blocks are a
        prefix hit — shared and immutable, so not rewritten. On a mesh the
        dense cache holds every head and this rank writes its own heads of
        the blocks its seq shard holds."""
        if self._row_owner[row] is None:
            raise RuntimeError(f"write into free row {row}")
        bs = self.block_size
        n_prompt = self.blocks_for(int(self.cache_len[row]))
        ids = self._row_blocks[row][skip_blocks:n_prompt]
        if not ids:
            return
        local, own = self._own(ids)
        if not own.any():
            return
        dev = self.model.device
        idx = torch.as_tensor(local[own], dtype=torch.long, device=dev)
        pick = torch.as_tensor(np.nonzero(own)[0], dtype=torch.long, device=dev)
        h0 = self.head_rank * self.kv_heads
        for name, leaf in self.pool.items():
            d = dense_cache[name][:, 0, skip_blocks * bs : n_prompt * bs]
            d = d.reshape((d.shape[0], len(ids), bs) + tuple(d.shape[2:]))
            d = d[:, :, :, h0 : h0 + self.kv_heads]
            leaf[:, idx] = (d if len(pick) == len(ids) else d[:, pick]).to(leaf.dtype)

    def ensure_tail(self, row: int) -> None:
        """Claim the block the row's next decode write lands in, from its
        admission reservation, if it has none yet."""
        self.ensure_tail_n(row, 1)

    def ensure_tail_n(self, row: int, n: int) -> None:
        """Claim tail blocks so that the row's next ``n`` write positions
        (a verify writes the pending token and K drafts at once) all have
        a block, from the admission reservation."""
        need = self.blocks_for(int(self.cache_len[row]) + n)
        while len(self._row_blocks[row]) < need:
            bi = len(self._row_blocks[row])
            assert bi < self.blocks_per_row
            assert self._row_outstanding[row] > 0, "tail block was not reserved"
            b = self.allocator.alloc()
            self._row_blocks[row].append(b)
            self.block_tables[row, bi] = self._slot[b]
            self._tables_version += 1
            self._row_outstanding[row] -= 1
            self._outstanding_total -= 1

    def advance(self, row: int) -> None:
        self.advance_n(row, 1)

    def advance_n(self, row: int, n: int) -> None:
        """Count ``n`` KV rows written by one step (a verify's pending
        token and K drafts); ``truncate_row`` then rewinds the rejected
        tail."""
        self.cache_len[row] += n
        self._len_version += 1

    def truncate_row(self, row: int, n_rejected: int) -> None:
        """Rewind ``n_rejected`` rejected draft rows off the row's tail:
        the length drops, and claimed tail blocks past it return to the
        allocator with their reservation restored, so a later verify can
        claim them again. A verify writes past the prompt only, so the
        rewind never reaches a shared or registered block (asserted)."""
        if self._row_owner[row] is None:
            raise RuntimeError(f"truncate of free row {row}")
        new_len = int(self.cache_len[row]) - int(n_rejected)
        assert new_len >= 0, "truncate below zero"
        self.cache_len[row] = new_len
        self._len_version += 1
        keep = self.blocks_for(new_len)
        while len(self._row_blocks[row]) > keep:
            b = self._row_blocks[row].pop()
            assert self.allocator.refcount[b] == 1 and (
                self.prefix is None or not self.prefix.registered(b)
            ), "truncate reached a shared/registered block"
            self.allocator.free(b)
            self.block_tables[row, len(self._row_blocks[row])] = self.null_block
            self._tables_version += 1
            self._row_outstanding[row] += 1
            self._outstanding_total += 1

    def free_row(self, row: int) -> None:
        """Retire a request: drop one referent per block (registered
        blocks with no referents park for future prefix hits), release
        the unclaimed reservation, reset the table row."""
        if not 0 <= row < self.max_batch:
            raise IndexError(f"row {row} out of range")
        if self._row_owner[row] is None:
            raise RuntimeError(f"double free of row {row}")
        for b in self._row_blocks[row]:
            self.allocator.free(
                b, park=self.prefix is not None and self.prefix.registered(b)
            )
        self._outstanding_total -= self._row_outstanding[row]
        self._row_outstanding[row] = 0
        self._row_blocks[row] = []
        self._row_owner[row] = None
        self.block_tables[row, :] = self.null_block
        self.cache_len[row] = 0
        self._tables_version += 1
        self._len_version += 1
        bisect.insort(self._row_free, row)

    def preempt_row(self, row: int, tokens=None) -> None:
        """Evict a live row, keeping its work: ``tokens`` (prompt and
        committed generated tokens) registers the row's full blocks in the
        trie before the row frees, so they park instead of vanishing and
        the resume prefix-matches its whole committed history. Blocks
        whose chain the trie already holds keep their first registration
        and return to the free list. Without ``tokens`` (or a trie) this
        is a plain eviction."""
        if self._row_owner[row] is None:
            raise RuntimeError(f"preempt of free row {row}")
        if self.prefix is not None and tokens is not None:
            n_full = min(len(tokens) // self.block_size, len(self._row_blocks[row]))
            if n_full:
                self.prefix.insert(tuple(tokens)[: n_full * self.block_size],
                                   self._row_blocks[row][:n_full])
        self.free_row(row)

    def drop_cached(self) -> int:
        """Evict every parked (cached, unreferenced) block, restoring the
        cold path. Returns how many were evicted."""
        n = 0
        while self.allocator.n_parked:
            self.allocator.evict(self.allocator.parked_lru()[0])
            n += 1
        return n

    def check_invariants(self) -> None:
        """Rows and blocks stay consistent: the allocator partition holds,
        tables mirror the owned-block lists, every block referent is one
        row, and reservations never exceed what the pool can provide."""
        self.allocator.check_invariants()
        live_rows = {i for i, o in enumerate(self._row_owner) if o is not None}
        free_rows = set(self._row_free)
        assert not (free_rows & live_rows), "row both free and live"
        assert free_rows | live_rows == set(range(self.max_batch)), "row leaked"
        refs = [0] * self.num_blocks
        for row in range(self.max_batch):
            blocks = self._row_blocks[row]
            if row not in live_rows:
                assert not blocks and self._row_outstanding[row] == 0
            for j, b in enumerate(blocks):
                assert self.block_tables[row, j] == self._slot[b], "table/block-list skew"
                refs[b] += 1
            assert (self.block_tables[row, len(blocks):] == self.null_block).all()
        assert refs == self.allocator.refcount, "refcounts not conserved"
        assert self._outstanding_total == sum(self._row_outstanding)
        assert self.allocator.n_available >= self._outstanding_total
