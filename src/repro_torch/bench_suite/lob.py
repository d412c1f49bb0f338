"""G. Limit Order Book (paper §VI.G).

Port of the JAX package's ``bench_suite/lob.py``. Multi-symbol matching
engine: 256 symbols, each with a 100-level ascending price-level list
holding per-level order queues; 500 order updates per symbol per
iteration. Items = symbols (disjoint books → conflict-free across tasks;
sequential chain within).

A symbol's level search depends on its level list and the update's price
only, never on the book, so the port walks the 500 searches' bounded hops
together, then applies the updates one after another as the JAX
package's scan does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite.common import Benchmark, gather, register, to_device
from repro_torch.core.deps import MemoryTrace

N_SYMBOLS = 256
N_LEVELS = 100
N_UPDATES = 500
SEARCH_HOPS = 12  # skip-ish search budget per update


def build(seed=6, device=None):
    rng = np.random.default_rng(seed)
    # per symbol: level order (sorted ascending) as next-pointers
    nxt = np.tile(np.arange(1, N_LEVELS + 1, dtype=np.int32), (N_SYMBOLS, 1))
    nxt[:, -1] = -1
    qty = rng.integers(0, 50, (N_SYMBOLS, N_LEVELS)).astype(np.float32)
    updates_price = rng.integers(0, N_LEVELS, (N_SYMBOLS, N_UPDATES)).astype(np.int32)
    updates_qty = rng.integers(-5, 6, (N_SYMBOLS, N_UPDATES)).astype(np.float32)
    data = to_device({"nxt": nxt, "qty": qty, "up_p": updates_price, "up_q": updates_qty,
                      "sym": np.arange(N_SYMBOLS, dtype=np.int32)}, device)
    data["_np"] = {"up_p": updates_price}
    return data


def item_fn(data):
    def fn(s):
        nxt = gather(data["nxt"], s)
        price, dq = gather(data["up_p"], s), gather(data["up_q"], s)
        # linked search from best price toward each update's price (bounded hops)
        lvl = torch.zeros_like(price)
        for _ in range(SEARCH_HOPS):
            nx = nxt[torch.clamp(lvl, min=0)]
            lvl = torch.where((nx >= 0) & (nx <= price), nx, lvl)
        book = gather(data["qty"], s)
        for lv, q in zip(lvl.unbind(0), dq.unbind(0)):
            book = torch.clamp(book.index_put((lv,), q, accumulate=True), min=0.0)
        return book.sum()

    return fn


def items(data):
    return data["sym"]


def cost(data):
    # per symbol: 500 sequential updates × bounded search chain
    return dict(
        flops=N_UPDATES * 8.0,
        bytes=N_UPDATES * SEARCH_HOPS * 16.0,
        chain=N_UPDATES * SEARCH_HOPS // 4,
        vector=True,
    )


def trace(data) -> MemoryTrace:
    """Writes = (symbol, level) slots each task updates — disjoint across
    symbols, the conflict-free case the paper's checker must PASS."""
    up_p = data["_np"]["up_p"]
    reads, writes = [], []
    for s in range(N_SYMBOLS):
        lv = np.unique(up_p[s])
        addr = s * N_LEVELS + lv
        reads.append(addr)
        writes.append(addr)
    return MemoryTrace(reads=reads, writes=writes)


register(
    Benchmark(
        name="LOB",
        domain="high-frequency trading",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
        trace=trace,
    )
)
