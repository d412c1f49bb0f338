"""H. IP Address Geolocation (paper §VI.H).

Port of the JAX package's ``bench_suite/geoip.py``. Binary trie over IPv4
prefixes: each node tests one bit; longest-prefix match returns a
location id. Items = a batch of IP lookups (paper: 10⁶ per iteration;
8192 here, as in the JAX package — structure and per-item cost are
unchanged). The addresses are int32, wrapped from their 32-bit values as
the JAX package's ``jnp.asarray`` stores them; the bit tests read the
same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite.common import Benchmark, gather, register, to_device

N_PREFIXES = 4096
N_IPS = 8192
MAX_DEPTH = 24


def build(seed=7, device=None):
    rng = np.random.default_rng(seed)
    # insert random prefixes (8..24 bits) into an array trie
    left = [-1]
    right = [-1]
    value = [0]

    def insert(prefix, plen, val):
        node = 0
        for d in range(plen):
            bit = (prefix >> (31 - d)) & 1
            child = right[node] if bit else left[node]
            if child == -1:
                left.append(-1)
                right.append(-1)
                value.append(value[node])
                child = len(left) - 1
                if bit:
                    right[node] = child
                else:
                    left[node] = child
            node = child
        value[node] = val

    for i in range(N_PREFIXES):
        plen = int(rng.integers(8, MAX_DEPTH + 1))
        prefix = int(rng.integers(0, 2**32)) & (~((1 << (32 - plen)) - 1))
        insert(prefix, plen, int(rng.integers(1, 256)))

    ips = rng.integers(0, 2**32, N_IPS, dtype=np.uint32).astype(np.int64)
    return to_device({
        "left": np.asarray(left, np.int32),
        "right": np.asarray(right, np.int32),
        "value": np.asarray(value, np.int32),
        "ips": ips,
    }, device)


def item_fn(data):
    left, right, value = data["left"], data["right"], data["value"]

    def fn(ip):
        node = torch.zeros((), dtype=torch.int32, device=ip.device)
        best = torch.zeros((), dtype=torch.int32, device=ip.device)
        for d in range(MAX_DEPTH):
            bit = (ip >> (31 - d)) & 1
            nv = torch.clamp(node, min=0)
            nxt = torch.where(bit == 1, gather(right, nv), gather(left, nv))
            best = torch.where(node >= 0, gather(value, nv), best)
            node = torch.where(node < 0, node, nxt)
        return best

    return fn


def items(data):
    return data["ips"]


def cost(data):
    return dict(flops=MAX_DEPTH * 3.0, bytes=MAX_DEPTH * 16.0, chain=MAX_DEPTH, vector=True)


register(
    Benchmark(
        name="GeoIP",
        domain="CDN / edge",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
    )
)
