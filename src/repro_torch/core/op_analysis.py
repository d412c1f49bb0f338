"""Collective bytes and an op-class histogram of a counted step: hotspots.

The port's counterpart of the JAX package's ``core/hlo_analysis.py``,
which walks the SPMD-partitioned HLO of a compiled XLA executable. The
port has no compiled program: the op counter of ``core/op_cost.py`` sees
each aten op and kernel operator as it runs and fills these tables, and
``parallel/collectives.py`` reports each collective call to it. All byte
counts are *per device*: every rank runs the same code on its shard, and
each counts its own, as each device of an SPMD program does.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

# the JAX package's collective names: ``parallel/collectives.py``'s
# all_reduce, all_gather, all_to_all and ring_shift report as these
COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# bytes a ring implementation moves through each device's links, as a
# multiple of the call's per-device result payload
_RING_FACTOR = {
    "all-gather": 1.0,       # receives (n-1)/n of result ≈ result bytes
    "all-reduce": 2.0,       # reduce-scatter + all-gather phases
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=lambda: defaultdict(int))
    bytes_by_op: dict = field(default_factory=lambda: defaultdict(float))
    bytes_total: float = 0.0

    def add(self, op: str, payload: float) -> None:
        """One call of ``op`` whose result holds ``payload`` bytes on this
        device: its ring bytes are payload × the op's ring factor."""
        if op not in _RING_FACTOR:
            raise ValueError(f"unknown collective {op!r}; one of {COLLECTIVE_OPS}")
        nbytes = payload * _RING_FACTOR[op]
        self.counts[op] += 1
        self.bytes_by_op[op] += nbytes
        self.bytes_total += nbytes

    def summary(self) -> str:
        parts = [
            f"{op}×{self.counts[op]}={self.bytes_by_op[op]/2**20:.1f}MiB"
            for op in sorted(self.counts)
        ]
        return f"total={self.bytes_total/2**20:.1f}MiB  " + "  ".join(parts)


@dataclass
class OpStats:
    """FLOPs, bytes and calls by op class (``aten::mm``,
    ``repro_torch::paged_decode_attention``, …): the hotspot ranking."""

    flops_by_op: dict = field(default_factory=lambda: defaultdict(float))
    bytes_by_op: dict = field(default_factory=lambda: defaultdict(float))
    calls_by_op: dict = field(default_factory=lambda: defaultdict(int))

    def add(self, op: str, flops: float, nbytes: float) -> None:
        self.flops_by_op[op] += flops
        self.bytes_by_op[op] += nbytes
        self.calls_by_op[op] += 1

    def hotspots(self, peak_flops: float, hbm_bw: float, top: int = 10):
        """Rank op classes by modeled time = max(flop-time, byte-time)."""
        t = {}
        for op in set(self.flops_by_op) | set(self.bytes_by_op):
            t[op] = max(
                self.flops_by_op.get(op, 0.0) / peak_flops,
                self.bytes_by_op.get(op, 0.0) / hbm_bw,
            )
        return sorted(t.items(), key=lambda kv: -kv[1])[:top]
