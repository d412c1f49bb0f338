"""Hotspot detection from a counted step (perf + LBR analogue).

Port of the JAX package's ``core/profiler.py``. ``profile_step`` counts one
run of a step with the aten-op counter (``core/op_cost.py``) where the JAX
package lowers and compiles the step and walks its HLO, and packages
FLOPs, bytes, collective bytes and roofline terms: the "sampled profile in
JSON" the paper's wrapper tool feeds the LLM.

- On meta arguments (``Model(cfg, device="meta")``, ``abstract_params``:
  the JAX package's ``ShapeDtypeStruct`` stand-ins) nothing is allocated
  or run, as in JAX; the kernels are charged at their tables' capacity
  (``kernels/work.py``).
- On real tensors the step runs once, eagerly, under the counter; the
  kernels are charged by the lengths these inputs hold. A ``mesh`` needs
  this (its collectives need a process group): each rank counts its own
  share, a device's, as each device of JAX's SPMD program does. Under a
  fake process group (``launch.mesh.fake_ranks``, the dry run) a mesh step
  counts on meta tensors too: one process poses as one rank, and its
  collectives return at once.
- The roofline terms are priced with ``hw``, by default ``H100_HW``, the
  card the port runs on (the JAX package's default is its own device's
  preset).

The JAX function's ``in_shardings``, ``out_shardings``, ``donate_argnums``,
``static_argnames`` and ``keep_compiled`` have no counterpart: the port
compiles nothing, its ranks shard their own arguments, and a step
updates its state in place where it donates nothing.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch.core import op_analysis, op_cost
from repro_torch.core.overlap_model import H100_HW, HwModel


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        t = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(t, key=t.get)

    @property
    def bound_s(self) -> float:
        """Roofline-optimal step time = max of the three terms (perfect
        overlap of the other two)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s


@dataclass
class ProfiledStep:
    name: str
    flops: float  # per device
    bytes_accessed: float  # per device
    collectives: op_analysis.CollectiveStats
    ops: op_analysis.OpStats
    memory_stats: op_cost.MemoryStats
    terms: RooflineTerms
    hw: HwModel = H100_HW

    def hotspots(self, hw: Optional[HwModel] = None, top=10):
        """Op classes ranked by modeled time on ``hw`` (by default the
        model the terms were priced with)."""
        hw = hw or self.hw
        return self.ops.hotspots(hw.peak_flops, hw.hbm_bw, top)

    def report(self) -> dict:
        return {
            "name": self.name,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collectives.bytes_total,
            "roofline": {
                "compute_s": self.terms.compute_s,
                "memory_s": self.terms.memory_s,
                "collective_s": self.terms.collective_s,
                "dominant": self.terms.dominant,
            },
            "collectives": dict(self.collectives.counts),
            "hotspots": [
                {"op": op, "modeled_s": t} for op, t in self.hotspots()
            ],
        }

    def to_json(self) -> str:
        return json.dumps(self.report(), indent=2, default=float)


def fake_group() -> bool:
    """Whether the process group is a fake one (``launch.mesh.fake_ranks``):
    its collectives return at once on any tensor, meta ones too, so one
    process counts one rank's share of a mesh step."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def profile_step(fn, *args, name: str = "step", mesh=None, hw: Optional[HwModel] = None,
                 **kwargs) -> ProfiledStep:
    """Count one run of ``fn(*args, **kwargs)`` (module docstring) and
    derive its per-device roofline terms on ``hw`` (``H100_HW`` unless
    given). ``mesh``: the mesh whose collectives ``fn`` runs; its
    arguments must then be real tensors on this rank."""
    hw = hw or H100_HW
    if mesh is not None and not fake_group() and any(
            isinstance(t, torch.Tensor) and t.device.type == "meta"
            for t in tree_flatten((args, kwargs))[0]):
        raise ValueError("profile_step: a mesh's collectives need real tensors, got meta ones "
                         "(or a fake process group: launch.mesh.fake_ranks)")
    cost = op_cost.analyze(fn, *args, **kwargs)
    terms = RooflineTerms(
        compute_s=cost.flops / hw.peak_flops,
        memory_s=cost.bytes / hw.hbm_bw,
        collective_s=cost.collective_bytes / hw.ici_bw if cost.collective_bytes else 0.0,
    )
    return ProfiledStep(
        name=name,
        flops=cost.flops,
        bytes_accessed=cost.bytes,
        collectives=cost.collectives,
        ops=cost.ops,
        memory_stats=cost.memory,
        terms=terms,
        hw=hw,
    )
