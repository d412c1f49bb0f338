"""Serving meshes over ``torch.distributed``, and the rank processes.

Port of the JAX package's ``launch/mesh.py``. In JAX a mesh
is a grid of devices driven by one program; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the current
process group, one process a rank, every rank running the same code (the
model ``torchrun`` launches). ``run_ranks`` starts such processes on this
machine, joined into one gloo group over a file store: the CPU tests run
their meshes this way, and so does ``chip_smoke.py`` on one card, where
NCCL refuses two ranks on one device. The same meshes serve split
(``ServingEngine(..., mesh=)``) and train split (``Model(cfg, mesh=mesh)``).
``make_production_mesh`` is the Hopper production layout the dry run
(``launch/dryrun.py``) counts cells on: the 8 NVLink GPUs of a node form
"model", the nodes "data" (and two such clusters "pod"), over the current
process group. ``fake_ranks`` opens that group without any other process:
a "fake" backend over a ``FakeStore``, whose collectives return at once
(their results are uninitialised memory), so that one process poses as one
rank of 256 or 512 — the JAX dry run's placeholder devices.
"""
from __future__ import annotations

import contextlib
import math
import os
import sys
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *, device=None, ranks=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ``ranks`` of the
    current process group (its first prod(shape) ranks by default), on
    CUDA unless ``device="cpu"``. Every rank of the group calls it (the
    subgroups are made collectively); a rank outside ``ranks`` gets a mesh
    whose ``get_coordinate()`` is None."""
    dev = resolve_device(device)
    n = math.prod(shape)
    ids = torch.arange(n) if ranks is None else torch.as_tensor(list(ranks))
    if ids.numel() != n:
        raise ValueError(f"make_test_mesh: {ids.numel()} ranks for a mesh of shape {shape}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return DeviceMesh(dev.type, ids.view(tuple(shape)), mesh_dim_names=tuple(axes))


# the Hopper production layout: 8 NVLink GPUs a node over "model", the
# nodes over "data"; two clusters over "pod" (the JAX package's 256 and 512
# chips, as 16×16 and 2×16×16 TPU meshes)
GPUS_PER_NODE = 8
PRODUCTION_SHAPES = {False: ((32, GPUS_PER_NODE), ("data", "model")),
                     True: ((2, 32, GPUS_PER_NODE), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """("data", "model") = (32, 8), 256 GPUs, or with ``multi_pod`` ("pod",
    "data", "model") = (2, 32, 8), 512 GPUs, over the ranks of the current
    process group (which must hold that many: under ``fake_ranks`` one
    process stands for all of them). ``device``: the mesh's device type,
    CUDA unless "cpu" (the dry run's meta tensors take a CPU mesh)."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_test_mesh(shape, axes, device=device)


@contextlib.contextmanager
def fake_ranks(world: int, rank: int = 0):
    """A process group of ``world`` ranks of which this process is
    ``rank``, with no other process behind it: the "fake" backend over a
    ``FakeStore``. Every collective returns at once and leaves its result
    uninitialised, so what runs under it must read no value a collective
    produced (meta tensors read none). The group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_ranks: a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _rank_main(rank, world, store, timeout_s, fn, args):
    torch.set_num_threads(1)  # the ranks share the machine's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
        dist.barrier()
    except BaseException:
        # the spawning process reports one rank's error; the others' (a peer
        # that closed its connection) would hide the cause
        print(f"rank {rank} of {world} failed:\n{traceback.format_exc()}", file=sys.stderr,
              flush=True)
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, store: str, timeout_s: float = 300.0):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, one
    intra-op thread each, joined into one gloo process group through the
    file ``store`` (removed first: a stale store would join an old group);
    a collective waits at most ``timeout_s``. ``fn`` must be importable (a
    module-level function). A rank that raises prints its traceback and
    fails the call, and the other ranks are stopped."""
    if os.path.exists(store):
        os.remove(store)
    torch.multiprocessing.spawn(_rank_main, args=(world, store, timeout_s, fn, args),
                                nprocs=world, join=True)
