"""Fault-tolerant checkpointing: atomic, versioned, asynchronous, elastic.

Port of the JAX package's ``ckpt/checkpoint.py``:

* atomic publish — a step is written to ``step_N.tmp/`` and published by
  ``os.rename`` to ``step_N`` (a crashed writer never corrupts the restore
  point);
* keep-k garbage collection — the oldest published steps are removed;
* asynchronous — the device→host copy is synchronous, the serialization
  runs on a daemon thread (``wait()`` joins it and raises what it raised,
  as every save and restore does first);
* elastic restore — leaves are saved whole with their tree's order, and
  ``restore`` casts each to the target's dtype and device; on a mesh
  (``mesh=``, ``specs=``: the tree's sharding specs) a save gathers each
  leaf whole, rank (0, …, 0) writes it and the others wait for it to be
  published, and a restore slices each leaf for the rank it runs on, so a
  checkpoint taken on one mesh restores onto another or onto one device
  (the JAX package's ``restore(..., shardings=)``).

numpy has no bfloat16: such a leaf is stored as its raw 16-bit pattern
(``uint16``) with the dtype's name in ``meta.json``, so it restores bit for
bit. Trees are nested dicts, lists, tuples and named tuples (``OptState``),
flattened in JAX's order (``repro_torch/tree.py``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.parallel import collectives as col
from repro_torch.parallel import sharding
from repro_torch.tree import flatten, unflatten

def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of a leaf; a bfloat16 tensor as its bits.
    A tensor is copied, on the CPU too: the trainer updates its state in
    place while a save serializes the copy on its thread."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_host(arr: np.ndarray, name: str) -> torch.Tensor:
    # (np.ascontiguousarray would turn a 0-d array into shape (1,))
    t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy(order="C"))
    return t.view(torch.int16).view(torch.bfloat16) if name == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None  # a failed background save
        self._mesh = None  # the mesh of the last save: its ranks wait for rank 0's write

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, meta: dict | None = None, blocking: bool = False,
             mesh=None, specs: Any = None):
        """Copy ``tree``'s leaves to the host now, then serialize them
        (on a thread unless ``blocking``). On ``mesh``, ``tree`` holds this
        rank's shards and ``specs`` their specs (a tree of the same
        structure, one spec tuple a leaf): every rank of the mesh calls it,
        the leaves are gathered whole, rank (0, …, 0) writes them, and every
        rank's next ``wait`` returns once they are published."""
        self.wait()
        leaves, _ = flatten(tree)
        writer = True
        if mesh is not None:
            spec_leaves = flatten(specs, is_leaf=sharding.is_spec)[0]
            leaves = [sharding.gather_leaf(t, sp, mesh) for t, sp in zip(leaves, spec_leaves,
                                                                         strict=True)]
            writer = not any(mesh.get_coordinate())
            self._mesh = mesh
        if not writer:
            if blocking:
                self.wait()
            return
        host = [_to_host(leaf) for leaf in leaves]
        meta = dict(meta or {}, step=step, n_leaves=len(host), dtypes=[n for _, n in host])

        def work():
            tmp = self._step_dir(step) + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        def background():
            try:
                work()
            except Exception as e:  # raised again by the next wait()
                self._error = e

        if blocking:
            work()
            if mesh is not None:
                self.wait()
        else:
            self._thread = threading.Thread(target=background, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the background save; raise what it raised, if anything.
        After a save on a mesh, every rank of it waits here until rank (0,
        …, 0) has published it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            col.mesh_barrier(mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint save under {self.dir} failed") from err

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, tree_like: Any, step: int | None = None, *, device=None, mesh=None,
                specs: Any = None):
        """(the checkpoint of ``step`` — the latest by default — in the
        structure of ``tree_like``, its meta). Each leaf takes the dtype of
        ``tree_like``'s leaf (a float32 snapshot restores into bfloat16:
        the elastic path) and its device, or ``device`` where given (a meta
        target restores on the CPU unless ``device`` says otherwise). On
        ``mesh`` each whole leaf is sliced by its spec in ``specs`` for the
        rank this runs on (``tree_like``'s leaves may be shards of any
        mesh: only their dtypes and devices are read)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        refs, spec = flatten(tree_like)
        if len(refs) != meta["n_leaves"]:
            raise ValueError(f"checkpoint step {step} holds {meta['n_leaves']} leaves, the "
                             f"target tree {len(refs)}")
        spec_leaves = (flatten(specs, is_leaf=sharding.is_spec)[0] if mesh is not None
                       else [()] * len(refs))
        restored = []
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for i, ref in enumerate(refs):
                t = sharding.shard_leaf(_from_host(data[f"leaf_{i}"], meta["dtypes"][i]),
                                        spec_leaves[i], mesh)
                if isinstance(ref, torch.Tensor):
                    dev = device or (ref.device if ref.device.type != "meta" else "cpu")
                    t = t.to(device=dev, dtype=ref.dtype)
                elif device is not None:
                    t = t.to(device)
                restored.append(t)
        return unflatten(spec, restored), meta
