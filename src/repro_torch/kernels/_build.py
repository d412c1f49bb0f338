"""Build and load the port's CUDA kernels.

Every ``.cu`` under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The TMA
descriptors (the bf16 matmul and flash kernels', the GEMV's) come from
the driver's ``cuTensorMapEncodeTiled``, looked up at run time through
``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``), so the link needs no
``-lcuda``. The library lands in ``build/kernels/<hash>/`` at the
repository root, keyed by a hash of the sources and flags, so a checkout
builds once at first use and an edited source rebuilds. Nothing here
runs at import time: the CPU-only test host has neither ``nvcc`` nor a
card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# the H100's streaming multiprocessors; the kernels that split one
# output's work across a cluster of blocks (the GEMV's K, the dense
# decode's keys) aim for up to two blocks on each
SMS = 132
TARGET_BLOCKS = 2 * SMS

_lib: Optional[ctypes.CDLL] = None


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel is asked to be differentiated: in grad mode,
    with an input that requires grad. The kernels have no backward (the JAX
    package's Pallas kernels have no VJP), and an output computed through
    ``data_ptr()`` carries no ``grad_fn``: without this check, a backward
    would drop the gradient of everything upstream without a word. Every
    wrapper calls it before anything else, on any device."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires grad; "
            "differentiate the plain route (backend='reference', as Model.loss "
            "does) or call the kernel under torch.no_grad()"
        )


def through_operator(t: torch.Tensor) -> bool:
    """Whether a kernel call goes through its ``torch.library`` operator
    (``repro_torch::<kernel>``) instead of straight to its wrapper: on meta
    tensors (the operator's fake gives the output's shape and launches
    nothing), under a ``torch.func`` transform (whose rule only the
    operator carries) and under a dispatch mode (``make_fx``, the op
    counter of ``core/op_cost.py``: the call is one node there, charged by
    its work). An eager call on real tensors goes straight to the wrapper,
    which spares it the dispatcher's host time."""
    return (t.device.type == "meta" or torch._C._are_functorch_transforms_active()
            or bool(torch._C._len_torch_dispatch_stack()))


def loop_vmap(op):
    """A vmap rule for ``op`` that calls it once a mapped item and stacks
    the results (tensor or tuple outputs) on a new leading axis: right for
    any kernel, one launch an item."""

    def rule(info, in_dims, *args):
        def item(i):
            return op(*(a.select(d, i) if d is not None else a for a, d in zip(args, in_dims)))

        outs = [item(i) for i in range(info.batch_size)]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
        return torch.stack(outs), 0

    return rule


def aligned16(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary, as TMA
    and 16-byte copies need (a view at an odd element offset does not)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA host")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> None:
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        so = Path(tmp) / out.name
        subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(so)],
            check=True, capture_output=True, text=True,
        )
        os.replace(so, out)  # atomic: a concurrent builder sees all or nothing


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    out = BUILD_ROOT / _digest() / "librepro_torch_kernels.so"
    if not out.exists():
        nvcc = _nvcc()  # before touching the build directory
        out.parent.mkdir(parents=True, exist_ok=True)
        _compile(nvcc, out)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {
        "paged_decode_attention": [i, i] + [p] * 11 + [i] * 13 + [f, p],
        "flash_attention": [i, p, p, p, p] + [i] * 8 + [f, i, p],
        "ssd_scan": [i] + [p] * 7 + [i] * 9 + [p],
        "relic_matmul": [i, p, p, p] + [i] * 5 + [p],
        "relic_gemv": [i, p, p, p] + [i] * 7 + [p],
        "decode_attention": [i] + [p] * 5 + [i] * 10 + [f, p],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, i
    _lib = lib
    return lib


# csrc/hopper.cuh: an entry point returns TMA_REFUSED + the driver's
# CUresult when cuTensorMapEncodeTiled refuses a TMA descriptor, and
# TMA_REFUSED + 0xFFFF when the driver has no such entry point
TMA_REFUSED = 1 << 20


def check(err: int, name: str) -> None:
    """Raise when a kernel's C entry point reports a CUDA error or a
    refused TMA descriptor."""
    if err >= TMA_REFUSED:
        code = err - TMA_REFUSED
        why = "no cuTensorMapEncodeTiled in the driver" if code == 0xFFFF else f"CUresult {code}"
        raise RuntimeError(f"{name}: the driver refused a TMA descriptor ({why})")
    if err:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")
