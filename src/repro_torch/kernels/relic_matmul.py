"""Blocked matmul and small-batch GEMV with float32 accumulators.

Replace the JAX package's Pallas TPU kernels
``kernels/relic_matmul.py::relic_matmul`` and ``relic_gemv``; the CUDA
source is ``csrc/relic_matmul.cu`` (its header says what bounds them on the
H100 and what the design does about it).

Both keep the JAX functions' shape contract: each block is first cut to
its dimension (``b = min(b, dim)``), then the dimension must be a multiple
of it, or the call raises. (The CUDA kernels' own tiles do not depend on
the blocks, and they mask ragged edges.) Each wrapper dispatches on the
tensors' device: CPU tensors take the plain PyTorch version (``x @ w``
summed in float32 and rounded once to x's type), CUDA tensors the kernel —
or it raises. Each has a ``launches`` attribute that counts its launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref as plain_relic_matmul

plain_relic_gemv = plain_relic_matmul

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/relic_matmul.cu's GEMV covers N in 128-column panels; K is split
# across thread blocks until the grid reaches _build.TARGET_BLOCKS, each
# split keeping at least 64 rows of w
GEMV_PANEL, GEMV_MIN_SPLIT_ROWS = 128, 64


def _check(name, x, w, blocks):
    """Raise unless x [·,K] @ w [K,N] is well formed and every (dimension,
    block) pair of ``blocks`` meets the JAX contract; returns (rows, K, N)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"{name}: w on {w.device}, x on {x.device}")
    dims = {"M": x.shape[0], "K": x.shape[1], "N": w.shape[1]}
    for dim, blk, size in blocks:
        b = min(size, dims[dim])
        if b < 1 or dims[dim] % b:
            raise ValueError(
                f"{name}: {dim}={dims[dim]} is not a multiple of {blk}=min({size}, {dims[dim]}) "
                "(the JAX function's block contract)"
            )
    return x.shape[0], x.shape[1], w.shape[1]


def _check_kernel_inputs(name, x, w):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x/w must share float32 or bfloat16, got {x.dtype}/{w.dtype}")
    for t_name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")


def relic_matmul(x, w, *, bm: int = 256, bk: int = 512, bn: int = 256):
    """x [M,K] @ w [K,N] → [M,N] in x's type, float32 accumulation; M, K,
    N multiples of min(bm, M), min(bk, K), min(bn, N)."""
    M, K, N = _check("relic_matmul", x, w, (("M", "bm", bm), ("K", "bk", bk), ("N", "bn", bn)))
    if x.device.type == "cpu":
        return plain_relic_matmul(x, w)
    _check_kernel_inputs("relic_matmul", x, w)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.library().relic_matmul(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "relic_matmul")
    relic_matmul.launches += 1
    return out


def gemv_splits(K: int, N: int) -> int:
    """How many thread blocks share one panel's K in the GEMV kernel."""
    panels = -(-N // GEMV_PANEL)
    return max(1, min(-(-_build.TARGET_BLOCKS // panels), K // GEMV_MIN_SPLIT_ROWS))


def relic_gemv(x, w, *, bk: int = 1024, bn: int = 512):
    """x [B,K] @ w [K,N] → [B,N] in x's type for a few decode rows, float32
    accumulation; K, N multiples of min(bk, K), min(bn, N), any B."""
    B, K, N = _check("relic_gemv", x, w, (("K", "bk", bk), ("N", "bn", bn)))
    if x.device.type == "cpu":
        return plain_relic_gemv(x, w)
    _check_kernel_inputs("relic_gemv", x, w)
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    splits = gemv_splits(K, N)
    ws = torch.empty((splits, B, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    err = _build.library().relic_gemv(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, K, N, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "relic_gemv")
    relic_gemv.launches += 1
    return out


relic_matmul.launches = 0
relic_gemv.launches = 0
