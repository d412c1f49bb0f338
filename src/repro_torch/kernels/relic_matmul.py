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

On the card, ``matmul_plan`` decides how ``relic_matmul`` launches: bf16
on the tensor cores (TMA-fed ``wgmma``, 128 x 64 or 128 x 128 tiles; K and
N must be multiples of 8, or it raises), float32 on the CUDA cores.
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


def matmul_plan(dtype, M: int, K: int, N: int) -> dict:
    """How ``csrc/relic_matmul.cu`` computes x [M,K] @ w [K,N] of ``dtype``
    on the card: its path, output tile (rows, columns, K slice), grid
    (x, y), and for the ``wgmma`` path the ring's stages and the TMA boxes
    (elements, innermost first) of x and w. bf16 takes the tensor cores,
    with 128-column tiles when they alone fill the card's SMs and 64-column
    ones (two blocks an SM) otherwise; it raises
    unless K and N are multiples of 8 (TMA's 16-byte row strides). float32
    stays on the CUDA cores (wgmma's float32 inputs are TF32)."""
    if dtype == torch.float32:
        return {"path": "cuda_cores", "tile": (128, 128, 16), "grid": (_cdiv(N, 128), _cdiv(M, 128))}
    if dtype != torch.bfloat16:
        raise TypeError(f"relic_matmul: no kernel for {dtype}")
    if K % 8 or N % 8:
        raise ValueError(
            f"relic_matmul: bf16 K={K} and N={N} must be multiples of 8 "
            "(the TMA loads need 16-byte row strides)"
        )
    tile_n = 128 if _cdiv(M, 128) * _cdiv(N, 128) >= _build.SMS else 64
    return {"path": "wgmma", "tile": (128, tile_n, 64), "grid": (_cdiv(M, 128), _cdiv(N, tile_n)),
            "stages": 4, "x_box": (64, 128), "w_box": (64, 64), "w_boxes": tile_n // 64}


def _launch_matmul(x, w, plan: dict):
    """Launch the kernel ``plan`` describes on checked CUDA tensors and
    return the output. It counts nothing: ``relic_matmul`` counts its
    launches, and only a measurement harness calls this directly (to time
    the other tile width on the same inputs)."""
    M, K = x.shape
    N = w.shape[1]
    if plan["path"] == "wgmma":
        for t_name, t in (("x", x), ("w", w)):
            if t.data_ptr() % 16:
                raise ValueError(f"relic_matmul: bf16 {t_name} must be 16-byte aligned for TMA")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.library().relic_matmul(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, plan["tile"][1],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "relic_matmul")
    return out


def relic_matmul(x, w, *, bm: int = 256, bk: int = 512, bn: int = 256):
    """x [M,K] @ w [K,N] → [M,N] in x's type, float32 accumulation; M, K,
    N multiples of min(bm, M), min(bk, K), min(bn, N)."""
    M, K, N = _check("relic_matmul", x, w, (("M", "bm", bm), ("K", "bk", bk), ("N", "bn", bn)))
    if x.device.type == "cpu":
        return plain_relic_matmul(x, w)
    _check_kernel_inputs("relic_matmul", x, w)
    out = _launch_matmul(x, w, matmul_plan(x.dtype, M, K, N))
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
