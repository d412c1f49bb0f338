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
on the tensor cores (TMA-fed ``wgmma``, 128 x 64 or 128 x 128 tiles) where
TMA can take the operands (K and N multiples of 8, x and w 16-byte
aligned), every other bf16 input and float32 on the CUDA cores; and
``gemv_plan`` how ``relic_gemv`` does: w streamed by TMA through a
shared-memory ring, x by TMA beside it (or both loaded directly where TMA
cannot take them), K split over a cluster of blocks that reduce in a
fixed order inside the launch. Each is also a ``torch.library`` operator
(``repro_torch::relic_matmul``, ``repro_torch::relic_gemv``), which
``matmul_call`` and ``gemv_call`` take only on meta tensors, under a
transform or under a dispatch mode (``_build.through_operator``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref as plain_relic_matmul

plain_relic_gemv = plain_relic_matmul

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/relic_matmul.cu's GEMV: 512-byte panel rows (256 bf16 or 128
# float32 columns), stages of 32 rows (16 KB) in a ring that fills ~110 KB
# of shared memory with x's buffers (two blocks an SM), x staged 512 rows
# of K at a time, 8 consumer warps and a producer warp; K split over a
# cluster of at most 8 blocks, each split keeping at least 64 rows of w
GEMV_ROW_BYTES, GEMV_STAGE_ROWS, GEMV_X_CHUNK, GEMV_MAX_STAGES = 512, 32, 512, 24
GEMV_MAX_SPLITS, GEMV_MIN_SPLIT_ROWS, GEMV_THREADS = 8, 64, 288
GEMV_SMEM = 110 * 1024


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


def matmul_plan(dtype, M: int, K: int, N: int, aligned: bool = True) -> dict:
    """How ``csrc/relic_matmul.cu`` computes x [M,K] @ w [K,N] of ``dtype``
    on the card: its path, output tile (rows, columns, K slice), grid
    (x, y), and for the ``wgmma`` path the ring's stages and the TMA boxes
    (elements, innermost first) of x and w. bf16 takes the tensor cores,
    with 128-column tiles when they alone fill the card's SMs and 64-column
    ones (two blocks an SM) otherwise, where TMA can take the operands: K
    and N multiples of 8 (16-byte row strides) and ``aligned`` (x and w
    start on 16-byte boundaries, ``_build.aligned16``). Every other bf16
    input, and float32 (wgmma's float32 inputs are TF32), takes the
    CUDA-core kernel."""
    if dtype not in _DTYPES:
        raise TypeError(f"relic_matmul: no kernel for {dtype}")
    if dtype == torch.float32 or K % 8 or N % 8 or not aligned:
        return {"path": "cuda_cores", "tile": (128, 128, 16), "grid": (_cdiv(N, 128), _cdiv(M, 128))}
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
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.library().relic_matmul(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, plan["tile"][1],
        int(plan["path"] == "wgmma"), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "relic_matmul")
    return out


def relic_matmul(x, w, *, bm: int = 256, bk: int = 512, bn: int = 256):
    """x [M,K] @ w [K,N] → [M,N] in x's type, float32 accumulation; M, K,
    N multiples of min(bm, M), min(bk, K), min(bn, N)."""
    _build.refuse_grad("relic_matmul", x, w)
    M, K, N = _check("relic_matmul", x, w, (("M", "bm", bm), ("K", "bk", bk), ("N", "bn", bn)))
    if x.device.type == "cpu":
        return plain_relic_matmul(x, w)
    _check_kernel_inputs("relic_matmul", x, w)
    out = _launch_matmul(x, w, matmul_plan(x.dtype, M, K, N, _build.aligned16(x, w)))
    relic_matmul.launches += 1
    return out


def gemv_plan(dtype, B: int, K: int, N: int, aligned: bool = True) -> dict:
    """How ``csrc/relic_matmul.cu`` computes x [B,K] @ w [K,N] of ``dtype``
    on the card: one thread block per (panel of w's columns, split of K,
    group of ``rows`` rows of x), the grid (panels, splits, groups), the
    splits of a panel one cluster; each split takes ``k_per_split`` rows
    of w (a multiple of the 32-row stage), through a ring of ``stages``. w and x arrive by TMA (path "tma") where N and K
    are multiples of 16 bytes' worth of values and ``aligned`` (x and w on
    16-byte boundaries), else the consumers load them (path "direct"). The
    splits (1 to 8, each keeping at least ``GEMV_MIN_SPLIT_ROWS`` rows and
    none left with none) give the most blocks per resident wave: blocks / ceil(blocks / SMs)
    with at most two blocks an SM, the fewest splits on a tie, so no SM
    carries twice the work of another where that can be had."""
    if dtype not in _DTYPES:
        raise TypeError(f"relic_gemv: no kernel for {dtype}")
    es = 4 if dtype == torch.float32 else 2
    vec = 16 // es
    panel = 32 * vec
    rows = 1 if B <= 1 else min(8, 1 << (B - 1).bit_length())
    panels, groups = _cdiv(N, panel), _cdiv(max(B, 1), rows)

    def per_wave(s):
        blocks = s * panels * groups
        return blocks / _cdiv(blocks, _build.SMS)

    def rows_per_split(s):
        return _cdiv(_cdiv(K, s), GEMV_STAGE_ROWS) * GEMV_STAGE_ROWS

    fits = [s for s in range(1, GEMV_MAX_SPLITS + 1)
            if s == 1 or (s * panels * groups <= _build.TARGET_BLOCKS
                          and K >= s * GEMV_MIN_SPLIT_ROWS
                          and (s - 1) * rows_per_split(s) < K)]  # no split left without rows
    splits = max(fits, key=lambda s: (per_wave(s), -s))
    k_per_split = rows_per_split(splits)
    # the ring takes what x's buffers (float32, and two of x's type) and
    # the barriers leave, at most 1.5 chunks of x deep
    fixed = 1024 + GEMV_X_CHUNK * rows * (4 + 2 * es) + 8 * (2 * GEMV_MAX_STAGES + 4)
    stages = min(GEMV_MAX_STAGES, 3 * GEMV_X_CHUNK // GEMV_STAGE_ROWS // 2,
                 (GEMV_SMEM - fixed) // (GEMV_STAGE_ROWS * GEMV_ROW_BYTES))
    tma = aligned and N % vec == 0 and K % vec == 0
    return {"path": "tma" if tma else "direct", "panel": panel,
            "rows": rows, "splits": splits, "k_per_split": k_per_split,
            "grid": (panels, splits, groups), "cluster": (1, splits, 1),
            "stages": stages, "stage_rows": GEMV_STAGE_ROWS, "x_chunk": GEMV_X_CHUNK,
            "threads": GEMV_THREADS}


def relic_gemv(x, w, *, bk: int = 1024, bn: int = 512):
    """x [B,K] @ w [K,N] → [B,N] in x's type for a few decode rows, float32
    accumulation; K, N multiples of min(bk, K), min(bn, N), any B."""
    _build.refuse_grad("relic_gemv", x, w)
    B, K, N = _check("relic_gemv", x, w, (("K", "bk", bk), ("N", "bn", bn)))
    if x.device.type == "cpu":
        return plain_relic_gemv(x, w)
    _check_kernel_inputs("relic_gemv", x, w)
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    plan = gemv_plan(x.dtype, B, K, N, _build.aligned16(x, w))
    err = _build.library().relic_gemv(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(), B, K, N, plan["rows"],
        plan["splits"], plan["stages"], int(plan["path"] == "tma"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "relic_gemv")
    relic_gemv.launches += 1
    return out


relic_matmul.launches = 0
relic_gemv.launches = 0


@torch.library.custom_op("repro_torch::relic_matmul", mutates_args=())
def relic_matmul_op(x: torch.Tensor, w: torch.Tensor, bm: int, bk: int, bn: int) -> torch.Tensor:
    """``relic_matmul`` as the operator ``repro_torch::relic_matmul``."""
    return relic_matmul(x, w, bm=bm, bk=bk, bn=bn)


@relic_matmul_op.register_fake
def _matmul_fake(x, w, bm, bk, bn):
    _check("relic_matmul", x, w, (("M", "bm", bm), ("K", "bk", bk), ("N", "bn", bn)))
    return x.new_empty((x.shape[0], w.shape[1]))


@torch.library.custom_op("repro_torch::relic_gemv", mutates_args=())
def relic_gemv_op(x: torch.Tensor, w: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """``relic_gemv`` as the operator ``repro_torch::relic_gemv``."""
    return relic_gemv(x, w, bk=bk, bn=bn)


@relic_gemv_op.register_fake
def _gemv_fake(x, w, bk, bn):
    _check("relic_gemv", x, w, (("K", "bk", bk), ("N", "bn", bn)))
    return x.new_empty((x.shape[0], w.shape[1]))


relic_matmul_op.register_vmap(_build.loop_vmap(relic_matmul_op))
relic_gemv_op.register_vmap(_build.loop_vmap(relic_gemv_op))


def matmul_call(x, w, *, bm: int = 256, bk: int = 512, bn: int = 256):
    """``relic_matmul`` through its operator where ``_build.through_operator``
    says so, straight to the wrapper otherwise."""
    if _build.through_operator(x):
        return relic_matmul_op(x, w, bm, bk, bn)
    return relic_matmul(x, w, bm=bm, bk=bk, bn=bn)


def gemv_call(x, w, *, bk: int = 1024, bn: int = 512):
    """``relic_gemv`` through its operator where ``_build.through_operator``
    says so, straight to the wrapper otherwise."""
    if _build.through_operator(x):
        return relic_gemv_op(x, w, bk, bn)
    return relic_gemv(x, w, bk=bk, bn=bn)
