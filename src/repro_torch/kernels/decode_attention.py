"""Single-query flash decode over a dense KV cache.

Replaces the JAX package's Pallas TPU kernel
``kernels/decode_attention.py::decode_attention``; the CUDA source is
``csrc/decode_attention.cu`` (its header says what bounds it on the H100
and what the design does about it). The cache is read in place, in its
``[B,Smax,KV,hd]`` layout.

``decode_attention`` keeps the JAX function's contract that ``Smax`` is a
multiple of ``min(bk, Smax)`` (the kernel's own tile of 64 keys, or 32 or
16 for a very wide head, does not depend on ``bk``), then dispatches on the tensors' device: CPU tensors take the
plain PyTorch version (``plain_decode_attention``), CUDA tensors the
kernel — or it raises. A row with ``cache_len`` 0 gives zeros in both.
Its ``launches`` attribute counts kernel launches. ``decode_plan`` says how
the kernel launches: how many blocks (one cluster) share a row's keys, the
K/V ring's tile and depth, and whether the tiles arrive by 16-byte ``cp.async``.
``decode_attention_op`` is the same function as the ``torch.library``
operator ``repro_torch::decode_attention``, which ``decode_call`` takes
only on meta tensors, under a transform or under a dispatch mode
(``_build.through_operator``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref as plain_decode_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/decode_attention.cu: 128 threads a block, a cluster of at most 8
# splits that share a row's live tiles equally, a K/V ring of 2-4 stages
# of 64-key tiles within ~112 KB of shared memory; a head too wide for
# that takes 32-key tiles, then 16-key ones, then one stage
DECODE_TILES = (64, 32, 16)
DECODE_THREADS = 128
DECODE_MAX_SPLITS, DECODE_TILES_PER_SPLIT = 8, 8
DECODE_RING_BYTES = 112 * 1024
SMEM_OPT_IN = 232_448  # the H100's per-block shared memory with the opt-in (227 KB)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(n: int) -> int:
    return _cdiv(n, 16) * 16


def _stage_bytes(hd: int, es: int, tile: int) -> int:
    """One ring stage: a tile of K then one of V, rows padded by 16 bytes;
    an int8 pool's (``es`` 1) scales / 127 in float32 beside them."""
    return 2 * tile * (_round16(hd * es) + 16) + (_round16(8 * tile) if es == 1 else 0)


def decode_layout(hd: int, es: int, rows: int, stages: int, tile: int) -> int:
    """Bytes of dynamic shared memory a block takes, for the dense decode
    kernel and the paged one (``ring_layout`` in ``csrc/attention_tile.cuh``;
    ``es`` is the cache's element size, 1 for an int8 pool): the K/V ring,
    which the end-of-block reduction reuses, q, the tile's weights, the warp
    maxima and the block's (m, l, acc), where a head of more 16-byte chunks
    than threads keeps its running acc (one key group)."""
    chunks = _cdiv(hd * es, 16)
    hdp, groups = chunks * (16 // es), max(1, DECODE_THREADS // chunks)
    red = _round16(4 * groups * rows * (hdp + 1))
    return (max(stages * _stage_bytes(hd, es, tile), red) + _round16(4 * rows * hdp)
            + _round16(4 * rows * tile) + _round16(4 * (DECODE_THREADS // 32) * rows)
            + _round16(4 * rows * (hdp + 2)))


def _fits_one_stage(hd: int, es: int, rows: int, extra: int) -> bool:
    return decode_layout(hd, es, rows, 1, DECODE_TILES[-1]) + extra <= SMEM_OPT_IN


def max_head_dim(es: int, rows: int, extra: int = 0) -> int:
    """The largest hd whose block (a ring of one 16-key tile, ``rows``
    query rows, ``extra`` bytes past the layout) fits the opt-in."""
    lo, hi = 1, 1
    while _fits_one_stage(2 * hi, es, rows, extra):
        hi *= 2
    hi *= 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _fits_one_stage(mid, es, rows, extra) else (lo, mid)
    return lo


def decode_ring(hd: int, es: int, rows: int, name: str = "decode_attention",
                extra: int = 0) -> tuple[int, int]:
    """(keys a tile, stages) of the K/V ring: 64-key tiles in 2-4 stages
    within ``DECODE_RING_BYTES`` where the block (with ``extra`` bytes past
    the layout) fits the opt-in, else 32-key tiles, then 16-key ones, then
    16-key tiles in one stage; raises only where none fits, naming the
    largest hd that does (``max_head_dim``)."""
    for tile in DECODE_TILES:
        stages = max(2, min(4, DECODE_RING_BYTES // _stage_bytes(hd, es, tile)))
        if decode_layout(hd, es, rows, stages, tile) + extra <= SMEM_OPT_IN:
            return tile, stages
    if _fits_one_stage(hd, es, rows, extra):
        return DECODE_TILES[-1], 1
    raise ValueError(
        f"{name}: no shared-memory layout fits hd={hd} ({es}-byte elements, {rows} query "
        f"rows a block); the kernel takes hd up to {max_head_dim(es, rows, extra)}"
    )


def decode_plan(dtype, B: int, H: int, KV: int, Smax: int, hd: int, aligned: bool = True) -> dict:
    """How ``csrc/decode_attention.cu`` runs decode of ``dtype`` over q
    [B,H,hd] and a [B,Smax,KV,hd] cache: one block per (row, kv head,
    group of ``rows`` of its g query heads, split), the grid (B, KV *
    groups, splits), the splits one cluster; the kernel deals each row's
    live tiles (``tile`` keys, below its cache_len) to the splits in equal
    contiguous runs. Splits double (up to 8, at most one per tile of
    Smax) until the grid reaches ``_build.TARGET_BLOCKS`` and a full row
    gives no split more than ``DECODE_TILES_PER_SPLIT`` tiles. The K/V
    ring holds ``stages`` tiles (rows padded by 16 bytes; ``decode_ring``
    picks both within 227 KB); the tiles arrive by 16-byte ``cp.async``
    (path "cp.async") where a head's row is a multiple of 16 bytes and the
    caches are ``aligned``, else by element loads ("direct")."""
    if dtype not in _DTYPES:
        raise TypeError(f"decode_attention: no kernel for {dtype}")
    es = 4 if dtype == torch.float32 else 2
    g = H // KV
    rows = 1 if g == 1 else 4 if g <= 4 else 8
    tile, stages = decode_ring(hd, es, rows)
    groups = _cdiv(g, rows)
    tiles = _cdiv(Smax, tile)
    pairs = max(1, B * KV * groups)
    splits = 1
    while splits < min(DECODE_MAX_SPLITS, tiles) and (
            splits * pairs < _build.TARGET_BLOCKS or _cdiv(tiles, splits) > DECODE_TILES_PER_SPLIT):
        splits *= 2
    return {"path": "cp.async" if aligned and hd * es % 16 == 0 else "direct",
            "rows": rows, "splits": splits, "tile": tile, "stages": stages,
            "smem": decode_layout(hd, es, rows, stages, tile),
            "grid": (B, KV * groups, splits), "cluster": (1, 1, splits),
            "threads": DECODE_THREADS}


def decode_attention(q, k_cache, v_cache, cache_len, *, bk: int = 512):
    """q [B,H,hd]; caches [B,Smax,KV,hd] in q's type (float32 or
    bfloat16); ``cache_len`` [B] int32 → [B,H,hd] in q's type. Head h
    attends the positions < ``cache_len`` of kv head h // (H // KV)."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode_attention: bad shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
            f"v{tuple(v_cache.shape)}"
        )
    B, H, hd = q.shape
    Bk, Smax, KV, hd_k = k_cache.shape
    if Bk != B or hd_k != hd or KV < 1 or H % KV or cache_len.shape != (B,):
        raise ValueError(
            f"decode_attention: bad shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
            f"cache_len{tuple(cache_len.shape)}"
        )
    blk = min(bk, Smax)
    if blk < 1 or Smax % blk:
        raise ValueError(
            f"decode_attention: Smax={Smax} is not a multiple of bk=min({bk}, {Smax}) "
            "(the JAX function's block contract)"
        )
    tensors = (("k_cache", k_cache), ("v_cache", v_cache), ("cache_len", cache_len))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
    if q.device.type == "cpu":
        return plain_decode_attention(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"decode_attention: q/k/v must share float32 or bfloat16, got "
            f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}"
        )
    if cache_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: cache_len must be int32, got {cache_len.dtype}")
    for name, t in (("q", q),) + tensors:
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or H == 0:
        return out
    plan = decode_plan(q.dtype, B, H, KV, Smax, hd, _build.aligned16(k_cache, v_cache))
    err = _build.library().decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), B, Smax, H, KV, hd, plan["rows"], plan["splits"],
        plan["stages"], plan["tile"], int(plan["path"] == "cp.async"), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        cache_len: torch.Tensor, bk: int) -> torch.Tensor:
    """``decode_attention`` as the operator ``repro_torch::decode_attention``."""
    return decode_attention(q, k_cache, v_cache, cache_len, bk=bk)


@decode_attention_op.register_fake
def _decode_fake(q, k_cache, v_cache, cache_len, bk):
    return torch.empty_like(q)


decode_attention_op.register_vmap(_build.loop_vmap(decode_attention_op))


def decode_call(q, k_cache, v_cache, cache_len, *, bk: int = 512):
    """The dense decode kernel through its operator where
    ``_build.through_operator`` says so, straight to the wrapper
    otherwise."""
    if _build.through_operator(q):
        return decode_attention_op(q, k_cache, v_cache, cache_len, bk)
    return decode_attention(q, k_cache, v_cache, cache_len, bk=bk)
