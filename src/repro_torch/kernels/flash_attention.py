"""GQA flash attention, causal with a query offset or non-causal (kernel 2
of the port).

Replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention`` in both its modes and
extends the causal one with ``q_offset`` and ragged Sq/Skv, which the
serving prefill needs; the CUDA source is ``csrc/flash_attention.cu`` (its
header says what bounds it on the H100 and what the design does about it).

``flash_attention`` dispatches on the tensors' device: CPU tensors take
the plain PyTorch version (``plain_flash_attention``, the full-softmax
oracle), CUDA tensors the kernel — or it raises. Its ``launches``
attribute counts causal kernel launches, ``launches_noncausal`` the
others. On the card ``flash_plan`` decides the path: bf16 at hd 64, 80 or
128 with 16-byte-aligned q, k and v on the tensor cores (TMA-fed ``wgmma``),
every other bf16 input and float32 on the CUDA cores. ``flash_attention_op``
is the same function as the ``torch.library`` operator
``repro_torch::flash_attention``; the models call ``flash_call``, which
takes the operator only on meta tensors, under a transform or under a
dispatch mode (``_build.through_operator``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 80, 128)  # csrc/flash_attention.cu's flash_kernel_wgmma


def flash_plan(dtype, B: int, Sq: int, H: int, KV: int, hd: int, aligned: bool = True) -> dict:
    """How ``csrc/flash_attention.cu`` runs attention of ``dtype`` over q
    [B,Sq,H,hd] and kv heads KV on the card: its path, query rows and keys
    a tile, threads and grid of a launch, and for the ``wgmma`` path the
    K/V ring's stages and the TMA boxes (elements, innermost first, over
    [B, S, heads, hd]) that bring Q, K and V in. bf16 at hd 64, 80 or 128
    takes the ``wgmma`` path where q, k and v are ``aligned`` (16-byte
    boundaries, as TMA needs); a head size past the 64-column swizzle atom
    comes as a 64-column box and a tail box: 16 columns at hd 80, a second
    64-column box at hd 128. Every other bf16 input and
    float32 takes the CUDA-core kernel; only a dtype no kernel takes
    raises."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and aligned:
        boxes = [(64, 1, 64, 1)] + ([(hd - 64, 1, 64, 1)] if hd > 64 else [])
        return {"path": "wgmma", "rows": 64, "keys": 64, "threads": 160,
                "grid": (-(-Sq // 64) * H * B,), "stages": 2, "boxes": boxes}
    return {"path": "cuda_cores", "rows": 16 * (H // KV), "keys": 32, "threads": 128,
            "grid": (-(-Sq // 16), B * KV)}


def plain_flash_attention(q, k, v, q_offset: int = 0, causal: bool = True):
    """The kernel's function in plain PyTorch: causal with query i at
    position ``q_offset + i``, or non-causal."""
    return attention_ref(q, k, v, causal=causal, q_offset=q_offset)


def flash_attention(q, k, v, q_offset: int = 0, causal: bool = True):
    """q [B,Sq,H,hd]; k, v [B,Skv,KV,hd] (H a multiple of KV) → [B,Sq,H,hd].
    Causal: query i attends keys j ≤ ``q_offset + i``; non-causal: every
    query attends every key (``q_offset`` unused)."""
    _build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, q_offset, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hd_k = k.shape
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q/k/v must share float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if v.shape != k.shape or Bk != B or hd_k != hd or H % KV or q_offset < 0:
        raise ValueError(
            f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} q_offset={q_offset}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    plan = flash_plan(q.dtype, B, Sq, H, KV, hd, _build.aligned16(q, k, v))
    if B == 0 or Sq == 0:
        return torch.empty_like(q)
    out = _launch_flash(q, k, v, q_offset, causal, plan)
    if causal:
        flash_attention.launches += 1
    else:
        flash_attention.launches_noncausal += 1
    return out


def _launch_flash(q, k, v, q_offset: int, causal: bool, plan: dict):
    """Launch the kernel ``plan`` describes on checked, non-empty CUDA
    tensors and return the output. It counts nothing: ``flash_attention``
    counts its launches, and only a measurement harness calls this
    directly (to time the other path on the same inputs)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    wgmma = plan["path"] == "wgmma"
    err = _build.library().flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, hd, int(q_offset), int(causal), 1.0 / math.sqrt(hd), int(wgmma),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    return out


flash_attention.launches = 0
flash_attention.launches_noncausal = 0


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
                       causal: bool) -> torch.Tensor:
    """``flash_attention`` as the operator ``repro_torch::flash_attention``:
    the kernel on CUDA tensors (counted as the wrapper counts it), the
    plain version on CPU tensors; its fake gives the output's shape."""
    return flash_attention(q, k, v, q_offset, causal)


@flash_attention_op.register_fake
def _flash_fake(q, k, v, q_offset, causal):
    return torch.empty_like(q)


flash_attention_op.register_vmap(_build.loop_vmap(flash_attention_op))


def flash_call(q, k, v, q_offset: int = 0, causal: bool = True):
    """The flash kernel as the models and ``kernels.ops`` call it: through
    the operator where ``_build.through_operator`` says so, straight to the
    wrapper otherwise."""
    if _build.through_operator(q):
        return flash_attention_op(q, k, v, int(q_offset), bool(causal))
    return flash_attention(q, k, v, q_offset, causal)
