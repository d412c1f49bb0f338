"""Cross-pod gradient compression with error feedback.

Port of the JAX package's ``parallel/compression.py``: the gradient
all-reduce over the 'pod' axis (the slow inter-pod link) moves int8
payloads instead of float32 ones. Each tensor is quantized with one scale
shared by every rank (an all-reduce max), so the summed payload
dequantizes exactly; the residual of the quantization is fed back into the
next step's gradient.

The JAX package sums the int8 payloads as int16 (≤ 127·n fits for n ≤
258 ranks). gloo refuses an int16 all-reduce, so the port sums them as
int32: exact either way, and the same result.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import collectives as col
from repro_torch.tree import flatten, unflatten


def _quantize(g, scale):
    """(int8 payload, residual g − payload·scale): round half to even,
    clipped to ±127."""
    q = torch.clamp(torch.round(g / scale), -127, 127)
    return q.to(torch.int8), g - q * scale


def compressed_psum(g, mesh, axis: str, err):
    """The mean of ``g`` over ``axis`` through an int8 all-reduce →
    (mean_g float32, new_err). ``err`` is the residual of the last step
    (``g``'s shape; zeros at first)."""
    n = col.group_size(mesh, axis)
    g_fb = g + err
    scale = torch.clamp(torch.max(torch.abs(g_fb)) / 127.0, min=1e-12)
    # one scale on every rank, so the summed payload dequantizes exactly
    # (the max is exact in any float type: reduce it in float32)
    scale = col.all_reduce(scale.float(), mesh, axis, op="max").to(scale.dtype)
    q, new_err = _quantize(g_fb, scale)
    total = col.all_reduce(q.to(torch.int32), mesh, axis)  # ≤ 127·n: exact
    return total.to(torch.float32) * scale / n, new_err


def compressed_grad_tree(grads, mesh, axis: str, err_tree):
    """``compressed_psum`` over each leaf → (mean grads, new residuals)."""
    flat_g, spec = flatten(grads)
    flat_e = flatten(err_tree)[0]
    outs = [compressed_psum(g, mesh, axis, e) for g, e in zip(flat_g, flat_e)]
    return unflatten(spec, [o[0] for o in outs]), unflatten(spec, [o[1] for o in outs])
