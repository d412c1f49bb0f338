"""Shared building blocks: RMSNorm (plain and gated), RoPE, SwiGLU, embeddings.

Port of the JAX package's ``models/layers.py`` (the serving subset),
with the same rounding order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps):
    """Normalise in float32, cast back to x's dtype, then scale — the
    reference's rounding order."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale


def gated_rms_norm(x, z, scale, eps):
    """Mamba2 output norm: rmsnorm(x * silu(z)) * scale."""
    return rms_norm(x * F.silu(z), scale, eps)


def rope_tables(positions, head_dim, theta):
    """positions [...] → (cos, sin) tables [..., head_dim/2] (float32)."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B, S, H, hd]; cos/sin [B, S, hd/2] or [S, hd/2]."""
    half = x.shape[-1] // 2
    while cos.dim() < x.dim():
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x, w1, w3, w2):
    """SwiGLU MLP: (silu(x w1) * (x w3)) w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def embed_tokens(embedding, tokens):
    """Rows of ``embedding`` for integer ``tokens`` (any int dtype)."""
    return embedding[tokens.long()]
