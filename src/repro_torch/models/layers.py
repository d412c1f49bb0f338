"""Shared building blocks: RMSNorm (plain and gated), RoPE, SwiGLU,
embeddings and the chunked cross-entropy.

Port of the JAX package's ``models/layers.py``, with the same rounding
order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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


# ---------------------------------------------------------------------------
# vocabulary / loss


def _xent_chunk(xs, lm_head, ls, ms):
    """Σ (logsumexp(logits) − logit of the label) · mask over one chunk:
    xs [B, chunk, D], ls and ms [B, chunk]. The logits are float32, over the
    padded vocabulary; the gathered target logit equals the JAX package's
    one-hot contraction bit for bit (one x·1 among zeros)."""
    logits = (xs @ lm_head).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, ls.long()[..., None])[..., 0]
    return ((lse - tgt) * ms).sum()


def chunked_softmax_xent(x, lm_head, labels, mask, *, chunk: int = 256):
    """Mean next-token cross-entropy without materialising [B, S, V]:
    x [B, S, D], lm_head [D, V], labels and mask [B, S] → (mean loss,
    total weight). The chunk is min(``chunk``, S), lowered until it divides
    S, as the JAX package's. Each chunk body runs under a non-reentrant
    checkpoint that keeps only its inputs (JAX's ``nothing_saveable``), so
    backward holds one chunk's [B, chunk, V] logits at a time; it draws no
    random number, so the checkpoint keeps no generator state."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    mask = mask.float()
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    grad = torch.is_grad_enabled()
    for start in range(0, S, chunk):
        args = (x[:, start:start + chunk], lm_head, labels[:, start:start + chunk],
                mask[:, start:start + chunk])
        part = (checkpoint(_xent_chunk, *args, use_reentrant=False, preserve_rng_state=False)
                if grad else _xent_chunk(*args))
        tot = tot + part
        cnt = cnt + args[3].sum()
    return tot / torch.clamp(cnt, min=1.0), cnt
