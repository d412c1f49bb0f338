"""Shared building blocks: RMSNorm (plain and gated), RoPE, SwiGLU,
embeddings and the chunked cross-entropy.

Port of the JAX package's ``models/layers.py``, with the same rounding
order.

The ``*_split`` functions are a rank's share of the same layers in a
training step split over the mesh axis ``axis`` ("model"), each entered
and left through ``parallel/collectives.py``'s ``enter`` / ``leave``, so
that what comes out is replicated over the axis, as what went in: the
lookup of a vocab-split table, SwiGLU with its hidden dim split, the
cross-entropy over vocab-split logits and the gated norm over a split inner
dim. The JAX package's GSPMD partitions the same layers by their sharding
constraints.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import collectives as col


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


def gated_rms_norm_split(x, z, scale, eps, mesh, axis, width: int):
    """``gated_rms_norm`` over an inner dim split over ``axis``: x, z and
    scale are this rank's slices of the ``width``-wide dim; the sum of
    squares is summed over the axis both ways (its readers are split too)."""
    g = x * F.silu(z)
    dt = g.dtype
    gf = g.float()
    var = col.psum(gf.square().sum(dim=-1, keepdim=True), mesh, axis) / width
    return (gf * torch.rsqrt(var + eps)).to(dt) * scale


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


def swiglu_split(x, w1, w3, w2, mesh, axis="model"):
    """SwiGLU with the hidden dim split over ``axis``: w1/w3 [D, F/P] and
    w2 [F/P, D] this rank's slices; the partial products are summed."""
    return col.leave(swiglu(col.enter(x, mesh, axis), w1, w3, w2), mesh, axis)


def embed_tokens(embedding, tokens):
    """Rows of ``embedding`` for integer ``tokens`` (any int dtype)."""
    return embedding[tokens.long()]


def _vocab_range(mesh, axis, n_local):
    lo = col.axis_index(mesh, axis) * n_local
    return lo, lo + n_local


def embed_tokens_split(embedding, tokens, mesh, axis="model"):
    """The lookup in a table split over the vocabulary: ``embedding`` holds
    rows [r·V/P, (r+1)·V/P) on rank r, which takes the tokens in its range
    (zeros elsewhere); the sum over ``axis`` is each token's row."""
    lo, hi = _vocab_range(mesh, axis, embedding.shape[0])
    t = tokens.long()
    ok = (t >= lo) & (t < hi)
    rows = embedding[torch.where(ok, t - lo, 0)]
    return col.leave(torch.where(ok[..., None], rows, 0), mesh, axis)


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


def _chunked_xent(body, x, head, labels, mask, chunk, *extra):
    B, S, _ = x.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    mask = mask.float()
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    grad = torch.is_grad_enabled()
    for start in range(0, S, chunk):
        args = (x[:, start:start + chunk], head, labels[:, start:start + chunk],
                mask[:, start:start + chunk]) + extra
        part = (checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
                if grad else body(*args))
        tot = tot + part
        cnt = cnt + args[3].sum()
    return tot / torch.clamp(cnt, min=1.0), cnt


def chunked_softmax_xent(x, lm_head, labels, mask, *, chunk: int = 256):
    """Mean next-token cross-entropy without materialising [B, S, V]:
    x [B, S, D], lm_head [D, V], labels and mask [B, S] → (mean loss,
    total weight). The chunk is min(``chunk``, S), lowered until it divides
    S, as the JAX package's. Each chunk body runs under a non-reentrant
    checkpoint that keeps only its inputs (JAX's ``nothing_saveable``), so
    backward holds one chunk's [B, chunk, V] logits at a time; it draws no
    random number, so the checkpoint keeps no generator state."""
    return _chunked_xent(_xent_chunk, x, lm_head, labels, mask, chunk)


def _xent_chunk_split(xs, head, ls, ms, mesh, axis):
    """``_xent_chunk`` over vocab-split logits: ``head`` [D, V/P] is this
    rank's columns. The max (no gradient: it only shifts), the sum of
    exponentials and the label's logit are each summed over ``axis``."""
    logits = (xs @ head).float()
    m = col.all_reduce(logits.detach().amax(dim=-1), mesh, axis, "max")
    se = col.leave(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, axis)
    lse = m + torch.log(se)
    lo, hi = _vocab_range(mesh, axis, head.shape[1])
    t = ls.long()
    ok = (t >= lo) & (t < hi)
    tgt = torch.gather(logits, -1, torch.where(ok, t - lo, 0)[..., None])[..., 0]
    tgt = col.leave(torch.where(ok, tgt, 0.0), mesh, axis)
    return ((lse - tgt) * ms).sum()


def chunked_softmax_xent_split(x, head, labels, mask, mesh, axis="model", *, chunk: int = 256):
    """``chunked_softmax_xent`` with the vocabulary split over ``axis``:
    ``head`` [D, V/P] is this rank's columns of the head. The chunks and
    their checkpoints are ``chunked_softmax_xent``'s; each chunk's
    collectives run again in its recompute, in the same order on every
    rank. Returns (mean loss, total weight), replicated over ``axis``."""
    return _chunked_xent(_xent_chunk_split, col.enter(x, mesh, axis), head, labels, mask,
                         chunk, mesh, axis)
