"""The plain reference of the dense decoder, in float32 with TF32 off.

Pre-norm GQA transformer: RMSNorm (eps from the configuration), rotary
position embedding on the two halves of each head (theta from the
configuration), causal softmax attention with the key and value heads
shared by groups of n_heads / n_kv_heads query heads, a SwiGLU MLP, a
final RMSNorm and the LM head (the embedding's transpose when tied). It
reads the weights the benchmark made, in the parameter layout the program
takes (``layers`` stacked on a leading axis: ``attn/wq`` [L, D, H, hd],
``attn/wk``, ``attn/wv`` [L, D, KV, hd], ``attn/wo`` [L, H, hd, D],
``mlp/w1``, ``mlp/w3`` [L, D, F], ``mlp/w2`` [L, F, D]), upcasts one layer
at a time and runs every sequence of a check through it, so that it fits
beside those weights. It imports nothing of the program.

``quant="fp8"`` is the control: each product's operands are rounded to
float8 e4m3 first (the weights by output column, the activations by row,
each scaled by its absolute maximum), then multiplied in float32.
"""
from __future__ import annotations

import math

import torch

F8_MAX = 448.0  # the largest finite float8 e4m3fn


def precise() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """x [..., K] @ w [K, N] in float32 (the control rounds both first)."""
    if quant == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x [S, heads, hd], the rotation of the two halves of each head."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int = 512):
    """Causal softmax attention, q [S, H, hd], k and v [S, KV, hd], each
    key head serving H / KV query heads, in blocks of queries."""
    S, H, hd = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for a in range(0, S, block):
        b = min(S, a + block)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) / math.sqrt(hd)
        pos = torch.arange(b, device=q.device)
        s = s.masked_fill(pos[None, None, :] > pos[a:b][None, :, None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[:b])
    return out


def swiglu(x, lp, quant):
    w1, w3, w2 = (lp["mlp"][n].float() for n in ("w1", "w3", "w2"))
    return mm(torch.nn.functional.silu(mm(x, w1, quant)) * mm(x, w3, quant), w2, quant)


def layer_params(params, li):
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[li]

    return take(params["layers"])


def forward_logits(params, m: dict, seqs, *, quant=None, mlp=swiglu):
    """Logits of the next token, float32 [n_i, V] for each (tokens [S]
    int64, first scored position) of ``seqs``: positions first .. S-1."""
    precise()
    eps, theta = float(m["norm_eps"]), float(m["rope_theta"])
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    xs = [params["embed"][toks].float() for toks, _ in seqs]
    pos = [torch.arange(len(toks), device=toks.device) for toks, _ in seqs]
    for li in range(m["num_layers"]):
        lp = layer_params(params, li)
        a = lp["attn"]
        wq, wk, wv = (a[n].float().reshape(a[n].shape[0], -1) for n in ("wq", "wk", "wv"))
        wo = a["wo"].float().reshape(-1, a["wo"].shape[-1])
        attn_norm, mlp_norm = lp["attn_norm"].float(), lp["mlp_norm"].float()
        for i, x in enumerate(xs):
            S = x.shape[0]
            h = rms_norm(x, attn_norm, eps)
            q = rope(mm(h, wq, quant).reshape(S, H, hd), pos[i], theta)
            k = rope(mm(h, wk, quant).reshape(S, KV, hd), pos[i], theta)
            v = mm(h, wv, quant).reshape(S, KV, hd)
            x = x + mm(attention(q, k, v).reshape(S, H * hd), wo, quant)
            xs[i] = x + mlp(rms_norm(x, mlp_norm, eps), lp, quant)
    head = params["embed"].float().T if m.get("tie_embeddings") else params["lm_head"].float()
    head = head[:, :m["vocab_size"]]
    final = params["final_norm"].float()
    return [mm(rms_norm(x[first:], final, eps), head, quant)
            for x, (_, first) in zip(xs, seqs)]
