"""Mamba2 (SSD, state-space duality) block, chunked formulation.

Port of the JAX package's ``models/ssm.py``. Prefill: the sequence is
split into chunks; within a chunk the recurrence is a causal quadratic
contraction, between chunks a float32 state [B,H,hd,N] is carried. The
``"kernel"`` backend runs that scan as the hand-written SSD kernel
(``kernels/ssd_scan.py``), the ``"reference"`` backend as the JAX model
path's plain ``_ssd_chunk_scan``. Decode: the O(1) one-step recurrence in
plain PyTorch ops, as the JAX package runs it in einsums.

n_groups = 1 (B/C shared across heads); A is a per-head scalar (Mamba2).

``ssm_block_split`` is a rank's share of the block split over the SSM heads,
in training and in serving (see its docstring).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.models.layers import gated_rms_norm, gated_rms_norm_split
from repro_torch.parallel import collectives as col

# the per-head SSM scalars are float32 in every model dtype
FLOAT32_PARAMS = ("A_log", "dt_bias", "D")

_ssd_chunk_scan = _ssd.plain_ssd_scan


# the logical axes of ``init_ssm``'s leaves (the JAX package's ``init_ssm``
# returns them beside the parameters)
SSM_AXES = {
    "wx": ("embed", "ssm_inner"),
    "wz": ("embed", "ssm_inner"),
    "wB": ("embed", "state"),
    "wC": ("embed", "state"),
    "wdt": ("embed", "ssm_heads"),
    "conv_x": ("conv", "ssm_inner"),
    "conv_B": ("conv", "state"),
    "conv_C": ("conv", "state"),
    "A_log": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
    "D": ("ssm_heads",),
    "norm": ("ssm_inner",),
    "out": ("ssm_inner", "embed"),
}


def init_ssm(cfg, dtype, gen: torch.Generator, lead: tuple = (),
             device=None) -> dict:
    """Seeded random SSM parameters at the JAX package's scales, each with
    the leading dims ``lead`` (``(L,)`` for a layer stack), drawn on the
    generator's device (``gen`` None: meta tensors on ``device``)."""
    d, di, ns = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    h, cw = cfg.ssm_heads, cfg.ssm_conv
    dev = gen.device if gen is not None else device

    def normal(shape, scale):
        x = torch.randn(lead + shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * scale).to(dtype)

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    s = d**-0.5
    return {
        "wx": normal((d, di), s),
        "wz": normal((d, di), s),
        "wB": normal((d, ns), s),
        "wC": normal((d, ns), s),
        "wdt": normal((d, h), s),
        "conv_x": normal((cw, di), cw**-0.5),
        "conv_B": normal((cw, ns), cw**-0.5),
        "conv_C": normal((cw, ns), cw**-0.5),
        "A_log": full((h,), 0.0, torch.float32),  # A = -exp(A_log) = -1
        "dt_bias": full((h,), -2.0, torch.float32),  # softplus ≈ 0.12
        "D": full((h,), 1.0, torch.float32),
        "norm": full((di,), 1.0, dtype),
        "out": normal((di, d), di**-0.5),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x [B,S,C], w [K,C], state [B,K-1,C] (decode).
    Returns (y, new_state)."""
    K = w.shape[0]
    pad = x.new_zeros((x.shape[0], K - 1, x.shape[2])) if state is None else state
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, C]
    y = sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(K))
    return y, xp[:, -(K - 1) :, :]


def _chunk_scan(xh, a, b, c, dt, chunk, backend):
    if kernel_ops.resolve_attention_backend(backend, xh.device) == "kernel":
        kernel_ops.require_cuda(xh, "ssm_block")
        return _ssd.ssd_call(
            xh.contiguous(), a.contiguous(), b.contiguous(), c.contiguous(),
            dt.contiguous(), chunk,
        )
    return _ssd_chunk_scan(xh, a, b, c, dt, chunk)


def ssm_block(params, x, cfg, state=None, want_state=False, backend=None):
    """Mamba2 block. x [B,S,D].

    Train: state=None → chunked scan, returns (y, None).
    Prefill: state=None, want_state=True → (y, final state dict).
    Decode: state = dict(ssm [B,H,hd,N] fp32, conv_x, conv_B, conv_C)
    → one-step update, returns (y, new_state).
    """
    return _ssm_core(params, x, cfg, state, want_state, backend,
                     lambda y, z: gated_rms_norm(y, z, params["norm"], cfg.norm_eps))


def _ssm_core(params, x, cfg, state, want_state, backend, norm):
    """``ssm_block``'s body over the heads ``params`` hold (all of them, or
    a rank's slice: the head count is read off ``wdt``), the gated norm
    ``norm(y, z)`` given."""
    B, S, D = x.shape
    h, hd = params["wdt"].shape[-1], cfg.ssm_head_dim
    xz = x @ params["wx"]
    z = x @ params["wz"]
    b = x @ params["wB"]
    c = x @ params["wC"]
    dt = F.softplus((x @ params["wdt"]).float() + params["dt_bias"])

    new_state = None
    if state is None:
        xz, cx = _causal_conv(xz, params["conv_x"])
        b, cb = _causal_conv(b, params["conv_B"])
        c, cc = _causal_conv(c, params["conv_C"])
        if want_state:
            new_state = {"conv_x": cx, "conv_B": cb, "conv_C": cc}
    else:
        xz, cx = _causal_conv(xz, params["conv_x"], state["conv_x"])
        b, cb = _causal_conv(b, params["conv_B"], state["conv_B"])
        c, cc = _causal_conv(c, params["conv_C"], state["conv_C"])
        new_state = {"conv_x": cx, "conv_B": cb, "conv_C": cc}
    xz, b, c = F.silu(xz), F.silu(b), F.silu(c)

    A = -torch.exp(params["A_log"])  # [H]
    a = torch.exp(dt * A)  # [B,S,H]
    xh = xz.reshape(B, S, h, hd)

    if state is None:
        y, s_final = _chunk_scan(xh, a, b, c, dt, cfg.ssm_chunk, backend)
        if want_state:
            new_state["ssm"] = s_final
    else:
        # one-step recurrence: S' = S·a + dt·(b ⊗ x); y = c·S' (+ skip below)
        xf = xh[:, 0].float()  # [B,H,hd]
        s_new = state["ssm"] * a[:, 0][:, :, None, None] + torch.einsum(
            "bhd,bn,bh->bhdn", xf, b[:, 0].float(), dt[:, 0]
        )
        y = torch.einsum("bn,bhdn->bhd", c[:, 0].float(), s_new)
        y = y[:, None].to(x.dtype).reshape(B, 1, h, hd)
        new_state["ssm"] = s_new

    y = y + params["D"][None, None, :, None].to(y.dtype) * xh
    y = norm(y.reshape(B, S, h * hd), z)
    return y @ params["out"], new_state


def ssm_block_split(params, x, cfg, mesh, axis="model", *, state=None, want_state=False,
                    backend="reference"):
    """``ssm_block`` as a rank's share of a split over the SSM heads on
    ``axis``: x [B, S, D] replicated in and out → (y, state or None). The
    rank holds its slices of ``wx``, ``wz``, ``conv_x``, ``norm`` and
    ``out`` ("ssm_inner": heads [r·h/P, (r+1)·h/P) times their head dim)
    and of ``wdt``, ``A_log``, ``dt_bias`` and ``D`` ("ssm_heads"); ``wB``,
    ``wC`` and their convs are whole, read by every rank for its own heads,
    so their gradients are partial. The gated norm sums its squares over
    the axis, and the partial output projections are summed. A state (the
    one-step decode's input, and what a prefill returns with
    ``want_state``) is the rank's: ``ssm`` over its heads, ``conv_x`` over
    its inner slice, ``conv_B`` / ``conv_C`` whole. Training takes the
    reference scan; serving passes its backend."""
    x = col.enter(x, mesh, axis)

    def norm(y, z):
        return gated_rms_norm_split(y, z, params["norm"], cfg.norm_eps, mesh, axis,
                                    cfg.ssm_d_inner)

    y, new_state = _ssm_core(params, x, cfg, state, want_state, backend, norm)
    return col.leave(y, mesh, axis), new_state


def init_ssm_state(cfg, batch, dtype, device) -> dict:
    """Zero decode state: ``ssm`` [B,H,hd,N] float32, the conv windows
    [B,K-1,C] in the model dtype."""
    h, hd, ns, cw = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    return {
        "ssm": torch.zeros((batch, h, hd, ns), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, cw - 1, cfg.ssm_d_inner), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, cw - 1, ns), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, cw - 1, ns), dtype=dtype, device=device),
    }
