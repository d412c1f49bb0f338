"""Mamba2 SSD chunked scan (kernel 3 of the port).

Replaces the JAX package's Pallas TPU kernel ``kernels/ssd_scan.py::ssd_scan``
and adds the final state, which the serving prefill keeps, and sequences
of any length (a masked ragged last chunk); the CUDA source is
``csrc/ssd_scan.cu`` (its header says what bounds it on the H100 and what
the design does about it).

``ssd_scan`` dispatches on the tensors' device: CPU tensors take the plain
PyTorch version (``plain_ssd_scan``, the JAX model path's chunked scan,
which shrinks the chunk to a divisor of S), CUDA tensors the kernel — or
it raises. Its ``launches`` attribute counts kernel launches. ``ssd_plan``
says how the kernel launches: the chunks, how many blocks (one cluster)
share a (row, head)'s chunks, the column slice of hd a block takes, and
whether the products run on the tensor cores. ``ssd_scan_op`` is the same
function as the ``torch.library`` operator ``repro_torch::ssd_scan``,
which ``ssd_call`` takes only on meta tensors, under a transform or under
a dispatch mode (``_build.through_operator``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/ssd_scan.cu: chunks of at most 128 positions (a longer chunk runs as
# sub-chunks), head-dim columns in slices of 64 (32 or 16 where hd is not a
# multiple of 64; the last slice padded where 16 does not divide hd), 256
# threads a block, a cluster of at most 8 blocks sharing a (row, head,
# slice)'s chunks in contiguous runs, the block's b, c and x of a chunk and
# its state slice within the opt-in's 227 KB
MAX_CHUNK, HEAD_DIM_SLICE = 128, 16
SSD_THREADS, SSD_MAX_CLUSTER = 256, 8
SMEM_OPT_IN = 232_448


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def ssd_layout(Q: int, N: int, ds: int, es: int) -> int:
    """Bytes of dynamic shared memory a block takes (the kernel's
    ``ssd_layout``): b, c [Q][N] and x [Q][ds] in the inputs' type (rows
    padded by 16 bytes, Q and N rounded up to 16), the float32 state slice
    [ds][N + 4], la, dt, w [Q] and the run's decay."""
    qp, np_ = _round16(Q), _round16(N)
    return 2 * qp * (np_ * es + 16) + qp * (ds * es + 16) + 4 * ds * (np_ + 4) + 12 * qp + 16


def _kernel_chunk(chunk: int, S: int, N: int, ds0: int, es: int) -> tuple[int, int]:
    """(the kernel's chunk Q, column slice): a chunk above ``MAX_CHUNK``
    as equal sub-chunks of at most ``MAX_CHUNK``, at most S; where the
    block's layout does not fit the opt-in, Q shrinks to the largest
    multiple of 16 that fits, then the slice narrows. The carried state
    makes every Q the same scan."""
    q0 = min(-(-chunk // -(-chunk // MAX_CHUNK)), S)
    for ds in (64, 32, 16):
        if ds > ds0:
            continue
        Q = q0
        while Q > 16 and ssd_layout(Q, N, ds, es) > SMEM_OPT_IN:
            Q = (Q - 1) // 16 * 16
        if ssd_layout(Q, N, ds, es) <= SMEM_OPT_IN:
            return Q, ds
    n_max = 16
    while ssd_layout(16, n_max + 16, 16, es) <= SMEM_OPT_IN:
        n_max += 16
    raise ValueError(
        f"ssd_scan: no shared-memory layout fits N={N} ({es}-byte elements); the kernel "
        f"takes N up to {n_max}"
    )


def ssd_plan(dtype, B: int, S: int, H: int, hd: int, N: int, chunk: int = 128,
             aligned: bool = True) -> dict:
    """How ``csrc/ssd_scan.cu`` runs a scan of ``dtype``: chunks of
    ``chunk`` positions (``_kernel_chunk``: at most 128 and S, smaller
    where a wide state N needs it; the last one ragged), the ``chunks`` of
    each (row, head, column slice) dealt in contiguous runs of
    ``chunks_per_block`` to the ``cluster`` blocks of one thread-block
    cluster (the largest power of two ≤ 8 and ≤ the chunks), one block per
    (run, row, head, slice of ``slice`` columns of hd, the last padded
    where it does not divide hd): the grid (cluster, B·H, ⌈hd / slice⌉).
    bf16 runs its products on the tensor cores (c·b in bf16, the rest in
    TF32), float32 on the CUDA cores. The chunk rows arrive and y leaves
    by 16-byte copies (path "cp.async") where the rows of b, c and x are
    multiples of 16 bytes and x, b, c are ``aligned``, else by element
    loads and stores ("direct")."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: no kernel for {dtype}")
    es = 4 if dtype == torch.float32 else 2
    ds0 = 64 if hd % 64 == 0 else 32 if hd % 32 == 0 else HEAD_DIM_SLICE
    Q, ds = _kernel_chunk(chunk, S, N, ds0, es)
    chunks = -(-S // Q)
    cluster = 1
    while 2 * cluster <= min(SSD_MAX_CLUSTER, chunks):
        cluster *= 2
    fast = aligned and N * es % 16 == 0 and hd * es % 16 == 0
    return {"path": "cp.async" if fast else "direct",
            "tensor_cores": dtype == torch.bfloat16, "chunk": Q, "chunks": chunks,
            "cluster": cluster, "chunks_per_block": -(-chunks // cluster), "slice": ds,
            "grid": (cluster, B * H, -(-hd // ds)), "threads": SSD_THREADS,
            "smem": ssd_layout(Q, N, ds, es)}


def plain_ssd_scan(xh, a, b, c, dt, chunk: int = 128):
    """The kernel's function in plain PyTorch, as the JAX model path's
    ``_ssd_chunk_scan`` computes it: the chunk length Q shrinks to the
    largest divisor of S that is ≤ ``chunk``, the quadratic form runs
    within each chunk and a float32 state [B,H,hd,N] carries between
    chunks. Returns (y [B,S,H,hd] in xh's dtype, final state)."""
    B, S, H, hd = xh.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    xf = xh.float().reshape(B, nc, Q, H, hd)
    bf = b.float().reshape(B, nc, Q, N)
    cf = c.float().reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)
    la = torch.cumsum(torch.log(torch.clamp(a, min=1e-20)).reshape(B, nc, Q, H), dim=2)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    state = torch.zeros((B, H, hd, N), dtype=torch.float32, device=xh.device)
    ys = []
    for k in range(nc):
        lak, xk, bk, ck, dk = la[:, k], xf[:, k], bf[:, k], cf[:, k], dtc[:, k]
        # intra-chunk (causal quadratic): att[i,j] = (c_i·b_j)·exp(la_i-la_j)·dt_j
        seg = torch.exp(torch.clamp(lak[:, :, None, :] - lak[:, None, :, :], -60.0, 0.0))
        cb = torch.einsum("bin,bjn->bij", ck, bk)
        att = cb[..., None] * seg * dk[:, None, :, :]
        att = torch.where(causal[None, :, :, None], att, 0.0)
        y_intra = torch.einsum("bijh,bjhd->bihd", att, xk)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bin,bhdn,bih->bihd", ck, state, torch.exp(lak))
        # S' = S·exp(la_end) + Σ_j b_j ⊗ (x_j·dt_j·exp(la_end-la_j))
        w = dk * torch.exp(torch.clamp(lak[:, -1:] - lak, -60.0, 60.0))
        state = state * torch.exp(lak[:, -1])[:, :, None, None] + torch.einsum(
            "bjhd,bjn,bjh->bhdn", xk, bk, w
        )
        ys.append((y_intra + y_inter).to(xh.dtype))
    return torch.stack(ys, dim=1).reshape(B, S, H, hd), state


def ssd_scan(xh, a, b, c, dt, chunk: int = 128):
    """xh [B,S,H,hd]; a, dt [B,S,H] float32; b, c [B,S,N] in xh's dtype
    → (y [B,S,H,hd] in xh's dtype, final state [B,H,hd,N] float32).
    The kernel runs chunks of at most ``chunk`` positions (``ssd_plan``)
    with a masked ragged last chunk; the plain version shrinks the chunk to
    a divisor of S. Any N, hd and chunk whose layout fits in 227 KB."""
    _build.refuse_grad("ssd_scan", xh, a, b, c, dt)
    tensors = (("xh", xh), ("a", a), ("b", b), ("c", c), ("dt", dt))
    for name, t in tensors[1:]:
        if t.device != xh.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, xh on {xh.device}")
    if xh.device.type == "cpu":
        return plain_ssd_scan(xh, a, b, c, dt, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {xh.device}")
    B, S, H, hd = xh.shape
    N = b.shape[-1]
    if xh.dtype not in _DTYPES or b.dtype != xh.dtype or c.dtype != xh.dtype:
        raise TypeError(
            f"ssd_scan: xh/b/c must share float32 or bfloat16, got "
            f"{xh.dtype}/{b.dtype}/{c.dtype}"
        )
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise TypeError(f"ssd_scan: a and dt must be float32, got {a.dtype}/{dt.dtype}")
    if (a.shape != (B, S, H) or dt.shape != (B, S, H) or b.shape != (B, S, N)
            or c.shape != (B, S, N)):
        raise ValueError(
            f"ssd_scan: bad shapes xh{tuple(xh.shape)} a{tuple(a.shape)} "
            f"b{tuple(b.shape)} c{tuple(c.shape)} dt{tuple(dt.shape)}"
        )
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    y = torch.empty_like(xh)
    if B == 0 or S == 0 or H == 0:
        return y, torch.zeros((B, H, hd, N), dtype=torch.float32, device=xh.device)
    state = torch.empty((B, H, hd, N), dtype=torch.float32, device=xh.device)
    plan = ssd_plan(xh.dtype, B, S, H, hd, N, chunk, _build.aligned16(xh, b, c, y))
    err = _build.library().ssd_scan(
        _DTYPES[xh.dtype], xh.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        dt.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, hd, N, plan["chunk"],
        plan["slice"], plan["cluster"], int(plan["path"] == "cp.async"),
        torch.cuda.current_stream(xh.device).cuda_stream,
    )
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(xh: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``ssd_scan`` as the operator ``repro_torch::ssd_scan``."""
    return ssd_scan(xh, a, b, c, dt, chunk)


@ssd_scan_op.register_fake
def _ssd_fake(xh, a, b, c, dt, chunk):
    B, _, H, hd = xh.shape
    return torch.empty_like(xh), xh.new_empty((B, H, hd, b.shape[-1]), dtype=torch.float32)


ssd_scan_op.register_vmap(_build.loop_vmap(ssd_scan_op))


def ssd_call(xh, a, b, c, dt, chunk: int = 128):
    """The SSD scan through its operator where ``_build.through_operator``
    says so, straight to the wrapper otherwise."""
    if _build.through_operator(xh):
        return ssd_scan_op(xh, a, b, c, dt, chunk)
    return ssd_scan(xh, a, b, c, dt, chunk)
