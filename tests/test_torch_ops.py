"""The port's kernel library entry points (``repro_torch.kernels.ops``) on
the CPU, held against the JAX package's ``kernels/ops.py`` with its Pallas
kernels in interpret mode, as ``tests/test_kernels.py`` runs them.

Inputs are numpy arrays from a seed, handed to both packages (bf16 inputs
are rounded from the same float32 numbers on both sides). On CPU tensors
an entry point's ``"auto"`` mode is the plain version; the kernel
wrappers behind the entry points run their plain versions too, and both
are checked. The Pallas partials mode has no CPU entry point in the port
(``paged_attention_partials`` is kernel-only, as in JAX): its kernel
wrapper's plain version and ``models/attention.paged_flash_partials``
stand for it.

Tolerances: float32 2e-5 absolute, 2e-5 relative for attention and 1e-5
for the products (both sides sum float32 values in different orders: the
products' sums reach |20| at K = 256, so an output near zero carries ~1e-5
of absolute rounding); bf16 2e-2 (one rounding of the output to
bf16 on each side, 2^-8 relative, from sums in different orders); the
SSD scan atol 1e-4 / rtol 1e-3 as ``tests/test_kernels.py`` holds it
(the chunked kernel against the sequential recurrence).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import relic_matmul as rm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import attention as tattn

ATOL = 2e-5
NEG = np.float32(-1e30)


def _both(a, dtype=np.float32):
    """One numpy array as a torch tensor and a jax array of ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)
    return torch.from_numpy(a), jnp.asarray(a)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# matmul / gemv


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (32, 64, 48, 16, 16, 16),
    (64, 128, 96, 32, 64, 32),
    (128, 256, 128, 64, 128, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(m, k, n, bm, bk, bn, dtype):
    rng = np.random.default_rng(m + n)
    (tx, jx), (tw, jw) = (_both(rng.normal(size=s).astype(np.float32), dtype)
                          for s in ((m, k), (k, n)))
    want = _np(jops.matmul(jx, jw, bm=bm, bk=bk, bn=bn, mode="interpret"))
    atol, rtol = (ATOL, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
    for got in (tops.matmul(tx, tw, bm=bm, bk=bk, bn=bn),
                rm.relic_matmul(tx, tw, bm=bm, bk=bk, bn=bn)):
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(_np(got), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("b,k,n", [(1, 128, 64), (8, 256, 128), (3, 256, 128)])
def test_gemv_matches_pallas(b, k, n):
    rng = np.random.default_rng(b * k)
    (tx, jx), (tw, jw) = (_both(rng.normal(size=s).astype(np.float32)) for s in ((b, k), (k, n)))
    want = np.asarray(jops.gemv(jx, jw, bk=64, bn=32, mode="interpret"))
    for got in (tops.gemv(tx, tw, bk=64, bn=32), rm.relic_gemv(tx, tw, bk=64, bn=32)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


def test_block_contracts_refuse_what_jax_refuses():
    """smollm-135m's K = 576 is no multiple of the default bk = 512: the
    JAX kernel asserts, the port's kernel wrappers raise (on CPU tensors
    too, before any dispatch)."""
    x = np.ones((16, 576), np.float32)
    w = np.ones((576, 64), np.float32)
    with pytest.raises(AssertionError):
        jops.matmul(jnp.asarray(x), jnp.asarray(w), mode="interpret")
    with pytest.raises(ValueError, match="bk=min"):
        rm.relic_matmul(torch.from_numpy(x), torch.from_numpy(w))
    with pytest.raises(AssertionError):
        jops.gemv(jnp.asarray(x[:2]), jnp.asarray(w), bk=512, mode="interpret")
    with pytest.raises(ValueError, match="bk=min"):
        rm.relic_gemv(torch.from_numpy(x[:2]), torch.from_numpy(w), bk=512)
    rm.relic_matmul(torch.from_numpy(x), torch.from_numpy(w), bk=576)  # a dividing block
    kc = torch.zeros(1, 96, 1, 16)
    with pytest.raises(ValueError, match="Smax=96"):
        da.decode_attention(torch.zeros(1, 1, 16), kc, kc, torch.tensor([3]), bk=64)
    with pytest.raises(AssertionError):
        jops.decode_attention(jnp.zeros((1, 1, 16)), jnp.asarray(kc.numpy()),
                              jnp.asarray(kc.numpy()), jnp.array([3]), bk=64, mode="interpret")


# ---------------------------------------------------------------------------
# flash attention, both modes


@pytest.mark.parametrize("b,s,h,kv,hd,bq,bk", [
    (1, 64, 4, 4, 16, 32, 32),     # MHA
    (2, 128, 8, 4, 32, 32, 64),    # GQA g=2
    (2, 128, 8, 2, 32, 64, 32),    # GQA g=4
    (1, 256, 4, 1, 64, 64, 64),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(b, s, h, kv, hd, bq, bk, causal):
    rng = np.random.default_rng(s * h + kv)
    (tq, jq), (tk, jk), (tv, jv) = (
        _both(rng.normal(size=sh).astype(np.float32))
        for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    )
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                           mode="interpret"))
    for got in (tops.flash_attention(tq, tk, tv, causal=causal, bq=bq, bk=bk),
                fa.flash_attention(tq, tk, tv, 0, causal)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------------------
# dense decode attention


@pytest.mark.parametrize("b,h,kv,hd,smax,bk", [
    (2, 8, 4, 32, 256, 64),
    (1, 4, 4, 64, 128, 128),
    (4, 16, 2, 16, 512, 256),
])
@pytest.mark.parametrize("lens", ["random", "edges"])
def test_decode_attention_matches_pallas(b, h, kv, hd, smax, bk, lens):
    """Random lengths in [1, Smax] at the shapes of ``tests/test_kernels``,
    and the edges 0, 1, Smax (plus one random) on four rows. Length 0 is
    held to the Pallas kernel's zeros, not to the JAX oracle's NaN."""
    rng = np.random.default_rng(smax + h)
    if lens == "edges":
        b = 4
        clen = np.array([0, 1, smax, rng.integers(2, smax)], np.int32)
    else:
        clen = rng.integers(1, smax + 1, size=b).astype(np.int32)
    (tq, jq), (tk, jk), (tv, jv) = (
        _both(rng.normal(size=sh).astype(np.float32))
        for sh in ((b, h, hd), (b, smax, kv, hd), (b, smax, kv, hd))
    )
    tl, jl = _both(clen)
    want = np.asarray(jops.decode_attention(jq, jk, jv, jl, bk=bk, mode="interpret"))
    for got in (tops.decode_attention(tq, tk, tv, tl, bk=bk),
                da.decode_attention(tq, tk, tv, tl, bk=bk)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
        assert np.isfinite(got.numpy()).all()
        assert not got.numpy()[clen == 0].any()  # an empty row is zeros


# ---------------------------------------------------------------------------
# paged attention and its partials mode


def _pool_case(seed, t, int8=False, g=2):
    """A paged pool (the last block is the null block) with lengths 0, a
    block boundary, two blocks and a block interior, a null entry inside a
    live window, and a random ownership in which row 1 owns nothing."""
    B, KV, hd, NB, BS, MB = 4, 2, 16, 12, 8, 4
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, t, KV * g, hd)).astype(np.float32)
    if int8:
        kp, vp = (rng.integers(-127, 128, size=(NB + 1, BS, KV, hd)).astype(np.int8)
                  for _ in range(2))
        scales = [rng.uniform(0.5, 2.0, size=(NB + 1, BS, KV)).astype(np.float32)
                  for _ in range(2)]
    else:
        kp, vp = (rng.normal(size=(NB + 1, BS, KV, hd)).astype(np.float32) for _ in range(2))
        scales = None
    tbl = rng.integers(0, NB, size=(B, MB)).astype(np.int32)
    lens = np.array([0, BS, 2 * BS, 3 * BS - t - 1], np.int32)
    for r in range(B):
        tbl[r, -(-(lens[r] + t) // BS):] = NB
    tbl[3, 1] = NB
    owned = rng.integers(0, 2, size=(B, MB)).astype(np.int32)
    owned[0, 0] = 1  # row 0's one key is owned
    owned[1] = 0
    return q, kp, vp, tbl, lens, owned, scales


def _to_both(q, kp, vp, tbl, lens, scales):
    t_args = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    j_args = [jnp.asarray(a) for a in (q, kp, vp, tbl, lens)]
    if scales is None:
        return t_args + [None, None], j_args + [None, None]
    return (t_args + [torch.from_numpy(s).to(torch.bfloat16) for s in scales],
            j_args + [jnp.asarray(s, jnp.bfloat16) for s in scales])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("t", [1, 3])
def test_paged_attention_matches_pallas(t, int8):
    q, kp, vp, tbl, lens, _, scales = _pool_case(20 + t, t, int8)
    t_args, j_args = _to_both(q, kp, vp, tbl, lens, scales)
    want = np.asarray(jops.paged_attention(*j_args, mode="interpret"))
    for got in (tops.paged_attention(*t_args), tops.paged_attention(*t_args, mode="ref"),
                pda.paged_decode_attention(*t_args)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("t", [1, 3])
def test_paged_partials_match_pallas(t, int8):
    """m, l and acc of the kernel wrapper's plain partials and of the
    port's ``paged_flash_partials`` reference against the Pallas partials
    mode; the row that owns nothing is exactly (-1e30, 0, 0) in all three."""
    q, kp, vp, tbl, lens, owned, scales = _pool_case(30 + t, t, int8)
    t_args, j_args = _to_both(q, kp, vp, tbl, lens, scales)
    t_own = torch.from_numpy(owned)
    want = [np.asarray(a) for a in jattn.paged_flash_partials(
        *j_args[:5], jnp.asarray(owned), k_scale=j_args[5], v_scale=j_args[6],
        backend="interpret")]
    for got in (pda.paged_decode_attention(*t_args, owned=t_own, partials=True),
                tattn.paged_flash_partials(*t_args[:5], t_own, k_scale=t_args[5],
                                           v_scale=t_args[6], backend="reference")):
        got = [a.numpy() for a in got]
        assert all(a.dtype == np.float32 for a in got)
        for name, g_, w_ in zip("mla", got, want):
            np.testing.assert_allclose(g_, w_, atol=ATOL, rtol=ATOL, err_msg=name)
        m, l, acc = got
        assert (m[1] == NEG).all() and not l[1].any() and not acc[1].any()
    assert (want[0][1] == NEG).all() and not want[1][1].any() and not want[2][1].any()


@pytest.mark.parametrize("t", [1, 3])
def test_complementary_partials_combine_to_paged_attention(t):
    """Two ranks with complementary ownership, combined as the JAX
    package's ``distributed_softmax`` combines them (an empty rank, m at
    the -1e30 sentinel, scales by 0), equal the unsplit attention."""
    q, kp, vp, tbl, lens, owned, _ = _pool_case(40 + t, t)
    t_args, _ = _to_both(q, kp, vp, tbl, lens, None)
    parts = [pda.paged_decode_attention(*t_args, owned=torch.from_numpy(o), partials=True)
             for o in (owned, 1 - owned)]
    m = torch.maximum(parts[0][0], parts[1][0])
    scales = [torch.where(p[0] <= NEG, 0.0, torch.exp(p[0] - m)) for p in parts]
    l = sum(p[1] * s for p, s in zip(parts, scales))
    acc = sum(p[2] * s[..., None] for p, s in zip(parts, scales))
    combined = acc / torch.clamp(l, min=torch.finfo(torch.float32).tiny)[..., None]
    want = tops.paged_attention(*t_args)
    np.testing.assert_allclose(combined.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    # owning every block, the partials mode normalises to the same output
    full = pda.paged_decode_attention(*t_args, owned=torch.ones_like(torch.from_numpy(owned)))
    np.testing.assert_allclose(full.numpy(), want.numpy(), atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------------------
# SSD scan


def test_ssd_matches_pallas():
    b, s, h, hd, n, chunk = 2, 64, 4, 16, 16, 16
    rng = np.random.default_rng(7)
    xh = (rng.normal(size=(b, s, h, hd)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = np.exp(-dt * 0.7).astype(np.float32)
    bb = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cc = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    want = np.asarray(jops.ssd(*(jnp.asarray(v) for v in (xh, a, bb, cc, dt)), chunk=chunk,
                               mode="interpret"))
    args = [torch.from_numpy(v) for v in (xh, a, bb, cc, dt)]
    for got in (tops.ssd(*args, chunk=chunk), ssd.ssd_scan(*args, chunk)[0]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# dispatch


def _entry_calls(mode):
    """One call of every generic entry point on small CPU tensors."""
    x, w = torch.randn(8, 16), torch.randn(16, 8)
    q, kv = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    xh, a, bc = torch.randn(1, 8, 2, 16), torch.rand(1, 8, 2), torch.randn(1, 8, 4)
    return {
        "matmul": lambda: tops.matmul(x, w, mode=mode),
        "gemv": lambda: tops.gemv(x[:2], w, mode=mode),
        "flash_attention": lambda: tops.flash_attention(q, kv, kv, causal=False, mode=mode),
        "decode_attention": lambda: tops.decode_attention(q[:, 0], kv, kv, torch.tensor([3]),
                                                          mode=mode),
        "ssd": lambda: tops.ssd(xh, a, bc, bc, a, mode=mode),
    }


def test_kernel_mode_resolution(monkeypatch):
    monkeypatch.setattr(tops, "_KERNEL_MODE", None)
    monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
    assert tops.default_kernel_mode(torch.device("cpu")) == "ref"
    assert tops.default_kernel_mode(torch.device("cuda")) == "kernel"
    for bad in ("interpret", "pallas"):
        monkeypatch.setattr(tops, "_KERNEL_MODE", None)
        monkeypatch.setenv("REPRO_KERNEL_MODE", bad)
        with pytest.raises(ValueError, match=r"'auto', 'ref', 'kernel'"):
            tops.default_kernel_mode()
        with pytest.raises(ValueError, match=r"'auto', 'ref', 'kernel'"):
            tops.matmul(torch.ones(2, 2), torch.ones(2, 2), mode=bad)
    monkeypatch.setattr(tops, "_KERNEL_MODE", None)
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    assert tops.default_kernel_mode(torch.device("cuda")) == "ref"  # read once, wins
    monkeypatch.setenv("REPRO_KERNEL_MODE", "kernel")
    assert tops.default_kernel_mode(torch.device("cuda")) == "ref"  # not read again


@pytest.mark.parametrize("name", ["matmul", "gemv", "flash_attention", "decode_attention", "ssd"])
def test_kernel_mode_on_cpu_tensors_raises(name):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _entry_calls("kernel")[name]()


def test_paged_entry_points_resolve_through_the_attention_registry(monkeypatch):
    monkeypatch.setattr(tops, "_ATTN_BACKEND", None)
    monkeypatch.delenv("REPRO_ATTENTION_BACKEND", raising=False)
    q, kp, vp, tbl, lens, owned, _ = _pool_case(50, 1)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    own = torch.from_numpy(owned)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.paged_attention(*args, mode="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.paged_attention_partials(*args, own, mode="kernel")
    for mode in ("auto", "ref", "reference"):  # auto on the CPU is the reference
        with pytest.raises(ValueError, match="kernel-backend surface"):
            tops.paged_attention_partials(*args, own, mode=mode)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn.paged_flash_partials(*args, own, backend="kernel")
    with pytest.raises(ValueError, match=r"auto.*reference.*kernel"):
        tops.paged_attention(*args, mode="interpret")


def test_cpu_entry_points_build_and_launch_nothing(monkeypatch):
    monkeypatch.setattr(tops, "_KERNEL_MODE", None)
    monkeypatch.delenv("REPRO_KERNEL_MODE", raising=False)
    counters = [(rm.relic_matmul, "launches"), (rm.relic_gemv, "launches"),
                (da.decode_attention, "launches"), (fa.flash_attention, "launches"),
                (fa.flash_attention, "launches_noncausal"), (ssd.ssd_scan, "launches"),
                (pda.paged_decode_attention, "launches_partials")]
    for fn, attr in counters:
        monkeypatch.setattr(fn, attr, 0)
    for call in _entry_calls("auto").values():
        call()
    q, kp, vp, tbl, lens, owned, _ = _pool_case(60, 2)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)]
    pda.paged_decode_attention(*args, owned=torch.from_numpy(owned), partials=True)
    tattn.paged_flash_partials(*args, torch.from_numpy(owned))
    assert all(getattr(fn, attr) == 0 for fn, attr in counters)
    assert _build._lib is None


@pytest.mark.parametrize("B,K,N,splits", [
    (8, 576, 1536, 9),      # 12 panels: K split 9 ways (64 rows each)
    (1, 576, 49152, 1),     # 384 panels fill the card
    (8, 2560, 10240, 4),    # 80 panels
    (8, 10240, 2560, 14),   # 20 panels
    (2, 32, 64, 1),         # K too short to split
])
def test_gemv_split_plan(B, K, N, splits):
    assert rm.gemv_splits(K, N) == splits


@pytest.mark.parametrize("B,KV,Smax,splits", [
    (8, 3, 2048, 11),       # smollm's slot cache: 24 pairs, 32 tiles → 3 tiles a split
    (8, 32, 2048, 2),       # zamba2: 256 pairs
    (64, 8, 2048, 1),
    (1, 1, 60, 1),          # one tile
])
def test_decode_split_plan(B, KV, Smax, splits):
    got = da.decode_splits(B, KV, Smax)
    assert got == splits
    tiles = -(-Smax // da.DECODE_TILE)
    per = -(-tiles // got)
    assert per * got >= tiles and per * (got - 1) < tiles  # every split has a tile



# the launch plan of relic_matmul on the card, at chip_smoke.py's phase-4
# shapes: bf16 on TMA-fed wgmma (128-column tiles once they fill the 132
# SMs, 64-column ones below that), float32 on the CUDA cores
@pytest.mark.parametrize("M,K,N,path,tile,grid", [
    (1024, 576, 1536, "wgmma", (128, 64, 64), (8, 24)),       # smollm: 96 tiles of 128 x 128
    (1000, 576, 1536, "wgmma", (128, 64, 64), (8, 24)),       # a ragged M
    (1024, 2560, 10240, "wgmma", (128, 128, 64), (8, 80)),    # zamba2: 640 tiles
    (8, 576, 1536, "wgmma", (128, 64, 64), (1, 24)),
])
def test_matmul_plan_bf16(M, K, N, path, tile, grid):
    plan = rm.matmul_plan(torch.bfloat16, M, K, N)
    assert (plan["path"], plan["tile"], plan["grid"]) == (path, tile, grid)
    # x arrives as [128 rows x 64 K] boxes, w as [64 K x 64 N] boxes, one
    # per 64 columns of the tile, into a 4-stage ring
    assert plan["x_box"] == (64, 128) and plan["w_box"] == (64, 64)
    assert plan["w_boxes"] == tile[1] // 64 and plan["stages"] == 4


@pytest.mark.parametrize("M,K,N,grid", [
    (1024, 576, 1536, (12, 8)), (1000, 576, 1536, (12, 8)), (1024, 2560, 10240, (80, 8)),
])
def test_matmul_plan_float32_stays_on_cuda_cores(M, K, N, grid):
    assert rm.matmul_plan(torch.float32, M, K, N) == {
        "path": "cuda_cores", "tile": (128, 128, 16), "grid": grid}


@pytest.mark.parametrize("K,N", [(572, 1536), (576, 1532), (20, 8), (8, 12)])
def test_matmul_plan_refuses_bf16_strides_tma_cannot_take(K, N):
    with pytest.raises(ValueError, match="multiples of 8"):
        rm.matmul_plan(torch.bfloat16, 1024, K, N)
    assert rm.matmul_plan(torch.float32, 1024, K, N)["path"] == "cuda_cores"  # float32 takes any
