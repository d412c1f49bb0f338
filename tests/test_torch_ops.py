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
import math

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
    (1, 128, 8, 2, 128, 64, 64),   # hd 128, g=4 (phi3-medium-14b's group)
    (1, 128, 12, 2, 128, 64, 64),  # hd 128, g=6 (internlm2-20b's group)
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
    (8, 576, 1536, 6),      # 6 panels of 256 bf16 columns: K split 6 ways (96 rows each)
    (1, 576, 49152, 1),     # 192 panels fill the card
    (8, 2560, 10240, 3),    # 40 panels: 120 blocks, one an SM (4 would load 28 SMs twice)
    (8, 10240, 2560, 8),    # 10 panels
    (2, 32, 64, 1),         # K too short to split
])
def test_gemv_split_plan(B, K, N, splits):
    """The GEMV kernel's plan: K split 1-8 ways (one cluster), each split
    keeping 64 rows, for the most blocks per resident wave (at most two
    blocks an SM), the fewest splits on a tie; each split takes a whole
    number of stages (32 rows) and together they cover K, none empty."""
    plan = rm.gemv_plan(torch.bfloat16, B, K, N)
    assert plan["splits"] == splits and plan["cluster"] == (1, splits, 1)
    assert plan["path"] == "tma" and plan["panel"] == 256 and plan["stage_rows"] == 32
    assert plan["grid"] == (-(-N // 256), splits, 1) and plan["rows"] == min(8, 1 << (B - 1).bit_length())
    kps = plan["k_per_split"]
    assert kps % plan["stage_rows"] == 0 and kps * splits >= K and kps * (splits - 1) < K
    f32 = rm.gemv_plan(torch.float32, B, K, N)  # 128-column panels: 512-byte rows too
    assert f32["panel"] == 128 and f32["grid"][0] == -(-N // 128)


@pytest.mark.parametrize("B,KV,Smax,splits", [
    (8, 3, 2048, 8),        # smollm's slot cache: 24 (row, head) pairs, 32 tiles → 4 a split
    (8, 32, 2048, 4),       # zamba2: 256 pairs; 8 tiles a split at most
    (64, 8, 2048, 4),
    (1, 1, 60, 1),          # one tile
])
def test_decode_split_plan(B, KV, Smax, splits):
    """The decode kernel's plan: splits (one cluster, at most 8, at most
    one per tile) double until the grid reaches two blocks an SM and a
    full row gives no split more than 8 tiles; every split of a full row
    has a tile."""
    g = 3 if KV == 3 else 1  # smollm's groups of 3 heads, else one head a kv head
    plan = da.decode_plan(torch.bfloat16, B, KV * g, KV, Smax, 64)
    got = plan["splits"]
    assert got == splits and plan["cluster"] == (1, 1, got)
    assert plan["grid"] == (B, KV, got) and plan["rows"] == (4 if g == 3 else 1)
    tiles = -(-Smax // plan["tile"])
    per = -(-tiles // got)  # the kernel deals a row's live tiles out equally
    assert per * (got - 1) < tiles  # every split of a full row has a tile
    assert per <= da.DECODE_TILES_PER_SPLIT or got == da.DECODE_MAX_SPLITS


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


# the launch plan of flash_attention at the dense configs' serving prefill
# (B = 1, S = 1024) and phase 11's non-causal shape: bf16 at hd 128 runs on
# TMA-fed wgmma, Q, K and V each as two 64-column boxes of 64 rows
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 1024, 40, 10, 128),   # phi3-medium-14b
    (1, 1024, 48, 8, 128),    # internlm2-20b
    (2, 512, 40, 10, 128),    # phi3's heads, non-causal
    (1, 1024, 32, 32, 80),    # stablelm-3b: a 64- and a 16-column box
])
def test_flash_plan_dense_configs(B, S, H, KV, hd):
    plan = fa.flash_plan(torch.bfloat16, B, S, H, KV, hd)
    assert plan["path"] == "wgmma" and plan["threads"] == 160 and plan["stages"] == 2
    assert plan["boxes"] == [(64, 1, 64, 1), (hd - 64, 1, 64, 1)]
    assert plan["grid"] == (-(-S // 64) * H * B,)
    # float32 stays on the CUDA cores: the g query heads of a kv head ride
    # together, 16 positions each
    assert fa.flash_plan(torch.float32, B, S, H, KV, hd) == {
        "path": "cuda_cores", "rows": 16 * (H // KV), "keys": 32, "threads": 128,
        "grid": (-(-S // 16), B * KV)}


@pytest.mark.parametrize("M,K,N,grid", [
    (1024, 576, 1536, (12, 8)), (1000, 576, 1536, (12, 8)), (1024, 2560, 10240, (80, 8)),
])
def test_matmul_plan_float32_stays_on_cuda_cores(M, K, N, grid):
    assert rm.matmul_plan(torch.float32, M, K, N) == {
        "path": "cuda_cores", "tile": (128, 128, 16), "grid": grid}


@pytest.mark.parametrize("K,N", [(572, 1536), (576, 1532), (20, 8), (8, 12)])
def test_matmul_plan_refuses_bf16_strides_tma_cannot_take(K, N):
    """TMA cannot take bf16 rows whose stride is not a multiple of 16
    bytes: those products go to the CUDA-core kernel, as float32 does."""
    assert rm.matmul_plan(torch.bfloat16, 1024, K, N) == rm.matmul_plan(torch.float32, 1024, K, N)
    assert rm.matmul_plan(torch.bfloat16, 1024, K, N)["path"] == "cuda_cores"
    assert rm.matmul_plan(torch.float32, 1024, K, N)["path"] == "cuda_cores"  # float32 takes any


def test_matmul_plan_takes_what_the_jax_function_takes():
    """M = K = N = 100 meets the JAX block contract (each block cut to its
    dimension) and runs on the CUDA cores in bf16."""
    assert rm.matmul_plan(torch.bfloat16, 100, 100, 100) == {
        "path": "cuda_cores", "tile": (128, 128, 16), "grid": (1, 1)}
    x, w = torch.randn(100, 100), torch.randn(100, 100)
    assert rm.relic_matmul(x.bfloat16(), w.bfloat16()).shape == (100, 100)  # the contract holds


def test_matmul_plan_routes_misaligned_bf16_to_cuda_cores():
    """A bf16 view 2 bytes past a 16-byte boundary cannot be a TMA source:
    the wrapper's alignment check sends it to the CUDA cores."""
    buf = torch.zeros(1024 * 576 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(1024, 576)
    w = torch.zeros(576, 1536, dtype=torch.bfloat16)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert not _build.aligned16(x, w) and _build.aligned16(w)
    assert rm.matmul_plan(torch.bfloat16, 1024, 576, 1536, _build.aligned16(x, w))["path"] == "cuda_cores"
    assert rm.matmul_plan(torch.bfloat16, 1024, 576, 1536, _build.aligned16(w))["path"] == "wgmma"
    assert rm.gemv_plan(torch.bfloat16, 8, 576, 1536, _build.aligned16(x[:8]))["path"] == "direct"


@pytest.mark.parametrize("B,K,N,path", [
    (8, 576, 1536, "tma"), (3, 100, 100, "direct"), (8, 96, 36, "direct"), (1, 64, 8, "tma"),
])
def test_gemv_plan_path_follows_tma_strides(B, K, N, path):
    """bf16 w reaches the ring by TMA when its rows are 16-byte multiples
    (N % 8 == 0), else the consumers load it; float32 needs N % 4 == 0."""
    assert rm.gemv_plan(torch.bfloat16, B, K, N)["path"] == path
    assert rm.gemv_plan(torch.float32, B, K, N)["path"] == ("tma" if N % 4 == 0 else "direct")


# ---------------------------------------------------------------------------
# the new kernels' reduction orders, replayed in plain PyTorch (test-local
# copies of the arithmetic of csrc/relic_matmul.cu's gemv_kernel and
# csrc/decode_attention.cu's decode_kernel) and held against the JAX
# functions in interpret mode


def _fma32(a, b, c):
    """float32 fmaf: the product and sum taken exactly (in float64), then
    rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _gemv_replay(x, w, plan):
    """The GEMV kernel's sums: per split, consumer warp v (of 8) takes the
    rows k of the split with (k - start) % 8 == v in increasing order, an
    fmaf a row, into float32 accumulators; the block adds its warps in warp
    order; rank 0 of the cluster adds the splits in split order from 0,
    and the sum is rounded once to x's type."""
    B, K = x.shape
    xf, wf = x.float(), w.float()
    kps = plan["k_per_split"]
    total = torch.zeros(B, w.shape[1])
    for s in range(plan["splits"]):
        kb, ke = s * kps, min(K, (s + 1) * kps)
        block = None
        for v in range(8):
            acc = torch.zeros(B, w.shape[1])
            for k in range(kb + v, ke, 8):
                acc = _fma32(xf[:, k, None], wf[None, k, :], acc)
            block = acc if block is None else block + acc
        total = total + block
    return total.to(x.dtype)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("k,n", [(512, 100), (768, 300), (64, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemv_reduction_order_matches_pallas(b, k, n, dtype):
    """The replay at the kernel's own plan (K = 512 and 768 split 8 ways
    into 64- and 96-row runs; K = 64 one split; N ragged against the
    256- and 128-column panels) against ``ops.gemv`` in interpret mode, w
    at a projection's scale (N(0, 1/K)) so outputs are of order 1.
    Tolerances as the matmul tests': float32 atol 2e-5, rtol 1e-5 (float32
    sums in another order); bf16 2e-2 (one rounding to bf16 each side)."""
    rng = np.random.default_rng(b * k + n)
    (tx, jx), (tw, jw) = (_both((rng.normal(size=s) * scale).astype(np.float32), dtype)
                          for s, scale in (((b, k), 1.0), ((k, n), k**-0.5)))
    plan = rm.gemv_plan(tx.dtype, b, k, n)
    assert plan["splits"] == (8 if k >= 512 else 1)
    got = _gemv_replay(tx, tw, plan)
    want = _np(jops.gemv(jx, jw, bk=64, bn=n, mode="interpret"))
    atol, rtol = (ATOL, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(got), _np(rm.relic_gemv(tx, tw, bk=64, bn=n)), atol=atol, rtol=rtol)


def _decode_replay(q, k, v, cache_len, plan):
    """The decode kernel's arithmetic: per (row, kv head, split), its run
    of the row's live 64-key tiles (below cache_len, dealt out to the
    splits in equal contiguous runs); per tile the float32 scores (each
    key's dot product as two halves of the head's 16-byte chunks, added),
    the running max m and rescale exp(m_old - m_new), weights p = exp(s -
    m) in float32; P.V and the sum l kept per key group (key j of a tile in
    group j % groups, groups = 128 // chunks) and rescaled at each tile;
    the block adds its groups in group order; the splits combine in split
    order, each scaled by exp(m_split - m), or by 0 where m_split is the
    -1e30 sentinel, and acc / max(l, 1e-30) is rounded once."""
    B, H, hd = q.shape
    Smax, KV = k.shape[1], k.shape[2]
    g = H // KV
    es = q.element_size()
    chunks = -(-hd * es // 16)
    vec = 16 // es
    mid = -(-chunks // 2) * vec  # the first half's columns
    groups = max(1, 128 // chunks)  # a wide head (chunks > 128): one key group
    tile = plan["tile"]
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n_len = int(min(max(int(cache_len[b]), 0), Smax))
        tps = -(-(-(-n_len // tile)) // plan["splits"])  # live tiles, dealt out equally
        for kv in range(KV):
            qh = qf[b, kv * g:(kv + 1) * g]  # [g, hd]
            parts = []
            for s in range(plan["splits"]):
                j0, j1 = s * tps * tile, min(n_len, (s + 1) * tps * tile)
                m = torch.full((g,), float(NEG))
                acc = torch.zeros(groups, g, hd)
                l = torch.zeros(groups, g)
                for t0 in range(j0, j1, tile):
                    keys = kf[b, t0:min(t0 + tile, j1), kv]
                    vals = vf[b, t0:min(t0 + tile, j1), kv]
                    sc = (qh[:, :mid] @ keys[:, :mid].T + qh[:, mid:] @ keys[:, mid:].T) / hd**0.5
                    m_new = torch.maximum(m, sc.amax(1))
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])  # [g, n]
                    grp = torch.arange(len(keys)) % groups
                    acc = acc * corr[None, :, None]
                    l = l * corr[None]
                    for gi in range(min(groups, len(keys))):
                        sel = grp == gi
                        acc[gi] += p[:, sel] @ vals[sel]
                        l[gi] += p[:, sel].sum(1)
                    m = m_new
                a_blk, l_blk = acc[0].clone(), l[0].clone()
                for gi in range(1, groups):
                    a_blk, l_blk = a_blk + acc[gi], l_blk + l[gi]
                parts.append((m, l_blk, a_blk))
            m_all = torch.stack([pm for pm, _, _ in parts]).amax(0)
            l_all, a_all = torch.zeros(g), torch.zeros(g, hd)
            for pm, pl, pa in parts:
                wgt = torch.where(pm <= NEG, 0.0, torch.exp(pm - m_all))
                l_all = l_all + pl * wgt
                a_all = a_all + pa * wgt[:, None]
            out[b, kv * g:(kv + 1) * g] = a_all / torch.clamp(l_all, min=1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("b,h,kv,hd,smax", [
    (4, 8, 2, 32, 512),      # g = 4: 8 splits of one tile
    (4, 3, 1, 64, 1024),     # g = 3: 8 splits of two tiles
    (4, 4, 4, 40, 512),      # g = 1, a head of 80 bytes in bf16 (5 chunks)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reduction_order_matches_pallas(b, h, kv, hd, smax, dtype):
    """The replay at the kernel's own plan against ``ops.decode_attention``
    in interpret mode, with cache_len 0, 1, Smax and one random length:
    float32 within 2e-5 (a float32 softmax on both sides, summed in
    another order), bf16 within 2e-2 (one rounding of the output to bf16
    on each side, and the Pallas kernel rounds P to bf16 before P.V, 2^-9
    relative); the cache_len 0 row is exactly zero."""
    rng = np.random.default_rng(smax + h + hd)
    clen = np.array([0, 1, smax, rng.integers(2, smax)], np.int32)[:b]
    (tq, jq), (tk, jk), (tv, jv) = (
        _both(rng.normal(size=sh).astype(np.float32), dtype)
        for sh in ((b, h, hd), (b, smax, kv, hd), (b, smax, kv, hd))
    )
    tl, jl = _both(clen)
    plan = da.decode_plan(tq.dtype, b, h, kv, smax, hd)
    assert plan["splits"] == 8
    got = _decode_replay(tq, tk, tv, tl, plan)
    want = _np(jops.decode_attention(jq, jk, jv, jl, bk=64, mode="interpret"))
    tol = ATOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(da.decode_attention(tq, tk, tv, tl, bk=64)),
                               atol=tol, rtol=tol)
    assert not got[0].any()  # the cache_len 0 row


@pytest.mark.parametrize("hd", [64, 80, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(9, 3), (32, 32), (16, 2)])
def test_decode_plan_layout_fits_the_card(hd, dtype, H, KV):
    """The decode kernel's shared memory (the plan's mirror of its
    ``ring_layout``) stays within the H100's 227 KB opt-in at every head
    size up to 512; hd 64 and 80 keep their plan of 64-key tiles in 2-4
    stages within ~112 KB, wider heads take 32- or 16-key tiles."""
    es = 4 if dtype == torch.float32 else 2
    plan = da.decode_plan(dtype, 8, H, KV, 2048, hd)
    assert plan["smem"] <= da.SMEM_OPT_IN == 232_448
    assert plan["smem"] == da.decode_layout(hd, es, plan["rows"], plan["stages"], plan["tile"])
    if hd in (64, 80):
        stage = 2 * 64 * (-(-hd * es // 16) * 16 + 16)
        assert (plan["tile"], plan["stages"]) == (64, max(2, min(4, (112 * 1024) // stage)))
    assert plan["tile"] in (64, 32, 16) and 1 <= plan["stages"] <= 4
    # the tile shrinks only where 64 keys in two stages do not fit
    if plan["tile"] < 64:
        assert da.decode_layout(hd, es, plan["rows"], 2, 2 * plan["tile"]) > da.SMEM_OPT_IN


def test_decode_plan_names_the_largest_head_it_takes():
    """Wide heads (more 16-byte chunks than the block's 128 threads) run:
    the plan raises only where no layout fits the opt-in, naming the
    largest hd that does, for the block's rows and element size."""
    assert da.decode_plan(torch.float32, 1, 1, 1, 64, 512)["tile"] == 16
    assert da.decode_plan(torch.bfloat16, 1, 1, 1, 64, 1024)["tile"] == 16
    wide = da.decode_plan(torch.float32, 8, 9, 3, 2048, 1024)
    assert wide["smem"] <= da.SMEM_OPT_IN and wide["tile"] == 16
    top = da.max_head_dim(4, 1)
    assert top > 1024 and da.decode_plan(torch.float32, 1, 1, 1, 64, top)["smem"] <= da.SMEM_OPT_IN
    with pytest.raises(ValueError, match=f"hd up to {top}"):
        da.decode_plan(torch.float32, 1, 1, 1, 64, top + 1)
    for kv, es, hd in ((torch.float32, 4, 1024), (torch.bfloat16, 2, 1024), (torch.int8, 1, 2560)):
        plan = pda.paged_plan(torch.bfloat16 if es == 2 else torch.float32, kv, 8, 1, 9, 3, hd,
                              16, 128)
        assert plan["smem"] <= da.SMEM_OPT_IN


# ---------------------------------------------------------------------------
# the paged kernel's reduction order, replayed in plain PyTorch (a test-local
# copy of the arithmetic of csrc/paged_decode_attention.cu's paged_kernel)


def _pairwise(parts):
    """The shuffle tree of the kernel's xor butterfly: ((s0 + s1) + (s2 + s3)) ..."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _paged_replay(q, kp, vp, tables, lengths, plan, k_scale=None, v_scale=None, owned=None,
                  partials=False):
    """The paged kernel's arithmetic, one query row at a time (so nothing a
    row computes depends on T): the row's table cut into the plan's tiles,
    tile i to split i mod splits; per tile, keys whose entry is unowned or
    past the tile's loaded run (positions below lengths + T) or the row's
    window score -1e30; each score is the sum of 128 / tile partial dot
    products over runs of the head's 16-byte chunks, added as the xor
    shuffles add them; the running max, rescale exp(m_old - m_new) and
    weights exp(s - m_new) in float32; P.V and l per key group (key j in
    group j % groups, groups = 128 // chunks), a masked key adding exactly
    nothing; the block adds its groups in group order; the splits combine
    in split order, each scaled by exp(m_split - m) or by 0 at the -1e30
    sentinel; then acc / max(l, 1e-30), or (m, l, acc) in partials mode.
    Int8 pools dequantize as float(int8) * (float(scale) / 127)."""
    B, T, H, hd = q.shape
    NB, BS, KV, _ = kp.shape
    MB = tables.shape[1]
    g = H // KV
    int8 = kp.dtype == torch.int8
    es = 1 if int8 else kp.element_size()
    chunks = -(-hd * es // 16)
    hdp, groups = chunks * (16 // es), max(1, 128 // chunks)  # a wide head: one group
    tc, splits = plan["tile"], plan["splits"]
    epr, spe = plan["entries_per_tile"], plan["slices_per_entry"]
    tpk = 128 // tc
    c_per = -(-chunks // tpk) * (16 // es)  # columns a scoring thread takes
    kf, vf = kp.float(), vp.float()
    if int8:
        kf = kf * (k_scale.float() / 127)[..., None]
        vf = vf * (v_scale.float() / 127)[..., None]

    def start(i):
        return i * epr * BS if spe == 1 else (i // spe) * BS + (i % spe) * tc

    def keys(i):
        return min(epr, MB - i * epr) * BS if spe == 1 else min(tc, BS - (i % spe) * tc)

    def entry_slot(i, j):
        return (i * epr + j // BS, j % BS) if spe == 1 else (i // spe, (i % spe) * tc + j)

    reach, scale = MB * BS, torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    n_tiles = plan["n_tiles"]
    out = torch.zeros(B, T, H, hd)
    m_out, l_out = torch.zeros(B, T, H), torch.zeros(B, T, H)
    for b in range(B):
        lim_max = max(0, min(reach, int(lengths[b]) + T))
        live = sum(1 for i in range(n_tiles) if start(i) < lim_max)
        for kv in range(KV):
            tiles = []  # (p0, n, keys [tc, hdp], vals [tc, hdp], owned [tc]) of each live tile
            for i in range(live):
                p0 = start(i)
                n = min(keys(i), lim_max - p0)
                kt, vt, ok = torch.zeros(tc, hdp), torch.zeros(tc, hdp), torch.zeros(tc, dtype=torch.bool)
                for j in range(n):
                    e, sl = entry_slot(i, j)
                    if owned is None or int(owned[b, e]):
                        kt[j, :hd] = kf[int(tables[b, e]), sl, kv]
                        vt[j, :hd] = vf[int(tables[b, e]), sl, kv]
                        ok[j] = True
                tiles.append((p0, n, kt, vt, ok))
            for r in range(T * g):
                t, jh = divmod(r, g)
                lim = max(0, min(reach, int(lengths[b]) + t + 1))
                qv = torch.zeros(hdp)
                qv[:hd] = q[b, t, kv * g + jh].float()
                parts = []
                for s in range(splits):
                    m = torch.tensor(float(NEG))
                    l, acc = torch.zeros(groups), torch.zeros(groups, hdp)
                    for p0, n, kt, vt, ok in tiles[s::splits]:
                        sub = [(kt[:, c:c + c_per] * qv[c:c + c_per]).sum(1) for c in range(0, tpk * c_per, c_per)]
                        pos = p0 + torch.arange(tc)
                        valid = ok & (torch.arange(tc) < n) & (pos < lim)
                        sc = torch.where(valid, _pairwise(sub) * scale, torch.tensor(float(NEG)))
                        m_new = torch.maximum(m, sc.max())
                        corr = torch.exp(m - m_new)
                        p = torch.where(valid, torch.exp(sc - m_new), torch.tensor(0.0))
                        l, acc = l * corr, acc * corr
                        for step in range(-(-tc // groups)):
                            jj = torch.arange(groups) + step * groups
                            live_j = jj < n
                            jc = jj.clamp(max=tc - 1)
                            l = torch.where(live_j, l + p[jc], l)
                            acc = torch.where(live_j[:, None], acc + p[jc, None] * vt[jc], acc)
                        m = m_new
                    a_blk, l_blk = acc[0].clone(), l[0].clone()
                    for gi in range(1, groups):
                        a_blk, l_blk = a_blk + acc[gi], l_blk + l[gi]
                    parts.append((m, l_blk, a_blk))
                m_all = torch.stack([pm for pm, _, _ in parts]).max()
                l_all, a_all = torch.tensor(0.0), torch.zeros(hdp)
                for pm, pl, pa in parts:
                    wgt = torch.tensor(0.0) if pm <= NEG else torch.exp(pm - m_all)
                    l_all, a_all = l_all + pl * wgt, a_all + pa * wgt
                h = kv * g + jh
                m_out[b, t, h], l_out[b, t, h] = m_all, l_all
                out[b, t, h] = a_all[:hd] if partials else a_all[:hd] / torch.clamp(l_all, min=1e-30)
    if partials:
        return m_out, l_out, out
    return out.to(q.dtype)


def _replay_pool(seed, t, layout, int8=False):
    """Four rows of a pool whose tables reach 256 keys (4 tiles of 64, dealt
    to 4 splits): BS = 8, MB = 32 (8 entries a tile), or the slot view's
    BS = 128, MB = 2 (2 slices an entry); lengths 0, a tile boundary less
    one, mid-tile, and the table's reach less T; a random ownership in
    which row 1 owns nothing."""
    B, KV, g, hd = 4, 2, 2, 16
    BS, MB = (8, 32) if layout == "paged" else (128, 2)
    NB = B * MB + 1
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, t, KV * g, hd)).astype(np.float32)
    if int8:
        kp, vp = (rng.integers(-127, 128, size=(NB, BS, KV, hd)).astype(np.int8) for _ in range(2))
        scales = [rng.uniform(0.5, 2.0, size=(NB, BS, KV)).astype(np.float32) for _ in range(2)]
    else:
        kp, vp = (rng.normal(size=(NB, BS, KV, hd)).astype(np.float32) for _ in range(2))
        scales = None
    tbl = rng.permutation(NB - 1)[: B * MB].reshape(B, MB).astype(np.int32)
    lens = np.array([0, 63, 150, MB * BS - t], np.int32)
    for r in range(B):
        tbl[r, -(-(lens[r] + t) // BS):] = NB - 1  # entries past the window: the null block
    owned = rng.integers(0, 2, size=(B, MB)).astype(np.int32)
    owned[1] = 0
    return q, kp, vp, tbl, lens, owned, scales


@pytest.mark.parametrize("mode", ["float", "int8", "partials"])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_paged_reduction_order_matches_pallas(layout, t, mode):
    """The replay at the kernel's own plan (4 splits of one 64-key tile
    each: 8 entries of 8 keys, or 64-key slices of 128-key entries)
    against ``ops.paged_attention`` (and, in partials mode,
    ``paged_flash_partials``) in interpret mode, float32 q: within 2e-5
    (a float32 softmax on both sides, summed in another order; the int8
    pools dequantize identically); the row that owns nothing is exactly
    (-1e30, 0, 0). The replay's verify (T = 4) equals its decode (T = 1,
    lengths + t) bitwise, query by query."""
    q, kp, vp, tbl, lens, owned, scales = _replay_pool(50 + t, t, layout, mode == "int8")
    t_args, j_args = _to_both(q, kp, vp, tbl, lens, scales)
    B, T, H, hd = q.shape
    plan = pda.paged_plan(torch.float32, t_args[1].dtype, B, T, H, kp.shape[2], hd, kp.shape[1],
                          tbl.shape[1])
    assert plan["splits"] == 4 and plan["n_tiles"] == 4 and plan["tile"] == 64
    kw = dict(k_scale=t_args[5], v_scale=t_args[6])
    if mode == "partials":
        t_own = torch.from_numpy(owned)
        got = _paged_replay(*t_args[:5], plan, owned=t_own, partials=True, **kw)
        want = [np.asarray(a) for a in jattn.paged_flash_partials(
            *j_args[:5], jnp.asarray(owned), k_scale=j_args[5], v_scale=j_args[6],
            backend="interpret")]
        for name, g_, w_ in zip("mla", got, want):
            np.testing.assert_allclose(g_.numpy(), w_, atol=ATOL, rtol=ATOL, err_msg=name)
        m, l, acc = got
        assert (m[1] == NEG).all() and not l[1].any() and not acc[1].any()
    else:
        t_own = None
        got = _paged_replay(*t_args[:5], plan, **kw)
        want = np.asarray(jops.paged_attention(*j_args, mode="interpret"))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    if T > 1:
        for ti in range(T):
            dec = _paged_replay(t_args[0][:, ti:ti + 1].contiguous(), *t_args[1:4],
                                t_args[4] + ti, plan, owned=t_own, partials=mode == "partials", **kw)
            if mode == "partials":
                for a_, b_ in zip(dec, got):
                    assert torch.equal(a_[:, 0], b_[:, ti])
            else:
                assert torch.equal(dec[:, 0], got[:, ti])


# the paged kernel's launch plan at the card's shapes: the splits, the tile
# and the ring depend on the pool's shape, never on T
@pytest.mark.parametrize("kv_dtype,B,H,KV,hd,BS,MB,splits,tile,epr,spe,path", [
    (torch.bfloat16, 8, 9, 3, 64, 16, 128, 8, 64, 4, 1, "cp.async"),    # smollm's paged pool
    (torch.bfloat16, 8, 9, 3, 64, 256, 8, 8, 64, 1, 4, "cp.async"),     # smollm's slot view
    (torch.int8, 8, 32, 32, 80, 256, 8, 4, 64, 1, 4, "cp.async"),       # zamba2's int8 slot view
    (torch.int8, 8, 9, 3, 72, 16, 128, 8, 64, 4, 1, "direct"),          # int8 hd 72: element loads
])
def test_paged_plan(kv_dtype, B, H, KV, hd, BS, MB, splits, tile, epr, spe, path):
    plans = [pda.paged_plan(torch.bfloat16, kv_dtype, B, T, H, KV, hd, BS, MB) for T in (1, 4)]
    for T, plan in zip((1, 4), plans):
        assert (plan["splits"], plan["tile"], plan["entries_per_tile"], plan["slices_per_entry"],
                plan["path"]) == (splits, tile, epr, spe, path)
        assert plan["cluster"] == (1, 1, splits) and plan["grid"][2] == splits
        rows = T * (H // KV)
        assert plan["grid"][:2] == (B, KV * -(-rows // plan["rows"]))
        assert plan["smem"] <= da.SMEM_OPT_IN
        assert plan["n_tiles"] * min(tile, BS * epr) >= BS * MB  # the tiles cover the table
    assert {k: plans[0][k] for k in ("splits", "tile", "stages")} == \
        {k: plans[1][k] for k in ("splits", "tile", "stages")}
    assert not pda.paged_plan(torch.bfloat16, kv_dtype, B, 1, H, KV, hd, BS, MB, False)["path"] == "cp.async"


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_wide_head_paged_replay_matches_pallas(mode):
    """A head wider than the block's 128 16-byte chunks (float32 hd 544:
    136 chunks; int8 hd 2064: 129) runs P.V over its chunks in a loop, one
    key group (``pv_wide``): the replay at the kernel's plan against
    ``ops.paged_attention`` in interpret mode within 2e-5 (float32 q), and
    its verify (T = 2) equals its decode bitwise, query by query."""
    B, T, KV, g, BS, MB = 2, 2, 1, 2, 8, 4
    hd = 544 if mode == "float" else 2064
    NB = B * MB + 1
    rng = np.random.default_rng(hd)
    q = rng.normal(size=(B, T, KV * g, hd)).astype(np.float32)
    if mode == "int8":
        kp, vp = (rng.integers(-127, 128, size=(NB, BS, KV, hd)).astype(np.int8) for _ in range(2))
        scales = [rng.uniform(0.5, 2.0, size=(NB, BS, KV)).astype(np.float32) for _ in range(2)]
    else:
        kp, vp = (rng.normal(size=(NB, BS, KV, hd)).astype(np.float32) for _ in range(2))
        scales = None
    tbl = rng.permutation(NB - 1)[: B * MB].reshape(B, MB).astype(np.int32)
    lens = np.array([5, MB * BS - T], np.int32)
    t_args, j_args = _to_both(q, kp, vp, tbl, lens, scales)
    plan = pda.paged_plan(torch.float32, t_args[1].dtype, B, T, KV * g, KV, hd, BS, MB)
    assert -(-hd * (1 if mode == "int8" else 4) // 16) > 128 and plan["smem"] <= da.SMEM_OPT_IN
    kw = dict(k_scale=t_args[5], v_scale=t_args[6])
    got = _paged_replay(*t_args[:5], plan, **kw)
    want = np.asarray(jops.paged_attention(*j_args, mode="interpret"))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        pda.paged_decode_attention(*t_args).numpy(), want, atol=ATOL, rtol=ATOL)
    for ti in range(T):
        dec = _paged_replay(t_args[0][:, ti:ti + 1].contiguous(), *t_args[1:4], t_args[4] + ti,
                            plan, **kw)
        assert torch.equal(dec[:, 0], got[:, ti])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_head_decode_replay_matches_pallas(dtype):
    """The dense decode kernel at a head wider than 128 chunks (hd 544 in
    float32, 1040 in bf16): the replay at its plan against
    ``ops.decode_attention`` in interpret mode, float32 within 2e-5, bf16
    within 2e-2 (as ``test_decode_reduction_order_matches_pallas``)."""
    b, h, kv, smax = 2, 2, 1, 128
    hd = 544 if dtype == "float32" else 1040
    rng = np.random.default_rng(hd)
    (tq, jq), (tk, jk), (tv, jv) = (
        _both(rng.normal(size=sh).astype(np.float32), dtype)
        for sh in ((b, h, hd), (b, smax, kv, hd), (b, smax, kv, hd))
    )
    tl, jl = _both(np.array([smax, 37], np.int32))
    plan = da.decode_plan(tq.dtype, b, h, kv, smax, hd)
    assert -(-hd * tq.element_size() // 16) > 128 and plan["smem"] <= da.SMEM_OPT_IN
    got = _decode_replay(tq, tk, tv, tl, plan)
    want = _np(jops.decode_attention(jq, jk, jv, jl, bk=64, mode="interpret"))
    tol = ATOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the SSD kernel's chunk-parallel order, replayed in plain PyTorch (a
# test-local copy of the arithmetic of csrc/ssd_scan.cu's ssd_scan_kernel)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernel's rounding of a float32 tensor-core operand."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _ssd_replay(xh, a, b, c, dt, plan):
    """The SSD kernel's order: per (row, head), the chunks dealt to the
    plan's cluster of ranks in contiguous runs; each rank's local state,
    the recurrence from zero over its run, S = exp(la_end) S + sum_j (b_j
    w_j) (x) x_j, and its decay exp(sum of la_end); S_in of rank k the fold
    of ranks 0 .. k-1 in rank order, S = D_r S + local_r, the fold past the
    last rank the final state; then y of each chunk from the state
    entering it: exp(la_i) (c_i . S), then att x added on top. With the
    plan's tensor cores (bf16) the float32 operand of each TF32 product
    (att, the state, b w) is rounded to TF32 and c.b is exact; float32
    inputs keep float32 operands."""
    B, S, H, hd = xh.shape
    N = b.shape[-1]
    Q, ranks, per = plan["chunk"], plan["cluster"], plan["chunks_per_block"]
    nc = plan["chunks"]
    rnd = _tf32 if plan["tensor_cores"] else (lambda t: t)
    y = torch.zeros(B, S, H, hd)
    state = torch.zeros(B, H, hd, N)
    xf, bf, cf = xh.float(), b.float(), c.float()
    for bi in range(B):
        for h in range(H):
            chunks = []
            for k in range(nc):
                c0 = k * Q
                n = min(Q, S - c0)
                la = torch.cumsum(torch.log(torch.clamp(a[bi, c0:c0 + n, h], min=1e-20)), 0)
                dtk = dt[bi, c0:c0 + n, h]
                w = dtk * torch.exp(torch.clamp(la[-1] - la, -60.0, 0.0))
                chunks.append((c0, n, la, dtk, w))

            def local(k):
                c0, n, _, _, w = chunks[k]
                return (rnd(bf[bi, c0:c0 + n] * w[:, None]).T @ xf[bi, c0:c0 + n, h]).T  # [hd, N]

            runs = [range(min(nc, r * per), min(nc, (r + 1) * per)) for r in range(ranks)]
            locs, decays = [], []
            for run in runs:
                s_loc, ld = torch.zeros(hd, N), torch.tensor(0.0)
                for k in run:
                    s_loc = (torch.exp(chunks[k][2][-1]) * s_loc if k != run[0] else 0.0) + local(k)
                    ld = ld + chunks[k][2][-1]
                locs.append(s_loc)
                decays.append(torch.exp(ld))
            s_fold = torch.zeros(hd, N)
            for run, s_loc, dk in zip(runs, locs, decays):
                s_run = s_fold
                for k in run:
                    c0, n, la, dtk, _ = chunks[k]
                    ck, xk = cf[bi, c0:c0 + n], xf[bi, c0:c0 + n, h]
                    seg = torch.exp(torch.clamp(la[:, None] - la[None, :], -60.0, 0.0))
                    att = torch.tril((ck @ bf[bi, c0:c0 + n].T) * seg * dtk[None, :])
                    yk = torch.exp(la)[:, None] * (ck @ rnd(s_run).T) + rnd(att) @ xk
                    y[bi, c0:c0 + n, h] = yk
                    if k != run[-1]:
                        s_run = torch.exp(la[-1]) * s_run + local(k)
                s_fold = dk * s_fold + s_loc
            state[bi, h] = s_fold
    return y.to(xh.dtype), state


def _ssd_inputs(B, S, H, hd, N, seed):
    """chip_smoke.py's ssd_case at a reduced width: dt = softplus(. - 2),
    a = exp(-dt), x, b, c ~ N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, hd, generator=g)
    b = torch.randn(B, S, N, generator=g)
    c = torch.randn(B, S, N, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g) - 2.0)
    return x, torch.exp(-dt), b, c, dt


# chip_smoke.py's SSD_TOL: max |kernel - plain| <= rel * max |plain| + abs
SSD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 0.0)}


@pytest.mark.parametrize("S,chunk,jax_chunk", [
    (1000, 128, 125),   # 8 chunks, the last of 104: 8 ranks of one chunk
    (97, 16, 97),       # a prime: 7 chunks, the last of 1, runs of 2 over 4 ranks
    (256, 32, 32),      # 8 whole chunks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_reduction_order_matches_pallas(S, chunk, jax_chunk, dtype):
    """The replay at the kernel's own plan (ragged last chunks, runs of
    one or two chunks a rank) against ``ops.ssd`` in interpret mode (at a
    chunk that divides S, as the Pallas kernel needs), bf16 with the TF32
    operand rounding emulated, y within chip_smoke.py's SSD_TOL; and the
    final state against the plain version's."""
    B, H, hd, N = 1, 2, 16, 32
    x, a, b, c, dt = _ssd_inputs(B, S, H, hd, N, seed=S)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xt, bt, ct = x.to(tdt), b.to(tdt), c.to(tdt)
    plan = ssd.ssd_plan(tdt, B, S, H, hd, N, chunk)
    got_y, got_s = _ssd_replay(xt, a, bt, ct, dt, plan)
    want = _np(jops.ssd(*(jnp.asarray(_np(v), jnp.float32 if v.dtype == torch.float32 else jnp.bfloat16)
                          for v in (xt, a, bt, ct, dt)), chunk=jax_chunk, mode="interpret"))
    rel, absol = SSD_TOL[dtype]
    err = np.abs(_np(got_y) - want).max()
    assert err <= rel * np.abs(want).max() + absol, (err, np.abs(want).max())
    _, plain_s = ssd.plain_ssd_scan(xt, a, bt, ct, dt, chunk)
    s_err = (got_s - plain_s).abs().max().item()
    assert s_err <= rel * plain_s.abs().max().item() + absol, s_err


@pytest.mark.parametrize("S,hd,N,chunk,jax_chunk", [
    (512, 24, 32, 256, 256),    # a chunk above 128: sub-chunks of 128; hd off 16: a padded slice
    (384, 16, 256, 128, 128),   # N = 256: float32 b, c of 128 rows do not fit, the chunk shrinks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_wide_shapes_replay_matches_pallas(S, hd, N, chunk, jax_chunk, dtype):
    """The shapes the kernel refused before (a chunk above 128, N above
    128, hd off a multiple of 16): the replay at the kernel's plan (its
    chunk, at most 128 and smaller where the state is wide, whose chunks
    are the same scan) against ``ops.ssd`` in interpret mode at the
    caller's chunk, y within chip_smoke.py's SSD_TOL; the final state
    against the plain version's."""
    B, H = 1, 2
    x, a, b, c, dt = _ssd_inputs(B, S, H, hd, N, seed=S + N)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xt, bt, ct = x.to(tdt), b.to(tdt), c.to(tdt)
    plan = ssd.ssd_plan(tdt, B, S, H, hd, N, chunk)
    assert plan["chunk"] <= 128 and plan["grid"][2] * plan["slice"] >= hd
    assert plan["smem"] <= da.SMEM_OPT_IN
    if hd % 16:
        assert plan["grid"][2] * plan["slice"] > hd  # the last slice is padded
    got_y, got_s = _ssd_replay(xt, a, bt, ct, dt, plan)
    want = _np(jops.ssd(*(jnp.asarray(_np(v), jnp.float32 if v.dtype == torch.float32 else jnp.bfloat16)
                          for v in (xt, a, bt, ct, dt)), chunk=jax_chunk, mode="interpret"))
    rel, absol = SSD_TOL[dtype]
    err = np.abs(_np(got_y) - want).max()
    assert err <= rel * np.abs(want).max() + absol, (err, np.abs(want).max())
    plain_y, plain_s = ssd.ssd_scan(xt, a, bt, ct, dt, chunk)
    s_err = (got_s - plain_s).abs().max().item()
    assert s_err <= rel * plain_s.abs().max().item() + absol, s_err


def test_ssd_plan_names_the_largest_state_it_takes():
    with pytest.raises(ValueError, match="N up to"):
        ssd.ssd_plan(torch.float32, 1, 1024, 1, 64, 4096)


def test_ssd_tf32_operands_stay_inside_the_chip_tolerance():
    """TF32 operands (att, the state, b w rounded to 10 mantissa bits) keep
    the bf16 kernel's y and final state within chip_smoke.py's bf16
    SSD_TOL of the plain version, on the inputs chip_smoke.py makes, at
    mamba2-370m's widths (hd 64, N 128) over two heads and 512 positions:
    4 chunks over 4 ranks."""
    B, S, H, hd, N = 1, 512, 2, 64, 128
    x, a, b, c, dt = (t.to(torch.bfloat16) if i in (0, 2, 3) else t
                      for i, t in enumerate(_ssd_inputs(B, S, H, hd, N, seed=0)))
    plan = ssd.ssd_plan(torch.bfloat16, B, S, H, hd, N)
    assert plan["tensor_cores"] and plan["cluster"] == 4
    got_y, got_s = _ssd_replay(x, a, b, c, dt, plan)
    want_y, want_s = ssd.plain_ssd_scan(x, a, b, c, dt)
    rel, _ = SSD_TOL["bfloat16"]
    for got, want in ((got_y, want_y), (got_s, want_s)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rel * want.float().abs().max().item(), err
    # the rounding is real: TF32 moves the state off the float32 replay's
    f32_s = _ssd_replay(x, a, b, c, dt, dict(plan, tensor_cores=False))[1]
    assert not torch.equal(got_s, f32_s)


@pytest.mark.parametrize("H,N,blocks,smem_max", [
    (32, 128, 256, 123_408),   # mamba2-370m's prefill: 8 chunks x 32 heads
    (80, 64, 640, 74_256),     # zamba2-2.7b's
])
def test_ssd_plan_at_the_prefill_shapes(H, N, blocks, smem_max):
    plan = ssd.ssd_plan(torch.bfloat16, 1, 1024, H, 64, N)
    assert (plan["chunk"], plan["chunks"], plan["cluster"], plan["chunks_per_block"]) == (128, 8, 8, 1)
    assert plan["slice"] == 64 and plan["tensor_cores"] and plan["path"] == "cp.async"
    grid = plan["grid"]
    assert grid == (8, H, 1) and grid[0] * grid[1] * grid[2] == blocks
    assert plan["smem"] == smem_max <= da.SMEM_OPT_IN
    f32 = ssd.ssd_plan(torch.float32, 1, 1024, H, 64, N)
    assert not f32["tensor_cores"] and f32["smem"] <= da.SMEM_OPT_IN
    # S past 8 chunks: runs of several chunks a rank, still one cluster of 8
    long = ssd.ssd_plan(torch.bfloat16, 1, 2048, H, 64, N)
    assert (long["cluster"], long["chunks_per_block"]) == (8, 2)
