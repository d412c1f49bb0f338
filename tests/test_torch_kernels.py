"""The port's two attention kernels on the CPU: their plain versions held
against the JAX package's Pallas kernels (interpret mode) and jnp
references, and the device dispatch of their wrappers and the backend
registry. Inputs are float32 numpy arrays from a seed, handed to both
packages. Tolerance 2e-5: both sides compute a float32 softmax, summed in
different orders."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.models import attention as tattn

ATOL = 2e-5


def _paged_inputs(g, t, seed):
    B, KV, hd, NB, BS, MB = 4, 2, 16, 12, 8, 4
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, t, KV * g, hd)).astype(np.float32)
    kp = rng.normal(size=(NB + 1, BS, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(NB + 1, BS, KV, hd)).astype(np.float32)
    tbl = rng.integers(0, NB, size=(B, MB)).astype(np.int32)
    # length 0 (a dead row), exact block boundaries, and a block interior;
    # entries past each row's window point at the null block NB
    lens = np.array([0, BS, 2 * BS, 3 * BS - t - 1], np.int32)
    for b in range(B):
        tbl[b, -(-(lens[b] + t) // BS):] = NB
    tbl[3, 1] = NB  # a null block inside a live window
    return q, kp, vp, tbl, lens


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_paged_plain_matches_pallas_and_oracle(g, t):
    q, kp, vp, tbl, lens = _paged_inputs(g, t, seed=10 * g + t)
    got = pda.paged_decode_attention(*(torch.from_numpy(a) for a in (q, kp, vp, tbl, lens)))
    j = [jnp.asarray(a) for a in (q, kp, vp, tbl, lens)]
    pallas = np.asarray(jops.paged_attention(*j, mode="interpret"))
    oracle = np.asarray(jref.paged_attention_ref(*j))
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, atol=ATOL, rtol=ATOL)
    assert np.isfinite(got.numpy()).all()  # dead rows give finite output


@pytest.mark.parametrize("s,h,kv,bq,bk", [(64, 4, 2, 32, 32), (32, 6, 2, 16, 8)])
def test_flash_plain_matches_pallas(s, h, kv, bq, bk):
    rng = np.random.default_rng(s + h)
    q = rng.normal(size=(2, s, h, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, kv, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, kv, 16)).astype(np.float32)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, bq=bq, bk=bk,
        mode="interpret",
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize(
    "sq,skv,off",
    [(5, 13, 8), (7, 7, 0), (1, 1, 0), (37, 37, 0), (16, 40, 24), (3, 9, 2)],
)
def test_flash_plain_and_port_prefill_match_gqa_attention(sq, skv, off):
    """The Pallas kernel has no q_offset and needs tiled shapes; the
    reference prefill's ``gqa_attention(q_offset=)`` is the target for the
    offset and ragged cases. The port's own reference prefill (the
    chunked scan) is held to it too."""
    rng = np.random.default_rng(sq * 100 + skv)
    q = rng.normal(size=(2, sq, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    want = np.asarray(jattn.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=off, chunk=8
    ))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = fa.flash_attention(tq, tk, tv, off)
    port = tattn.gqa_attention(tq, tk, tv, q_offset=off, chunk=8, backend="reference")
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(port.numpy(), want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("smax", [16, 24, 13, 257])
def test_identity_table_view_matches_dense_decode(smax):
    """The slot layout's route into the paged kernel: the dense cache
    viewed as a pool with an identity table (any block size that divides
    max_seq, down to 1 for a prime above 256), run here through the
    kernel wrapper's plain version on CPU tensors, equals the dense
    decode reference."""
    rng = np.random.default_rng(smax)
    q = torch.from_numpy(rng.normal(size=(2, 1, 6, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(2, smax, 2, 16)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(2, smax, 2, 16)).astype(np.float32))
    clen = torch.tensor([3, smax - 1], dtype=torch.int32)
    got = tattn._kernel_cached_attention(q, kc, vc, clen)
    want = tattn.decode_attention(q, kc, vc, clen + 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=ATOL)


def test_cpu_tensors_take_plain_versions_without_launching():
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _paged_inputs(3, 1, seed=0))
    pda.paged_decode_attention.launches = fa.flash_attention.launches = 0
    pda.paged_decode_attention(q, kp, vp, tbl, lens)
    tattn.paged_attention(q, kp, vp, tbl, lens)  # auto on CPU → reference
    x = torch.randn(1, 8, 6, 16)
    kv = torch.randn(1, 8, 2, 16)
    fa.flash_attention(x, kv, kv)
    tattn.gqa_attention(x, kv, kv)
    tattn._cached_attention(x[:, :1], kv, kv, torch.tensor([3]))
    assert pda.paged_decode_attention.launches == 0
    assert fa.flash_attention.launches == 0
    assert _build._lib is None  # nothing was built or loaded


def test_kernel_backend_on_cpu_tensors_raises():
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _paged_inputs(2, 1, seed=1))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn.paged_attention(q, kp, vp, tbl, lens, backend="kernel")
    x = torch.randn(1, 4, 2, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn.gqa_attention(x, x, x, backend="kernel")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tattn._cached_attention(x[:, :1], x, x, torch.tensor([2]), backend="kernel")


def test_backend_registry_resolution(monkeypatch):
    monkeypatch.setattr(tops, "_ATTN_BACKEND", None)
    monkeypatch.delenv("REPRO_ATTENTION_BACKEND", raising=False)
    assert tops.resolve_attention_backend(None, torch.device("cpu")) == "reference"
    assert tops.resolve_attention_backend("auto", torch.device("cuda")) == "kernel"
    assert tops.resolve_attention_backend("reference", torch.device("cuda")) == "reference"
    with pytest.raises(ValueError, match=r"auto.*reference.*kernel"):
        tops.resolve_attention_backend("interpret")
    with pytest.raises(ValueError, match=r"auto.*reference.*kernel"):
        tops.set_attention_backend("warp")
    monkeypatch.setattr(tops, "_ATTN_BACKEND", None)
    monkeypatch.setenv("REPRO_ATTENTION_BACKEND", "kernel")
    assert tops.resolve_attention_backend(None, torch.device("cpu")) == "kernel"
    tops.set_attention_backend("reference")
    assert tops.resolve_attention_backend() == "reference"  # config beats env


def test_kernel_modules_import_without_nvcc_or_cuda():
    code = (
        "import os, shutil; os.environ['PATH'] = ''\n"
        "import torch; assert not torch.cuda.is_available()  # CUDA hidden\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.paged_decode_attention as p, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.kernels.relic_matmul, repro_torch.kernels.decode_attention\n"
        "from repro_torch.kernels import _build; assert _build._lib is None\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": ":".join(sys.path), "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "kernels").exists()
    assert _build._lib is None


def test_build_key_follows_the_sources(monkeypatch):
    key = _build._digest()
    assert key == _build._digest()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._digest() != key  # a flag change rebuilds, as a source change does
    names = {p.name for p in _build._sources()}
    assert {"paged_decode_attention.cu", "flash_attention.cu", "ssd_scan.cu",
            "relic_matmul.cu", "decode_attention.cu", "attention_tile.cuh", "hopper.cuh"} <= names


def test_refused_tma_descriptor_raises_with_its_cause():
    """An entry point returns TMA_REFUSED + the driver's CUresult for a TMA
    descriptor cuTensorMapEncodeTiled refused; it must raise, never pass."""
    with pytest.raises(RuntimeError, match=r"refused a TMA descriptor \(CUresult 1\)"):
        _build.check(_build.TMA_REFUSED + 1, "relic_matmul")
    with pytest.raises(RuntimeError, match="no cuTensorMapEncodeTiled"):
        _build.check(_build.TMA_REFUSED + 0xFFFF, "flash_attention")
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.check(1, "flash_attention")
    _build.check(0, "flash_attention")


# The flash shapes of chip_smoke.py's phases 3-4 and 11: (B, Sq, Skv,
# q_offset, H, KV, hd, causal); zamba2-2.7b's and stablelm-3b's prefill at hd
# 80, phi3-medium-14b's and internlm2-20b's at hd 128, and phi3's heads
# non-causal.
CHIP_FLASH_SHAPES = [
    (2, 1, 1, 0, 9, 3, 64, True), (2, 37, 37, 0, 9, 3, 64, True),
    (2, 512, 512, 0, 9, 3, 64, True), (2, 2048, 2048, 0, 9, 3, 64, True),
    (2, 64, 576, 512, 9, 3, 64, True), (1, 1024, 1024, 0, 9, 3, 64, True),
    (1, 1024, 1024, 0, 32, 32, 80, True), (2, 512, 512, 0, 9, 3, 64, False),
    (1, 1024, 1024, 0, 40, 10, 128, True), (1, 1024, 1024, 0, 48, 8, 128, True),
    (2, 512, 512, 0, 40, 10, 128, False),
]


@pytest.mark.parametrize("B,Sq,Skv,off,H,KV,hd,causal", CHIP_FLASH_SHAPES)
def test_flash_plan_at_chip_shapes(B, Sq, Skv, off, H, KV, hd, causal):
    """bf16 at hd 64 / 80 / 128 takes wgmma: one block per (64 query rows,
    query head, batch row), 64-key tiles in a 2-stage ring; Q, K and V
    arrive as [64 rows x 64 columns] boxes of one head, plus a 16-column box
    at hd 80 or a second 64-column box at hd 128. float32 keeps the
    CUDA-core kernel: a block per (16 positions, batch row, kv head)."""
    plan = fa.flash_plan(torch.bfloat16, B, Sq, H, KV, hd)
    assert plan["path"] == "wgmma" and (plan["rows"], plan["keys"], plan["stages"]) == (64, 64, 2)
    assert plan["threads"] == 160 and plan["grid"] == (-(-Sq // 64) * H * B,)
    assert plan["boxes"] == [(64, 1, 64, 1)] + ([(hd - 64, 1, 64, 1)] if hd > 64 else [])
    f32 = fa.flash_plan(torch.float32, B, Sq, H, KV, hd)
    assert f32 == {"path": "cuda_cores", "rows": 16 * (H // KV), "keys": 32, "threads": 128,
                   "grid": (-(-Sq // 16), B * KV)}


def test_flash_plan_grid_at_smollm_serving_prefill():
    # 16 q-blocks x 9 heads: all 144 blocks resident at once on 132 SMs
    assert fa.flash_plan(torch.bfloat16, 1, 1024, 9, 3, 64)["grid"] == (144,)


@pytest.mark.parametrize("hd,path", [(16, "cuda_cores"), (96, "cuda_cores"), (112, "cuda_cores"),
                                     (64, "wgmma"), (80, "wgmma"), (128, "wgmma")])
def test_flash_plan_bf16_head_sizes(hd, path):
    assert fa.flash_plan(torch.bfloat16, 1, 128, 4, 2, hd)["path"] == path


@pytest.mark.parametrize("hd", [8, 40, 72, 100])
def test_flash_plan_refuses_bf16_head_size_off_a_k_slice(hd):
    """A bf16 head size off a wgmma k-slice (16) runs on the CUDA-core
    kernel, with the same plan as float32, as the JAX function runs it."""
    plan = fa.flash_plan(torch.bfloat16, 1, 128, 4, 2, hd)
    assert plan == fa.flash_plan(torch.float32, 1, 128, 4, 2, hd)
    assert plan == {"path": "cuda_cores", "rows": 32, "keys": 32, "threads": 128,
                    "grid": (8, 2)}


def test_flash_plan_routes_misaligned_bf16_to_cuda_cores():
    """bf16 q 2 bytes past a 16-byte boundary cannot be a TMA source: the
    wrapper's alignment check sends hd 64 to the CUDA-core kernel; only an
    unsupported dtype raises."""
    q = torch.zeros(1 * 128 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 128, 4, 64)
    kv = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    assert q.is_contiguous() and not _build.aligned16(q, kv, kv) and _build.aligned16(kv)
    assert fa.flash_plan(torch.bfloat16, 1, 128, 4, 2, 64, _build.aligned16(q, kv, kv))["path"] == "cuda_cores"
    assert fa.flash_plan(torch.bfloat16, 1, 128, 4, 2, 64, _build.aligned16(kv))["path"] == "wgmma"
    with pytest.raises(TypeError, match="no kernel for torch.float16"):
        fa.flash_plan(torch.float16, 1, 128, 4, 2, 64)


def _online_softmax_bf16_p(q, k, v, q_offset, causal, tile=64):
    """The wgmma kernel's arithmetic in plain PyTorch (a test-local copy):
    float32 scores from bf16 q and k, 64-key tiles folded into a running
    max m and sum l, P rounded to bf16 before P·V with l summing the
    rounded weights, float32 accumulators, acc / max(l, 1e-30) rounded
    once to bf16."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, hd))
    pos = torch.arange(Sq) + q_offset
    for j0 in range(0, Skv, tile):
        keys = torch.arange(j0, min(j0 + tile, Skv))
        s = qf @ kf[:, :, keys].transpose(-1, -2) / hd**0.5
        valid = keys[None, :] <= pos[:, None] if causal else torch.ones(Sq, len(keys), dtype=torch.bool)
        s = s.masked_fill(~valid, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0).bfloat16().float()
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vf[:, :, keys]
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("B,Sq,Skv,off,H,KV,hd,causal", CHIP_FLASH_SHAPES)
def test_bf16_p_rounding_stays_inside_the_chip_tolerance(B, Sq, Skv, off, H, KV, hd, causal):
    """P rounded to bf16 before P·V (the wgmma kernel's A operand) keeps
    the output within chip_smoke.py's bf16 checks of the plain version, on
    the inputs chip_smoke.py makes for the same shapes: TOL's absolute
    2e-2, and each query's output vector within 2e-2 of its largest
    |plain| value (+1e-6)."""
    g = torch.Generator().manual_seed(0)  # chip_smoke.py's flash_case, seed 0
    q, k, v = (torch.randn(*shape, generator=g).to(torch.bfloat16)
               for shape in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    got = _online_softmax_bf16_p(q, k, v, off, causal).float().flatten(0, 2)
    want = fa.plain_flash_attention(q, k, v, off, causal).float().flatten(0, 2)
    per_query = (got - want).abs().amax(1)
    assert per_query.max().item() <= 2e-2, per_query.max().item()
    limit = 2e-2 * want.abs().amax(1) + 1e-6
    assert bool((per_query <= limit).all()), (per_query / limit).max().item()
