"""The kernel library's entry points and the backend registry.

Port of the JAX package's ``kernels/ops.py``: ``matmul``, ``gemv``,
``flash_attention``, ``decode_attention`` and ``ssd`` (the generic kernel
wrappers, with the JAX signatures and defaults), ``paged_attention`` and
``paged_attention_partials`` (the serving-attention surface).

Two registries pick plain PyTorch or a hand-written CUDA kernel:

- ``KERNEL_MODES`` are ``"ref"`` (the plain oracles of ``kernels/ref.py``)
  and ``"kernel"``, for the generic wrappers. A ``mode`` comes from the
  call, else the ``REPRO_KERNEL_MODE`` environment variable (read once),
  else ``"auto"``.
- ``ATTENTION_BACKENDS`` are ``"reference"`` and ``"kernel"``, for the
  serving attention. A backend name comes from the call, else
  ``set_attention_backend``, else ``REPRO_ATTENTION_BACKEND`` (read once),
  else ``"auto"``.

``"auto"`` means the kernel for CUDA tensors and the plain version for CPU
tensors. Bad names fail loudly with the valid choices. The kernel choice
on CPU tensors raises (``require_cuda``): a kernel path never degrades to
a plain version silently. On meta tensors it takes each kernel's
``torch.library`` operator, whose fake gives the output's shape and
launches nothing (a step traced for its cost, ``core/op_cost.py``). The
Pallas ``interpret`` mode and the TPU VMEM check (``check_vmem``) have no
Hopper meaning and are not ported; the
block-shape arguments keep the JAX functions' divisibility contracts
where their kernels have one (``matmul``, ``gemv``, ``decode_attention``).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_call
from repro_torch.kernels.flash_attention import flash_call
from repro_torch.kernels.paged_decode_attention import paged_decode_call, paged_partials_call
from repro_torch.kernels.relic_matmul import gemv_call, matmul_call
from repro_torch.kernels.ssd_scan import ssd_call

KERNEL_MODES = ("ref", "kernel")
ATTENTION_BACKENDS = ("reference", "kernel")

log = logging.getLogger("repro_torch.kernels")

_KERNEL_MODE: Optional[str] = None  # the REPRO_KERNEL_MODE choice
_ATTN_BACKEND: Optional[str] = None  # the set_attention_backend / env choice


def _flight_note(event: str, counter: str, **args) -> None:
    """Mirror a dispatch resolution onto the serving flight recorder as a
    counter and an instant event on the backend lane. The telemetry module
    is looked up in ``sys.modules``, never imported: arming the recorder
    imports it, so an absent module means the recorder is off, and the
    kernel layer never pulls ``repro_torch.serve`` in on its own."""
    import sys

    mod = sys.modules.get("repro_torch.serve.telemetry")
    if mod is None:
        return
    tel = mod.get_telemetry()
    if not tel.enabled:
        return
    tel.count(counter)
    tel.tracer.instant(event, "backend", tid=mod.TID_BACKEND, args=args or None)


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _validate_mode(name: str, source: str) -> str:
    if name not in KERNEL_MODES + ("auto",):
        raise ValueError(
            f"{source}={name!r} is not a valid kernel mode; choose one of "
            f"{('auto',) + KERNEL_MODES} (Pallas interpret mode has no Hopper counterpart)"
        )
    return name


def default_kernel_mode(device: Optional[torch.device] = None) -> str:
    """The ``mode="auto"`` resolution of the generic wrappers:
    ``REPRO_KERNEL_MODE`` (read and logged once; bad values fail loudly),
    else ``"auto"``, which means ``"kernel"`` on a CUDA ``device`` and
    ``"ref"`` otherwise."""
    global _KERNEL_MODE
    if _KERNEL_MODE is None:
        raw = os.environ.get("REPRO_KERNEL_MODE", "auto")
        _KERNEL_MODE = _validate_mode(raw, "REPRO_KERNEL_MODE")
        log.info("kernel mode resolved once: %s", _KERNEL_MODE)
        _flight_note("kernel-mode-resolved", "backend.resolutions",
                     resolved=_KERNEL_MODE, source=raw)
    if _KERNEL_MODE == "auto":
        return "kernel" if _on_cuda(device) else "ref"
    return _KERNEL_MODE


def _mode(mode: str, t: torch.Tensor, what: str) -> str:
    """A generic wrapper's mode for input ``t``; the kernel needs CUDA."""
    mode = default_kernel_mode(t.device) if mode == "auto" else _validate_mode(mode, "mode")
    if mode == "kernel":
        require_cuda(t, what)
    return mode


def _validate_backend(name: str, source: str) -> str:
    if name not in ATTENTION_BACKENDS + ("auto",):
        raise ValueError(
            f"{source}={name!r} is not a valid attention backend; "
            f"choose one of {('auto',) + ATTENTION_BACKENDS}"
        )
    return name


def set_attention_backend(name: Optional[str]) -> None:
    """Process-default attention backend (``None`` restores the
    environment / device resolution)."""
    global _ATTN_BACKEND
    _ATTN_BACKEND = None if name is None else _validate_backend(name, "backend")


def resolve_attention_backend(
    backend: Optional[str] = None, device: Optional[torch.device] = None, mesh=None
) -> str:
    """Per-call name → ``set_attention_backend`` → ``REPRO_ATTENTION_BACKEND``
    → ``"auto"``; ``"auto"`` resolves to ``"kernel"`` on a CUDA ``device``
    and to ``"reference"`` otherwise. A serving ``mesh`` changes nothing:
    each rank launches the kernel on its own shard, so ``"kernel"`` stays
    ``"kernel"`` on the card and raises on CPU tensors as it does unsharded
    (the JAX package turns it into Pallas interpret mode on a host mesh,
    which has no Hopper counterpart)."""
    del mesh
    global _ATTN_BACKEND
    if backend is not None and backend != "auto":
        name = _validate_backend(backend, "backend")
    else:
        if _ATTN_BACKEND is None:
            raw = os.environ.get("REPRO_ATTENTION_BACKEND", "auto")
            _ATTN_BACKEND = _validate_backend(raw, "REPRO_ATTENTION_BACKEND")
            log.info("attention backend resolved once: %s", _ATTN_BACKEND)
            _flight_note("attention-backend-resolved", "backend.resolutions",
                         resolved=_ATTN_BACKEND, source=raw)
        name = _ATTN_BACKEND
    if name == "auto":
        return "kernel" if _on_cuda(device) else "reference"
    return name


def require_cuda(t: torch.Tensor, what: str) -> None:
    """The kernel wrappers run their plain versions on CPU tensors; an
    explicit ``"kernel"`` mode or backend must not, so it raises here.
    Meta tensors pass: they reach the kernels' operators, whose fakes
    launch nothing."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(
            f"{what}: 'kernel' needs CUDA tensors, got {t.device} "
            "(use the reference on the CPU)"
        )


# ---------------------------------------------------------------------------
# generic kernel wrappers


def matmul(x, w, *, bm=256, bk=512, bn=256, mode="auto"):
    """x [M,K] @ w [K,N] → [M,N] in x's type, float32 accumulation; the
    kernel takes M, K, N multiples of min(bm, M), min(bk, K), min(bn, N)."""
    if _mode(mode, x, "matmul") == "ref":
        return ref.matmul_ref(x, w)
    return matmul_call(x, w, bm=bm, bk=bk, bn=bn)


def gemv(x, w, *, bk=1024, bn=512, mode="auto"):
    """x [B,K] @ w [K,N] for a few decode rows, as ``matmul``; the kernel
    takes K, N multiples of min(bk, K), min(bn, N)."""
    if _mode(mode, x, "gemv") == "ref":
        return ref.matmul_ref(x, w)
    return gemv_call(x, w, bk=bk, bn=bn)


def flash_attention(q, k, v, *, causal=True, bq=256, bk=512, mode="auto"):
    """q [B,Sq,H,hd]; k, v [B,Skv,KV,hd] → [B,Sq,H,hd]. Causal queries are
    the last Sq of the Skv positions (``ref.attention_ref``'s offset). The
    CUDA kernel tiles Sq and Skv itself and takes ragged shapes, so ``bq``
    and ``bk`` (the Pallas kernel's blocks) set nothing here."""
    if _mode(mode, q, "flash_attention") == "ref":
        return ref.attention_ref(q, k, v, causal=causal)
    return flash_call(q, k, v, k.shape[1] - q.shape[1] if causal else 0, causal)


def decode_attention(q, k_cache, v_cache, cache_len, *, bk=512, mode="auto"):
    """q [B,H,hd]; caches [B,Smax,KV,hd]; ``cache_len`` [B] → [B,H,hd]; a
    row with ``cache_len`` 0 gives zeros. The kernel takes Smax a multiple
    of min(bk, Smax)."""
    if _mode(mode, q, "decode_attention") == "ref":
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len)
    return decode_call(q, k_cache, v_cache, cache_len.to(torch.int32), bk=bk)


def ssd(xh, a, b, c, dt, *, chunk=128, mode="auto"):
    """The SSD scan's y [B,S,H,hd] (``ref.ssd_ref``'s recurrence); the
    kernel's final state is dropped, as the JAX entry point has none."""
    if _mode(mode, xh, "ssd") == "ref":
        return ref.ssd_ref(xh, a, b, c, dt)
    return ssd_call(xh, a, b, c, dt, chunk)[0]


# ---------------------------------------------------------------------------
# serving attention


def _attention_backend(mode, q, what):
    backend = resolve_attention_backend("reference" if mode == "ref" else mode, q.device)
    if backend == "kernel":
        require_cuda(q, what)
    return backend


def paged_attention(
    q, k_pool, v_pool, block_tables, lengths, k_scale=None, v_scale=None, *, mode="auto",
    plan_kv_heads=None,
):
    """Block-paged decode/verify attention straight off the pool: q
    [B,T,H,hd]; pools [NB,BS,KV,hd] (int8 with ``k_scale``/``v_scale``
    [NB,BS,KV]); ``block_tables`` [B,MB]; ``lengths`` [B] committed lengths
    (query t attends positions < lengths + t + 1). ``mode`` resolves
    through the attention registry (``"ref"`` is spelled ``"reference"``
    there). ``plan_kv_heads``: a head split's unsharded kv heads, for the
    kernel's launch plan (``paged_decode_attention``)."""
    if _attention_backend(mode, q, "paged_attention") == "reference":
        return ref.paged_attention_ref(
            q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale
        )
    return paged_decode_call(
        q, k_pool, v_pool, block_tables.to(torch.int32), lengths.to(torch.int32),
        k_scale, v_scale, plan_kv_heads,
    )


def paged_attention_partials(
    q, k_pool, v_pool, block_tables, lengths, owned, k_scale=None, v_scale=None, *,
    mode="auto", plan_kv_heads=None,
):
    """The kernel's partials mode for the kv-sequence split: the inputs of
    ``paged_attention`` on this rank's pool shard plus ``owned`` [B,MB]
    (nonzero: this rank holds the block) → float32 ``(m, l, acc)``,
    unnormalised, for a cross-rank softmax combine. Kernel backend only:
    the reference partials are ``models/attention.py::paged_flash_partials``."""
    if _attention_backend(mode, q, "paged_attention_partials") == "reference":
        raise ValueError(
            "paged_attention_partials is the kernel-backend surface; the "
            "reference partials are models/attention.paged_flash_partials"
        )
    return paged_partials_call(
        q, k_pool, v_pool, block_tables.to(torch.int32), lengths.to(torch.int32),
        owned.to(torch.int32), k_scale, v_scale, plan_kv_heads,
    )
