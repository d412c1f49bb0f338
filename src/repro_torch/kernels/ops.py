"""Kernel-backend registry (attention and the SSD scan).

Port of the backend half of the JAX package's ``kernels/ops.py``.
``ATTENTION_BACKENDS`` are ``"reference"`` (the plain PyTorch oracles)
and ``"kernel"`` (the hand-written CUDA kernels). A backend name comes
from the call, else ``set_attention_backend``, else the
``REPRO_ATTENTION_BACKEND`` environment variable (read once), else
``"auto"``; ``"auto"`` means ``"kernel"`` for CUDA tensors and
``"reference"`` for CPU tensors. Bad names fail loudly with the valid
choices. ``models/attention.py`` and ``models/ssm.py`` call the kernel
wrappers themselves and raise for ``"kernel"`` with CPU tensors
(``require_cuda``): a kernel path never degrades to a plain version
silently. (The Pallas ``interpret`` mode and the TPU VMEM check have no
Hopper meaning and are not ported.)
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch

ATTENTION_BACKENDS = ("reference", "kernel")

log = logging.getLogger("repro_torch.kernels")

_ATTN_BACKEND: Optional[str] = None  # the set_attention_backend / env choice


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
    backend: Optional[str] = None, device: Optional[torch.device] = None
) -> str:
    """Per-call name → ``set_attention_backend`` → ``REPRO_ATTENTION_BACKEND``
    → ``"auto"``; ``"auto"`` resolves to ``"kernel"`` on a CUDA ``device``
    and to ``"reference"`` otherwise."""
    global _ATTN_BACKEND
    if backend is not None and backend != "auto":
        name = _validate_backend(backend, "backend")
    else:
        if _ATTN_BACKEND is None:
            raw = os.environ.get("REPRO_ATTENTION_BACKEND", "auto")
            _ATTN_BACKEND = _validate_backend(raw, "REPRO_ATTENTION_BACKEND")
            log.info("attention backend resolved once: %s", _ATTN_BACKEND)
        name = _ATTN_BACKEND
    if name == "auto":
        on_cuda = device is not None and torch.device(device).type == "cuda"
        return "kernel" if on_cuda else "reference"
    return name


def require_cuda(t: torch.Tensor, what: str) -> None:
    """The kernel wrappers run their plain versions on CPU tensors; an
    explicit ``"kernel"`` backend must not, so it raises here."""
    if t.device.type != "cuda":
        raise ValueError(
            f"{what}: backend 'kernel' needs CUDA tensors, got {t.device} "
            "(use backend='reference' on the CPU)"
        )
