"""Deterministic synthetic LM data.

Port of the JAX package's ``data/pipeline.py``. A batch is a pure
function of (seed, step), so a restart or an elastic resume reproduces the
token stream with no coordination state. The mixture is the JAX
package's: a Zipf-flavoured unigram draw, (exp(u·ln V) − 1) mod V for u
uniform on [1e-6, 1), with a 0.3 share of tokens copied from the previous
position, so that losses move in the example runs.

The draw comes from a CPU ``torch.Generator`` seeded from (seed, step) and
is then moved to the device, so a step gives the same tokens on any
device. ``jax.random`` cannot be reproduced in torch: the tokens are not
the JAX package's (the parity tests feed its batches through numpy).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


def _step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed for (seed, step), the same in every process
    (the JAX package's ``fold_in(key(seed), step)``)."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(step)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


@dataclass
class SyntheticLMData:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    device: Any = None  # CUDA unless the caller asks for "cpu"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def n_text(self) -> int:
        """Token positions a row: ``seq``, less a VLM's patch rows."""
        if self.cfg.family == "vlm":
            return self.seq - self.cfg.n_frontend_tokens
        return self.seq

    def batch_at(self, step: int) -> dict:
        """The batch for ``step``: tokens and labels [B, n_text] int32
        (labels the tokens shifted by one), mask [B, n_text] float32 ones,
        and for a VLM ``patch_embeds`` [B, n_frontend_tokens, d_model] in
        the model dtype."""
        gen, zipf, copy_mask = self._draw(step)
        B, n = self.batch, self.n_text
        stream = torch.where(copy_mask, torch.roll(zipf, 1, dims=1), zipf)
        out = {
            "tokens": stream[:, :-1].contiguous(),
            "labels": stream[:, 1:].contiguous(),
            "mask": torch.ones((B, n), dtype=torch.float32),
        }
        if self.cfg.family == "vlm":
            out["patch_embeds"] = torch.randn(
                (B, self.cfg.n_frontend_tokens, self.cfg.d_model), generator=gen
            ).to(getattr(torch, self.cfg.dtype))
        return {k: v.to(self.device) for k, v in out.items()}

    def _draw(self, step: int):
        """(generator, unigram ids [B, n_text + 1] int32, copy mask [B,
        n_text + 1]) of ``step``, on the CPU: position i of the stream is
        the unigram id of position i − 1 where the mask is set."""
        gen = torch.Generator(device="cpu").manual_seed(_step_seed(self.seed, step))
        V, shape = self.cfg.vocab_size, (self.batch, self.n_text + 1)
        u = torch.rand(shape, generator=gen) * (1.0 - 1e-6) + 1e-6
        zipf = (torch.exp(u * math.log(float(V))) - 1.0).to(torch.int32) % V
        return gen, zipf, torch.rand(shape, generator=gen) < 0.3

    def batch_specs(self) -> dict:
        """The batch's shapes and dtypes as meta tensors (the JAX package's
        ``ShapeDtypeStruct``s)."""
        B, n = self.batch, self.n_text
        specs = {
            "tokens": torch.empty((B, n), dtype=torch.int32, device="meta"),
            "labels": torch.empty((B, n), dtype=torch.int32, device="meta"),
            "mask": torch.empty((B, n), dtype=torch.float32, device="meta"),
        }
        if self.cfg.family == "vlm":
            specs["patch_embeds"] = torch.empty(
                (B, self.cfg.n_frontend_tokens, self.cfg.d_model),
                dtype=getattr(torch, self.cfg.dtype), device="meta")
        return specs

    def batch_axes(self) -> dict:
        ax = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"), "mask": ("batch", "seq")}
        if self.cfg.family == "vlm":
            ax["patch_embeds"] = ("batch", "seq", None)
        return ax
