"""Continuous-batching serving engine: the facade over the serving core.

Port of the JAX package's ``serve/engine.py``: ``serve()`` is the
open-loop entry, ``generate()`` the fixed-batch wrapper, both driving a
``Scheduler`` over a slotted or block-paged pool. The engine runs on the
model's device, CUDA unless the caller asks for the CPU. Options of the
reference that are not ported yet raise ``NotImplementedError`` naming
the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serve.request import Request, ServeStats  # noqa: F401 (re-export)
from repro_torch.serve.scheduler import Scheduler

_NOT_PORTED = {
    "spec": "speculative decoding (ROADMAP §1 item 6)",
    "chunk_size": "chunked prefill (ROADMAP §1 item 6)",
    "decode_plan": "adviser decode plans (ROADMAP §1 item 7)",
    "controller": "the online adviser (ROADMAP §1 item 8)",
    "mesh": "sharded serving (ROADMAP §1 item 9)",
}


def _refuse(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(f"{name}= ({_NOT_PORTED[name]}) is not ported yet")


class ServingEngine:
    def __init__(
        self,
        model,
        params,
        *,
        max_seq: int,
        temperature: float = 0.0,
        max_batch: Optional[int] = None,
        kv_layout: str = "slot",
        block_size: int = 8,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        attention_backend: Optional[str] = None,
        device=None,
        decode_plan=None,
        spec=None,
        chunk_size=None,
        mesh=None,
    ):
        _refuse(decode_plan=decode_plan, spec=spec, chunk_size=chunk_size, mesh=mesh)
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(
                f"engine device {self.device} differs from the model's {model.device}"
            )
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.temperature = temperature
        self.max_batch = max_batch  # default pool size for serve()
        self.kv_layout = kv_layout  # default layout for serve()/scheduler()
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prefix_cache = prefix_cache
        self.attention_backend = kernel_ops.resolve_attention_backend(
            attention_backend, self.device
        )
        self.stats = ServeStats()

    def scheduler(
        self,
        max_batch: int,
        *,
        seed: int = 0,
        kv_layout: Optional[str] = None,
        attention_backend: Optional[str] = None,
        spec=None,
        chunk_size=None,
        controller=None,
    ) -> Scheduler:
        """A fresh scheduler over ``max_batch`` rows sharing this
        engine's stats; ``kv_layout`` and ``attention_backend`` override
        the engine defaults for it."""
        _refuse(spec=spec, chunk_size=chunk_size or None, controller=controller)
        return Scheduler(
            self.model,
            self.params,
            max_batch=max_batch,
            max_seq=self.max_seq,
            temperature=self.temperature,
            stats=self.stats,
            seed=seed,
            kv_layout=kv_layout or self.kv_layout,
            block_size=self.block_size,
            num_blocks=self.num_blocks,
            prefix_cache=self.prefix_cache,
            attention_backend=attention_backend or self.attention_backend,
        )

    def serve(
        self,
        requests,
        *,
        max_batch: Optional[int] = None,
        seed: int = 0,
        kv_layout: Optional[str] = None,
        attention_backend: Optional[str] = None,
        spec=None,
        chunk_size=None,
        mesh=None,
        controller=None,
    ) -> dict:
        """Continuous-batching entry: drive ``requests`` (each with its
        own arrival time, prompt and budget) to completion. Returns rid →
        generated tokens."""
        _refuse(mesh=mesh)
        requests = list(requests)
        mb = max_batch or self.max_batch or max(1, min(8, len(requests)))
        return self.scheduler(
            mb, seed=seed, kv_layout=kv_layout, attention_backend=attention_backend,
            spec=spec, chunk_size=chunk_size, controller=controller,
        ).run(requests)

    def generate(self, prompts, n_steps: int, *, seed: int = 0) -> torch.Tensor:
        """prompts [B, S0] → generated tokens [B, n_steps] (int32, CPU):
        B requests all arriving at t=0 into a B-row pool."""
        prompts = np.asarray(prompts.cpu() if torch.is_tensor(prompts) else prompts)
        B = int(prompts.shape[0])
        if n_steps <= 0:
            self.stats.reset()
            return torch.zeros((B, 0), dtype=torch.int32)
        reqs = [Request(prompt=prompts[i], max_new_tokens=n_steps) for i in range(B)]
        out = self.scheduler(B, seed=seed).run(reqs)
        return torch.stack([torch.from_numpy(out[r.rid]) for r in reqs])
