"""The training loop, with the fault-tolerance features of the JAX
package's ``train/trainer.py``:

* checkpoint/restart: a snapshot (params + optimizer state + step) every
  ``ckpt_every`` steps, asynchronous; ``Trainer.run`` resumes from the
  latest published step;
* induced failure: ``fail_at_step`` raises once at that step, so a test
  (or a drill) can check that the restart continues bit for bit;
* straggler watchdog: an EWMA of the step's wall time (after a device
  synchronise on CUDA); a step slower than ``straggler_factor`` × the EWMA
  is logged and checkpointed at once;
* elastic resume: checkpoints hold whole leaves (``ckpt/checkpoint.py``),
  so a run resumes on any mesh or on one device.

The step is ``compiled_train_step``, the reference's ``jax.jit`` of
``make_train_step``: one CUDA graph a batch shape on the card (the first
step eager, then captured and replayed), the record of the key on the CPU.
The trainer owns the state storage that the graph updates in place, as
``ServingEngine`` owns its ``StateStorage``: ``init_state``, a resume and
a ``run(state)`` given a state copy into it, so a restart captures nothing
new. The state ``run`` returns is that storage; the next ``run`` steps it
in place (a checkpoint's host copy is taken before ``save`` returns).

A model built on a mesh (``Model(cfg, mesh=mesh)``) trains split: every
rank of the mesh runs the trainer, its state is the rank's shards
(``model.shard_params``), the step is ``make_train_step``'s split step
(ZeRO-2 for an FSDP config with ``zero2``), run eagerly as a gloo
collective cannot be captured, and checkpoints are saved whole by rank (0,
…, 0) and sliced for each rank on restore.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamW, OptState
from repro_torch.train.train_step import compiled_train_step, make_train_step
from repro_torch.tree import flatten, map_tree


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.3
    accum_steps: int = 1
    log_every: int = 10


@dataclass
class TrainerState:
    params: Any
    opt_state: Any
    step: int = 0


class Trainer:
    def __init__(
        self,
        model,
        opt: AdamW,
        data,
        cfg: TrainerConfig,
        *,
        fail_at_step: Optional[int] = None,  # induced-failure hook (tests)
        log_fn: Callable[[str], None] = print,
    ):
        self.model = model
        self.opt = opt
        self.data = data
        self.cfg = cfg
        self.fail_at_step = fail_at_step
        self.log = log_fn
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.split = model.train_split is not None
        if self.split:
            zero2 = bool(model.cfg.zero2) and model.cfg.param_sharding == "fsdp"
            self.step_fn = make_train_step(model, opt, accum_steps=cfg.accum_steps,
                                           zero2_axes=model.param_axes() if zero2 else None)
        else:
            self.step_fn = compiled_train_step(model, opt, accum_steps=cfg.accum_steps)
        self._storage: Optional[TrainerState] = None  # what the step updates in place
        self.events: list[str] = []
        self.step_times: list[float] = []  # wall seconds of each step run
        self._ewma: Optional[float] = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainerState:
        """Fresh parameters and optimizer state, in the trainer's storage
        (made at the first call)."""
        params = self.model.init(seed)
        if self.split:
            params = self.model.shard_params(params)
        opt_state = self.opt.init(params)
        if self._storage is None:  # fresh tensors: they become the storage
            self._storage = TrainerState(params=params, opt_state=opt_state)
        return self._store(params, opt_state, 0)

    def _store(self, params, opt_state, step: int) -> TrainerState:
        """(params, opt_state) copied into the trainer's storage (made as a
        copy at the first call), as a state at ``step``."""
        new = (params, opt_state)
        if self._storage is None:
            params, opt_state = map_tree(lambda t: t.detach().clone(), new)
            self._storage = TrainerState(params=params, opt_state=opt_state)
        else:
            held = (self._storage.params, self._storage.opt_state)
            with torch.no_grad():
                for dst, src in zip(flatten(held)[0], flatten(new)[0]):
                    if dst is not src:
                        dst.copy_(src)
        return TrainerState(params=self._storage.params, opt_state=self._storage.opt_state,
                            step=step)

    def _maybe_restore(self, state: TrainerState) -> TrainerState:
        # an in-process restart may arrive while the last save's thread is
        # still publishing its step
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            return state
        tree = {"params": state.params, "opt": state.opt_state}
        restored, meta = self.ckpt.restore(tree, latest, **self._on_mesh())
        self.events.append(f"restored step {latest}")
        self.log(f"[trainer] restored checkpoint at step {latest}")
        return self._store(restored["params"], restored["opt"], meta["step"])

    def _on_mesh(self) -> dict:
        """A split trainer's checkpoint arguments: its mesh, and the specs of
        the checkpointed tree (the moments shard as their parameters)."""
        if not self.split:
            return {}
        specs = self.model.train_split.storage
        return {"mesh": self.model.mesh,
                "specs": {"params": specs, "opt": OptState(step=(), mu=specs, nu=specs)}}

    def _save(self, state: TrainerState, blocking=False):
        self.ckpt.save(state.step, {"params": state.params, "opt": state.opt_state},
                       meta={"step": state.step}, blocking=blocking, **self._on_mesh())

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    # ------------------------------------------------------------------
    def run(self, state: TrainerState | None = None, resume: bool = True):
        """Train to ``total_steps`` from ``state`` (copied into the storage;
        fresh parameters when None), after resuming from the latest
        checkpoint when ``resume``. Returns (the final state, which is the
        trainer's storage, and the last step's metrics)."""
        state = (self.init_state() if state is None
                 else self._store(state.params, state.opt_state, state.step))
        if resume:
            state = self._maybe_restore(state)
        metrics = {}
        while state.step < self.cfg.total_steps:
            step = state.step
            if self.fail_at_step is not None and step == self.fail_at_step:
                self.fail_at_step = None  # fail once
                self.events.append(f"induced failure at step {step}")
                raise RuntimeError(f"induced node failure at step {step}")

            batch = self.data.batch_at(step)
            if self.cfg.accum_steps > 1:
                a = self.cfg.accum_steps
                batch = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                         for k, v in batch.items()}
            self._sync()
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(state.params, state.opt_state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            self.step_times.append(dt)

            # straggler watchdog
            if self._ewma is None:
                self._ewma = dt
            elif dt > self.cfg.straggler_factor * self._ewma and step > 2:
                msg = (f"straggler step {step}: {dt * 1e3:.1f}ms vs EWMA "
                       f"{self._ewma * 1e3:.1f}ms — checkpointing")
                self.events.append(msg)
                self.log("[watchdog] " + msg)
                self._save(TrainerState(params, opt_state, step + 1))
            else:
                self._ewma = self.cfg.ewma_alpha * dt + (1 - self.cfg.ewma_alpha) * self._ewma

            state = TrainerState(params=params, opt_state=opt_state, step=step + 1)
            if state.step % self.cfg.ckpt_every == 0:
                self._save(state)
            if step % self.cfg.log_every == 0:
                self.log(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                         f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")
        self._save(state, blocking=True)
        return state, metrics
