"""End-to-end training: smollm-135m on synthetic data for a few
hundred steps with checkpoint/restart fault tolerance — the counterpart of
the JAX package's ``examples/train_smollm.py``, with its flags.

  python -m repro_torch.examples.train_smollm [--steps 300] [--full]

The default is the width-reduced config (minutes on a CPU); ``--full`` is
the real 135M config. A run resumes from the newest checkpoint in
``--ckpt`` (every 50 steps), so a run that was killed and started again
over the same directory continues where the checkpoint left it, and ends
on the loss the uninterrupted run ends on, bit for bit: the steps run
under ``torch.use_deterministic_algorithms`` (warn-only; cuBLAS gets a
fixed workspace), and the restored state is the saved one exactly.

Where it differs from the JAX script: ``--device`` (CUDA by default,
``cpu`` for the plain path; without a card and without ``--device cpu``
it exits non-zero); the default ``--ckpt`` is a directory of its own,
``/tmp/repro_torch_smollm_ckpt`` (the two packages' checkpoints differ in
format); the weights are ``Model.init(seed=0)``'s and the batches
``SyntheticLMData``'s torch draw, not ``jax.random``'s; on the card the
step is one captured CUDA graph (``compiled_train_step``); ``--record
PATH`` writes the run's losses, step times and restore events as JSON.
"""
from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from repro_torch.examples import add_device_flag, device_or_exit, write_record


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_smollm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="real 135M config")
    ap.add_argument("--ckpt", default="/tmp/repro_torch_smollm_ckpt")
    add_device_flag(ap)
    ap.add_argument("--record", metavar="PATH", default=None,
                    help="write the run's losses, step times and events as JSON")
    return ap


def main(argv=None, *, device=None, params=None, data=None, fail_at_step=None) -> dict:
    """Parse ``argv``, train (resuming from ``--ckpt``), print the JAX
    script's closing line and return the run as data. Hooks: ``params``
    (initial weights in place of ``Model.init(seed=0)``, e.g. the JAX
    package's through ``Model.params_from_reference``), ``data`` (an
    object with ``batch_at(step)``, in place of ``SyntheticLMData``) and
    ``fail_at_step`` (the trainer's induced failure: the run raises at
    that step, after the checkpoints before it are published)."""
    args = build_parser().parse_args(argv)
    dev = device_or_exit(device if device is not None else args.device)
    if dev.type == "cuda":
        # cuBLAS reads it when it makes its first handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.model import Model
    from repro_torch.train import AdamW, Trainer, TrainerConfig
    from repro_torch.train.trainer import TrainerState
    from repro_torch.tree import map_tree

    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = cfg.reduced()
    model = Model(cfg, dev)
    if data is None:
        data = SyntheticLMData(cfg, batch=args.batch, seq=args.seq, device=dev)
    opt = AdamW(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=50, ckpt_dir=args.ckpt, log_every=20)
    trainer = Trainer(model, opt, data, tc, fail_at_step=fail_at_step)
    losses, step_fn = [], trainer.step_fn

    def step(*a):
        out = step_fn(*a)
        losses.append(out[2]["loss"])  # the graph's outputs are copies
        return out

    trainer.step_fn = step
    state = None
    if params is not None:
        params = map_tree(lambda t: t.to(dev), params)
        state = TrainerState(params=params, opt_state=opt.init(params))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            state, metrics = trainer.run(state)  # resumes automatically if interrupted
        finally:
            torch.use_deterministic_algorithms(False)
            trainer.ckpt.wait()  # a save in flight is published before we leave
    loss = float(metrics["loss"]) if metrics else None
    print(f"done: step {state.step}, loss "
          + ("n/a (nothing left to run)" if loss is None else f"{loss:.4f}")
          + f" (checkpoints in {args.ckpt})")
    times = np.asarray(trainer.step_times[1:] or trainer.step_times, np.float64)
    record = {
        "step": state.step, "loss": loss, "losses": [float(x) for x in losses],
        "first_step": state.step - len(losses), "events": trainer.events,
        "step_ms_p50": float(np.median(times) * 1e3) if times.size else None,
        "tokens_per_s": (float(args.batch * args.seq / np.median(times))
                         if times.size else None),
        "nondeterministic": sorted({str(w.message).splitlines()[0] for w in caught
                                    if "deterministic" in str(w.message)}),
        "state": state,
    }
    write_record(args.record, record, skip=("state",))
    return record


if __name__ == "__main__":
    main()
