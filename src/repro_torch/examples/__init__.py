"""The system's entry points on the port, one module each, named after the
JAX package's scripts in ``examples/``:

* ``serve_decode`` — continuous-batching serving (fixed batch or open
  loop; int8 KV, the paged pool, speculation, chunked prefill, a decode
  plan advised by Aira, the online adviser, the flight recorder, a mesh);
* ``train_smollm`` — smollm-135m training with checkpoint/restart;
* ``quickstart`` — the Aira pipeline on one benchmark, then the
  granularity band;
* ``parallelize_with_aira`` — Aira on a user's own region, and plan reuse.

Each runs as ``python -m repro_torch.examples.<name> …`` and exposes
``main(argv=None, *, device=None, **hooks) -> dict``: it prints the JAX
script's report lines in the same format and returns what it printed as
data. Each runs on CUDA unless ``--device cpu`` (or ``device="cpu"``) is
given; without a card it exits non-zero with ``resolve_device``'s message.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch import resolve_device


def device_or_exit(device) -> torch.device:
    """``resolve_device(device)``, its refusal (no card, and no CPU asked
    for) turned into an exit with its message."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def write_record(path: str | None, record: dict, skip=()) -> None:
    """``record`` (less the keys in ``skip``) as JSON at ``path``, if given."""
    if path:
        with open(path, "w") as f:
            json.dump(_jsonable({k: v for k, v in record.items() if k not in skip}), f)
