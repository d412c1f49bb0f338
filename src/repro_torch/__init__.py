"""PyTorch/CUDA port of the JAX package ``repro`` (the reference, which
every module is held against): serving, the adviser and training.
Imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro``. Entry points run on CUDA unless the caller asks for
``device="cpu"``."""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default. Asking for
    CUDA on a machine without it raises — the port never carries on
    quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
