from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: F401
