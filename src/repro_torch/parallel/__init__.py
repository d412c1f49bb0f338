"""Sharding rules and collectives for a mesh of ranks (one process a rank,
over ``torch.distributed``): serving, data-parallel training, gradient
compression and the 2-stage pipeline."""
from repro_torch.parallel.sharding import ShardingRules  # noqa: F401
