"""Sharding rules and collectives for serving on a mesh of ranks (one
process a rank, over ``torch.distributed``)."""
from repro_torch.parallel.sharding import ShardingRules  # noqa: F401
