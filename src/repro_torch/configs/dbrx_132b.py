"""dbrx-132b [moe]: fine-grained MoE, 16 experts top-4.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352
[hf:databricks/dbrx-base; unverified]. EP: one expert per model shard.
Largest assigned model → FSDP parameter sharding over the data axis.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        n_experts=16,
        top_k=4,
        train_accum=16,
        remat="full",
        param_sharding="fsdp",
    )
)
