"""phi3-medium-14b [dense]: RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified]. 40 heads ∤ 16 → sequence-parallel attention;
FSDP parameter sharding (14B params).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        train_accum=8,
        remat="full",
        param_sharding="fsdp",
    )
)
