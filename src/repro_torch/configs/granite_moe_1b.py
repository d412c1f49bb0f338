"""granite-moe-1b-a400m [moe]: 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]. Vocab padded 49155→49408.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        n_experts=32,
        top_k=8,
        tie_embeddings=True,
        train_accum=4,
        param_sharding="tp",
    )
)
