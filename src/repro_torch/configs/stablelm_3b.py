"""stablelm-3b [dense].

32L d_model=2560 32H (GQA kv=32 → MHA) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b; unverified]. Vocab padded 50304→50432.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        train_accum=8,
        kv_quant=True,
        param_sharding="tp",
    )
)
