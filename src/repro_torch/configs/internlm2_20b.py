"""internlm2-20b [dense]: GQA.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544
[arXiv:2403.17297; hf]. FSDP parameter sharding (20B params).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internlm2-20b",
        family="dense",
        num_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        train_accum=32,
        remat="full",
        param_sharding="fsdp",
    )
)
