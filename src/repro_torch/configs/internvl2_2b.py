"""internvl2-2b [vlm]: InternViT + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
[arXiv:2404.16821; hf]. The InternViT frontend is a STUB: ``input_specs``
supplies precomputed patch embeddings (256 patches) that are projected and
prepended to the token embeddings. Vocab padded 92553→92672.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        n_frontend_tokens=256,
        train_accum=8,
        param_sharding="tp",
    )
)
