"""smollm-135m [dense]: llama-arch small.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]. 9 heads ∤ 16 → attention head-TP
inapplicable; sharding falls back to sequence parallelism (DESIGN.md §6.1).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
        train_accum=2,
        param_sharding="tp",
    )
)
