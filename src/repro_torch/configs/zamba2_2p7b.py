"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]. One attention block with *shared weights* is applied
every 6th layer (per-site KV caches). Sub-quadratic → runs long_500k.
d_inner = 2 * d_model = 5120 in 80 SSD heads of head dim 64; the
attention heads have head dim 80 (g = 1). The KV cache is int8 with
bfloat16 per-vector scales (``kv_quant``). Served on the slot layout only:
the recurrent state has no sequence axis to page.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,  # used by the shared block's MLP
        vocab_size=32000,
        ssm_state=64,
        attn_every=6,
        sub_quadratic=True,
        kv_quant=True,
        tie_embeddings=True,
        train_accum=16,
        param_sharding="tp",
    )
)
