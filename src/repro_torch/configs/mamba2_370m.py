"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060;
unverified]. d_inner = 2 * d_model = 2048 in 32 SSD heads of head dim 64,
one group (B/C shared across heads). Served on the slot layout only: the
recurrent state has no sequence axis to page.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        sub_quadratic=True,
        tie_embeddings=True,
        train_accum=4,
        param_sharding="tp",
    )
)
