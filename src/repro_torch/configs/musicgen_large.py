"""musicgen-large [audio]: decoder-only LM over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32 → MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: ``input_specs``
supplies codec token ids (the decoder's native input).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        train_accum=8,
        kv_quant=True,
        param_sharding="tp",
    )
)
