"""starcoder2-15b [arXiv:2402.19173] — dense decoder, GQA kv=4, RoPE.

40L, d_model=6144, 48 q heads / 4 kv heads, head_dim=128, d_ff=24576 (4d,
non-gated GELU MLP), vocab=49152, LayerNorm, attention bias.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_15b", family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
        head_dim=128, d_ff=24576, vocab_size=49152,
        norm="layernorm", act="gelu", glu=False, qkv_bias=True,
        rope=True, rope_theta=1e5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_15b_smoke", family="dense",
        num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
        head_dim=16, d_ff=192, vocab_size=512,
        norm="layernorm", act="gelu", glu=False, qkv_bias=True,
        rope=True, rope_theta=1e5,
    )
