"""starcoder2-3b [arXiv:2402.19173] — dense decoder, GQA kv=2, RoPE.

30L, d_model=3072, 24 q heads / 2 kv heads, head_dim=128, d_ff=12288 (4d,
non-gated GELU MLP), vocab=49152, LayerNorm, attention bias.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_3b", family="dense",
        num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
        head_dim=128, d_ff=12288, vocab_size=49152,
        norm="layernorm", act="gelu", glu=False, qkv_bias=True,
        rope=True, rope_theta=1e5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2_3b_smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        norm="layernorm", act="gelu", glu=False, qkv_bias=True,
        rope=True, rope_theta=1e5,
    )
