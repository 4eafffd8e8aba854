"""qwen2.5-3b [hf:Qwen/Qwen2.5 family] — dense decoder, GQA kv=2, QKV bias.

36L, d_model=2048, 16 q heads / 2 kv heads, head_dim=128, d_ff=11008,
vocab=151936, SwiGLU, RMSNorm, RoPE theta=1e6.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen25_3b", family="dense",
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        head_dim=128, d_ff=11008, vocab_size=151936,
        qkv_bias=True, rope=True, rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen25_3b_smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        qkv_bias=True, rope=True, rope_theta=1e6,
    )
