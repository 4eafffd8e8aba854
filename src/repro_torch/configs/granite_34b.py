"""granite-34b [arXiv:2405.04324] — llama-arch code model, MQA (kv=1), 88L.

d_model=6144, 48 q heads / 1 kv head, head_dim=128, d_ff=24576,
vocab=49152, SwiGLU, RMSNorm, RoPE.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite_34b", family="dense",
        num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
        head_dim=128, d_ff=24576, vocab_size=49152,
        rope=True, rope_theta=1e5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite_34b_smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512,
        rope=True, rope_theta=1e5,
    )
