"""recurrentgemma-2b [arXiv:2402.19427 Griffin] — hybrid RG-LRU + local attn.

26 layers in pattern (rec, rec, attn): 8 full groups of 3 + 2 trailing rec
layers. d_model=2560, lru_width=2560, 10 q heads / 1 kv head (MQA),
head_dim=256, d_ff=7680 (GeGLU), vocab=256000, local attention window 2048.
Sub-quadratic: runs the long_500k cell (recurrent state + 2048-window KV).
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        act="gelu", glu=True, rope=True, rope_theta=1e4,
        window=2048, block_pattern=("rec", "rec", "attn"),
        lru_width=2560, ssm_conv=4, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_2b_smoke", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512,
        act="gelu", glu=True, rope=True,
        window=32, block_pattern=("rec", "rec", "attn"),
        lru_width=64, ssm_conv=4, tie_embeddings=True,
    )
