"""internvl2-2b [arXiv:2404.16821] — VLM: InternViT frontend + InternLM2 LM.

LM backbone only (the assignment): 24L, d_model=2048, 16 q heads / 8 kv
heads, head_dim=128, d_ff=8192, vocab=92553, SwiGLU, RMSNorm, RoPE.  The
InternViT frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings (B, 256, d_model) that replace the first 256 token positions.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2_2b", family="vlm",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=92553,
        n_patches=256, rope=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2_2b_smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        n_patches=8, rope=True,
    )
