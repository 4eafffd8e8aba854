"""whisper-small [arXiv:2212.04356] — enc-dec audio transformer backbone.

12L encoder + 12L decoder, d_model=768, 12 heads (MHA), d_ff=3072,
vocab=51865. Conv frontend is a STUB: ``input_specs`` provides precomputed
frame embeddings (B, frames, d_model). Whisper uses pre-LN LayerNorm, GELU,
non-gated MLP, learned positions in the decoder (no RoPE).
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper_small", family="encdec",
        num_layers=24, enc_layers=12, dec_layers=12,
        d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=51865,
        norm="layernorm", act="gelu", glu=False, rope=False,
        learned_pos=True, qkv_bias=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper_small_smoke", family="encdec",
        num_layers=4, enc_layers=2, dec_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        norm="layernorm", act="gelu", glu=False, rope=False,
        learned_pos=True, qkv_bias=True,
    )
