"""mamba2-780m [arXiv:2405.21060] — attention-free SSD (state-space duality).

48 layers, d_model=1536, d_inner=2*d=3072, headdim=64 (48 SSD heads),
d_state=128, vocab=50280. Pure SSM: runs the long_500k cell (O(1) decode
state).
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50280, rope=False, glu=False,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
        ssm_ngroups=1, ssm_conv=4, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_780m_smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=512, rope=False, glu=False,
        ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=32,
        ssm_ngroups=1, ssm_conv=4, tie_embeddings=True,
    )
