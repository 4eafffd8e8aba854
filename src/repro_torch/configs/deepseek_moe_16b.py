"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE, 2 shared + 64
routed experts top-6.

28L (first layer dense FFN d_ff=10944), d_model=2048, 16 heads MHA (kv=16),
head_dim=128, per-expert d_ff=1408, vocab=102400, SwiGLU, RMSNorm, RoPE.
The MoE dispatch is the flagship *parcel* user (DESIGN.md P4): tokens are
active messages routed to expert localities.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_moe_16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=102400,
        n_experts=64, n_shared_experts=2, top_k=6, first_dense=1,
        dense_d_ff=10944, rope=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_moe_16b_smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=32, vocab_size=512,
        n_experts=8, n_shared_experts=2, top_k=2, first_dense=1,
        dense_d_ff=128, rope=True,
    )
