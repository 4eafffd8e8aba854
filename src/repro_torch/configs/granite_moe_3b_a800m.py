"""granite-moe-3b-a800m [hf:ibm-granite granite-3.0 MoE family] — 40 routed
experts, top-8, no shared experts.

32L, d_model=1536, 24 q heads / 8 kv heads, head_dim=64, per-expert
d_ff=512, vocab=49155, SwiGLU, RMSNorm, RoPE.

EP note (DESIGN.md §5): 40 experts do not divide the 16-way model axis, so
this arch uses TP-inside-expert (experts replicated, expert d_ff sharded)
— dispatch-time balance instead of expert-location balance.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite_moe_3b_a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49155,
        n_experts=40, n_shared_experts=0, top_k=8,
        rope=True, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite_moe_3b_a800m_smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=512,
        n_experts=5, n_shared_experts=0, top_k=2,
        rope=True, tie_embeddings=True,
    )
