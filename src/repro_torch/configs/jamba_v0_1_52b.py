"""Jamba-v0.1 52B (arXiv:2403.19887): Mamba+attention 1:7 interleave
(1 attention layer per 8), MoE 16 experts top-2 on every other layer."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32, kv_heads=8,
    head_dim=128, d_ff=14336, vocab=65536,
    layer_pattern="jamba", n_experts=16, top_k=2, d_ff_expert=14336,
    mamba_d_state=16, mamba_expand=2, subquadratic=True,
    tie_embeddings=False, dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="jamba-v0.1-52b-smoke", n_layers=8, d_model=64, n_heads=4, kv_heads=2,
    head_dim=16, d_ff=160, vocab=256,
    layer_pattern="jamba", n_experts=4, top_k=2, d_ff_expert=160,
    mamba_d_state=4, mamba_expand=2, subquadratic=True,
    tie_embeddings=False, dtype="float32",
)
