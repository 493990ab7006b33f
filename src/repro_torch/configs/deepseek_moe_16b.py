"""DeepSeekMoE-16B (arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base).
Fine-grained MoE: 64 routed experts top-6 + 2 shared experts; first layer
dense (official dense d_ff=10944, expert d_ff=1408 as in the assignment)."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    kv_heads=16, head_dim=128, d_ff=10944, vocab=102400,
    n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2,
    first_k_dense=1, rope_theta=1e4, tie_embeddings=False,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="deepseek-moe-16b-smoke", n_layers=3, d_model=64, n_heads=4,
    kv_heads=4, head_dim=16, d_ff=160, vocab=256,
    n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=2,
    first_k_dense=1, tie_embeddings=False, dtype="float32",
)
