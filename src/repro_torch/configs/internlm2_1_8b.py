"""InternLM2-1.8B (arXiv:2403.17297): dense GQA transformer."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16, kv_heads=8,
    head_dim=128, d_ff=8192, vocab=92544, rope_theta=1e6,
    tie_embeddings=False, dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="internlm2-1.8b-smoke", n_layers=3, d_model=64, n_heads=4, kv_heads=2,
    head_dim=16, d_ff=160, vocab=256, tie_embeddings=False, dtype="float32",
)
