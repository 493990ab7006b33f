"""Mistral-Large-2407 123B (hf mistralai/Mistral-Large-Instruct-2407,
unverified tier): deep dense GQA transformer."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
    kv_heads=8, head_dim=128, d_ff=28672, vocab=32768,
    rope_theta=1e6, tie_embeddings=False, dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="mistral-large-123b-smoke", n_layers=3, d_model=64, n_heads=8,
    kv_heads=2, head_dim=8, d_ff=160, vocab=256, tie_embeddings=False,
    dtype="float32",
)
