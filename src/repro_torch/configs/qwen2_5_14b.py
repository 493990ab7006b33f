"""Qwen2.5-14B (hf Qwen/Qwen2.5-14B): dense GQA transformer with QKV bias."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40, kv_heads=8,
    head_dim=128, d_ff=13824, vocab=152064, qkv_bias=True,
    rope_theta=1e6, tie_embeddings=False, dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="qwen2.5-14b-smoke", n_layers=3, d_model=64, n_heads=4, kv_heads=2,
    head_dim=16, d_ff=160, vocab=256, qkv_bias=True, tie_embeddings=False,
    dtype="float32",
)
