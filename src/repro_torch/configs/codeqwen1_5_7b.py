"""CodeQwen1.5-7B (hf Qwen/CodeQwen1.5-7B): qwen1.5-arch dense MHA (kv=heads)."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32, kv_heads=32,
    head_dim=128, d_ff=13440, vocab=92416, qkv_bias=True,
    rope_theta=1e6, tie_embeddings=False, dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="codeqwen1.5-7b-smoke", n_layers=3, d_model=64, n_heads=4, kv_heads=4,
    head_dim=16, d_ff=160, vocab=256, qkv_bias=True, tie_embeddings=False,
    dtype="float32",
)
