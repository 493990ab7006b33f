"""RWKV-6 (Finch) 7B (arXiv:2404.05892): attention-free, data-dependent
decay linear recurrence; head_dim 64 (64 heads at d=4096); channel-mix FFN."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="rwkv6-7b", n_layers=32, d_model=4096, n_heads=64, kv_heads=64,
    head_dim=64, d_ff=14336, vocab=65536, layer_pattern="rwkv",
    subquadratic=True, rwkv_chunk=128, tie_embeddings=False, dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="rwkv6-7b-smoke", n_layers=2, d_model=128, n_heads=2, kv_heads=2,
    head_dim=64, d_ff=256, vocab=256, layer_pattern="rwkv",
    subquadratic=True, rwkv_chunk=8, tie_embeddings=False, dtype="float32",
)
