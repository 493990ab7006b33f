"""Qwen2-VL-7B (arXiv:2409.12191): dense GQA backbone with M-RoPE
(sections 16/24/24 of the 128-dim head, in half-dim units).  The vision
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings + 3-D position ids."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-7b", n_layers=28, d_model=3584, n_heads=28, kv_heads=4,
    head_dim=128, d_ff=18944, vocab=152064, qkv_bias=True,
    input_mode="embeds", mrope_sections=(16, 24, 24), rope_theta=1e6,
    tie_embeddings=False, dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="qwen2-vl-7b-smoke", n_layers=3, d_model=64, n_heads=4, kv_heads=2,
    head_dim=16, d_ff=160, vocab=256, qkv_bias=True,
    input_mode="embeds", mrope_sections=(2, 3, 3), tie_embeddings=False,
    dtype="float32",
)
