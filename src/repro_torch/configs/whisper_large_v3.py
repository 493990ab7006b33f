"""Whisper-large-v3 (arXiv:2212.04356, unverified tier): encoder-decoder,
32+32 layers, d=1280, 20 heads, LayerNorm+GELU, QKV bias.  The conv/mel
frontend is a STUB: input_specs() provides precomputed frame embeddings
(1500 frames, the post-conv length).  Sinusoidal positions stand in for the
learned decoder positions (frontend-stub simplification, DESIGN.md)."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3", family="encdec", n_layers=32, encoder_layers=32,
    d_model=1280, n_heads=20, kv_heads=20, head_dim=64, d_ff=5120,
    vocab=51866, qkv_bias=True, encoder_seq=1500,
    tie_embeddings=True, dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="whisper-large-v3-smoke", family="encdec", n_layers=2,
    encoder_layers=2, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
    d_ff=160, vocab=256, qkv_bias=True, encoder_seq=32,
    tie_embeddings=True, dtype="float32",
)
