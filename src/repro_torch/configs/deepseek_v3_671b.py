"""DeepSeek-V3 671B (arXiv:2412.19437).  MLA attention (q_lora 1536,
kv_lora 512, qk 128+64 rope, v 128); 1 shared + 256 routed top-8 experts,
first 3 layers dense (official dense d_ff=18432, expert d_ff=2048);
multi-token prediction head."""
from repro_torch.models.lm import ModelConfig

FULL = ModelConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
    kv_heads=128, head_dim=128, d_ff=18432, vocab=129280,
    attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=256, top_k=8, d_ff_expert=2048, n_shared_experts=1,
    first_k_dense=3, mtp=True, rope_theta=1e4, tie_embeddings=False,
    dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="deepseek-v3-671b-smoke", n_layers=4, d_model=64, n_heads=4,
    kv_heads=4, head_dim=16, d_ff=160, vocab=256,
    attn_type="mla", q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
    first_k_dense=1, mtp=True, tie_embeddings=False, dtype="float32",
)
