"""llama-3.2-vision-11b [hf:meta-llama; unverified] — the text backbone
(40 self-attention layers, GQA with 32 query heads and 8 KV heads of 128,
rope θ 5e5, vocab 128256, tied embeddings) with a cross-attention block
over the vision tokens after every 5 layers, 8 in all (the reference's
``repro.configs.llama_3_2_vision_11b``). The vision tower is a stub, as in
the reference: the model takes precomputed patch embeddings (B, 4096,
d_model). The legacy loop serves it; the paged engine rejects it, as the
reference's does."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, cross_attn_every=5, n_vis_tokens=4096,
    mlp_act="silu", rope_theta=5e5, attn_shard="heads",
)

REDUCED = ModelConfig(
    name="llama-3.2-vision-11b-reduced", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, cross_attn_every=2, n_vis_tokens=16,
    mlp_act="silu", attn_shard="heads", q_chunk=16, logit_chunk=16,
)
