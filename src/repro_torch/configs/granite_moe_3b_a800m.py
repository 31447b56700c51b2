"""granite-moe-3b-a800m [hf:ibm-granite] — 40-expert top-8 fine-grained MoE
(d_ff 512 per expert), GQA (24 query heads, 8 KV heads of 64), vocab
49155 padded to 49408, tied embeddings, no window (the reference's
``repro.configs.granite_moe_3b_a800m``)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, n_experts=40, top_k=8,
    mlp_act="silu", attn_shard="seq",
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, n_experts=8, top_k=4,
    mlp_act="silu", attn_shard="seq", q_chunk=16, logit_chunk=16,
)
