"""qwen2.5-14b [hf:Qwen] — dense GQA (40 query heads over 8 kv heads) with
bias on the q, k and v projections (the reference's
``repro.configs.qwen2_5_14b``; like the reference it keeps the default
``rope_theta`` and tied embeddings)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, qkv_bias=True, mlp_act="silu",
    attn_shard="seq",
)

REDUCED = ModelConfig(
    name="qwen2.5-14b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, qkv_bias=True, mlp_act="silu", attn_shard="seq",
    q_chunk=16, logit_chunk=16,
)
