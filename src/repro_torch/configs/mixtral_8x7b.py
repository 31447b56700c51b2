"""mixtral-8x7b [arXiv:2401.04088; hf] — 8-expert top-2 MoE (d_ff 14336
per expert) with sliding-window attention (W 4096), GQA (32 query heads,
8 KV heads of 128), rope θ 1e6, vocab 32000, tied embeddings (the
reference's ``repro.configs.mixtral_8x7b``). The legacy loop serves it on
a ring KV cache of the window's rows; the paged engine rejects windows, as
the reference's does."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, n_experts=8, top_k=2,
    window=4096, mlp_act="silu", rope_theta=1e6, attn_shard="heads",
)

REDUCED = ModelConfig(
    name="mixtral-8x7b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, n_experts=4, top_k=2,
    window=32, mlp_act="silu", attn_shard="heads", q_chunk=16, logit_chunk=16,
)
