"""granite-3-8b [hf:ibm-granite] — dense GQA decoder (kv=8), head_dim 128,
SwiGLU, vocab 49155 padded to 49408 (the reference's
``repro.configs.granite_3_8b``)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155, mlp_act="silu", attn_shard="heads",
)

REDUCED = ModelConfig(
    name="granite-3-8b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, mlp_act="silu", attn_shard="heads",
    q_chunk=16, logit_chunk=16,
)
