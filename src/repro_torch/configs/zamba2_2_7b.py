"""zamba2-2.7b [arXiv:2411.15242] — hybrid: 54 Mamba2 layers with one
SHARED full-attention block (MHA, 32 heads of 80, gelu MLP of 10240)
applied after every 9 of them, 6 applications (the reference's
``repro.configs.zamba2_2_7b``, which collapses the published model's two
alternating shared blocks into one); vocab 32000, tied embeddings. Decode
is the O(1) Mamba2 recurrence plus one ring-buffer KV cache per
application of the shared block."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, ssm_state=64, ssm_head_dim=64,
    shared_attn_every=9, mlp_act="gelu", attn_shard="heads",
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16,
    shared_attn_every=2, mlp_act="gelu", attn_shard="heads",
    q_chunk=16, logit_chunk=16,
)
