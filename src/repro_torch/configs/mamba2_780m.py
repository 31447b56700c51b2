"""mamba2-780m [arXiv:2405.21060] — attention-free SSD stack (the
reference's ``repro.configs.mamba2_780m``): d_inner 3072 (expand 2), 48 SSM
heads of dim 64, state 128, conv_dim 3328; vocab 50280 padded to 50432,
tied embeddings. Decode is the O(1) recurrence on a (conv, ssm) cache; there
is no KV cache to quantize."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=0, vocab_size=50280, ssm_state=128, ssm_head_dim=64,
    attn_shard="none",
)

REDUCED = ModelConfig(
    name="mamba2-780m-reduced", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=256, ssm_state=16, ssm_head_dim=16,
    attn_shard="none", q_chunk=16, logit_chunk=16,
)
