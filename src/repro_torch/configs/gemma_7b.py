"""gemma-7b [arXiv:2403.08295; hf] — GeGLU MLP, head_dim=256, 16 MHA heads,
256k vocabulary (the reference's ``repro.configs.gemma_7b``)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, mlp_act="gelu", attn_shard="heads",
)

REDUCED = ModelConfig(
    name="gemma-7b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, mlp_act="gelu", attn_shard="heads",
    q_chunk=16, logit_chunk=16,
)
