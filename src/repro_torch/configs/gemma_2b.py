"""gemma-2b [arXiv:2403.08295; hf] — MQA (kv=1), GeGLU, head_dim=256, 256k
vocab (the reference's ``repro.configs.gemma_2b``)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, mlp_act="gelu", attn_shard="seq",
)

REDUCED = ModelConfig(
    name="gemma-2b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, mlp_act="gelu", attn_shard="seq",
    q_chunk=16, logit_chunk=16,
)
