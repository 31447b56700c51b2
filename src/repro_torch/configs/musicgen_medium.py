"""musicgen-medium [arXiv:2306.05284; hf] — a decoder-only transformer
over EnCodec tokens (vocab 2048): 48 layers, d_model 1536, 24 MHA heads of
64, a gelu MLP of 6144, tied embeddings (the reference's
``repro.configs.musicgen_medium``). The EnCodec frontend and its delay
pattern are a stub, as in the reference: the model takes the flattened
codebook token ids. It is the dense layer under another name, served by
the paged engine and the legacy loop alike."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, mlp_act="gelu", attn_shard="seq",
)

REDUCED = ModelConfig(
    name="musicgen-medium-reduced", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=128, mlp_act="gelu", attn_shard="seq",
    q_chunk=16, logit_chunk=16,
)
