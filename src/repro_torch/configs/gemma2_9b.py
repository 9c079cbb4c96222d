"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local+global alternating sliding window, attn+final logit
softcap, sandwich norms, head_dim 256. [arXiv:2408.00118; hf]

A copy of the reference's configs/gemma2_9b.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    scale_embedding=True,
    tie_embeddings=True,
    act="gelu",
    rope_theta=10000.0,
    attn_scale=1.0 / 16.0,  # query_pre_attn_scalar = 256 = head_dim
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16, window=32, attn_scale=0.25,
    )
