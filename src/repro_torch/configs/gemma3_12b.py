"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144; 5:1 local:global interleave (window 1024), QK-norm, dual RoPE
bases (10k local / 1M global), 128k context. [hf:google/gemma-3 family;
unverified]

A copy of the reference's configs/gemma3_12b.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    qk_norm=True,
    sandwich_norm=True,
    scale_embedding=True,
    tie_embeddings=True,
    act="gelu",
    rope_theta=1000000.0,
    rope_theta_local=10000.0,
    attn_scale=1.0 / 16.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, head_dim=16, window=16, attn_scale=0.25,
    )
