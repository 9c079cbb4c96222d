"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only per the assignment: the EnCodec frontend is a stub —
input_specs() provides precomputed frame embeddings (B, S, d_model); the
head predicts the 2048-entry codebook. Plain (non-GLU) GELU MLP at 4x,
matching the MusicGen transformer.

A copy of the reference's configs/musicgen_medium.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    layer_pattern=("global",),
    act="gelu",
    mlp_type="plain",
    embed_input=False,  # frame embeddings come from the stub frontend
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=256
    )
