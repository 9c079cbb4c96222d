"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer (8 total), gated
residuals. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Backbone only: the vision tower is a stub — input_specs() provides
precomputed vision states (B, n_image_tokens, d_model).

A copy of the reference's configs/llama3_2_vision_11b.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=("global", "global", "global", "global", "cross"),
    n_image_tokens=1601,  # 1 tile x (40x40 patches + 1 CLS)
    act="silu",
    rope_theta=500000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, n_image_tokens=17,
    )
