"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400,
16 experts top-2, vocab=32064. [hf:microsoft/Phi-3.5-MoE-instruct; hf]

A copy of the reference's configs/phi3_5_moe_42b_a6_6b.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    layer_pattern=("global",),
    n_experts=16,
    top_k=2,
    capacity_factor=1.25,
    act="silu",
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
        vocab_size=512, n_experts=4, top_k=2,
    )
