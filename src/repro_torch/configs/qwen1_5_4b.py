"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912
vocab=151936; QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]

A copy of the reference's configs/qwen1_5_4b.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    layer_pattern=("global",),
    qkv_bias=True,
    act="silu",
    rope_theta=5000000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512
    )
