"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544; llama-style GQA + SwiGLU. [arXiv:2403.17297; hf]

A copy of the reference's configs/internlm2_20b.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    layer_pattern=("global",),
    act="silu",
    rope_theta=1000000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab_size=512
    )
