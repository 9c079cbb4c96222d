"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
ssm_state=64 vocab=32000; Mamba2 backbone + shared full-attention block
applied every 6th layer (9 applications, shared weights, per-application
KV caches). [arXiv:2411.15242; hf]

The real Zamba2 concatenates the original embedding into the shared block
and adds per-application LoRAs; both omitted (assignment dims only, noted
in DESIGN.md).

A copy of the reference's configs/zamba2_2_7b.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    layer_pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "ssm_shared_attn"),
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_heads=32,
    shared_attn_kv_heads=32,
    shared_attn_d_ff=10240,
    act="gelu",
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, ssm_state=16, ssm_head_dim=16,
        shared_attn_heads=4, shared_attn_kv_heads=4, shared_attn_d_ff=128,
        ssm_chunk=32,
    )
