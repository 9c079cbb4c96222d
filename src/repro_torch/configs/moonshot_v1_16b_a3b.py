"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (kv=16, MHA) d_ff=1408
(per expert, DeepSeek-style fine-grained), vocab=163840, MoE 64 experts
top-6. [hf:moonshotai/Moonlight-16B-A3B; hf]

Assignment dims kept exactly; Moonlight's shared experts / first dense
layer are not in the assignment spec and are omitted (noted in DESIGN.md
§Arch-applicability).

A copy of the reference's configs/moonshot_v1_16b_a3b.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    layer_pattern=("global",),
    n_experts=64,
    top_k=6,
    capacity_factor=1.25,
    act="silu",
    rope_theta=50000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=512, n_experts=8, top_k=2,
    )
