"""Model and run configuration dataclasses; a copy of the reference's
configs/base.py (ModelConfig, ShapeConfig and the SHAPES cells).

One `ModelConfig` instance per architecture lives in
`repro_torch/configs/<id>.py` with the published dimensions, plus a
`smoke()` reduction of the same family for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int  # query heads; 0 for attention-free stacks
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- attention flavor ---
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None  # gemma2 attn logit soft-capping
    final_softcap: Optional[float] = None  # gemma2 final logit soft-capping
    qk_norm: bool = False  # gemma3 RMS-norms q and k instead of softcap
    layer_pattern: Tuple[str, ...] = ("global",)
    #   cycled over layers; entries: 'global' | 'local' | 'cross' | 'ssm'
    #   | 'ssm_shared_attn' (zamba2: ssm block + shared attn applied after)
    window: int = 4096  # sliding window for 'local'
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None  # gemma3 uses 10k local / 1M global
    sandwich_norm: bool = False  # gemma2/3 pre+post block norms
    scale_embedding: bool = False  # gemma family: embed * sqrt(d_model)
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # --- MLP ---
    act: str = "silu"  # silu | gelu
    mlp_type: str = "glu"  # glu | plain
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2): shared attention block params ---
    shared_attn_heads: int = 0
    shared_attn_kv_heads: int = 0
    shared_attn_d_ff: int = 0

    # --- vlm ---
    n_image_tokens: int = 0  # stub vision frontend sequence length

    # --- audio ---
    embed_input: bool = True  # False: inputs are precomputed embeddings

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.pattern_period == 0, (
            self.name,
            self.n_layers,
            self.layer_pattern,
        )
        return self.n_layers // self.pattern_period

    @property
    def attn_free(self) -> bool:
        return all(t == "ssm" for t in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k per the assignment: SSM and hybrid stacks
        qualify; any per-layer 'global' full-attention disqualifies (the
        zamba2 hybrid's few shared-attention applications qualify)."""
        return all(t in ("ssm", "local", "ssm_shared_attn") for t in self.layer_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline numbers)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_
        n = 0
        if self.embed_input:
            n += v * d
        if not self.tie_embeddings:
            n += v * d
        per_layer = {}
        for kind in self.layer_pattern:
            if kind in ("global", "local", "cross"):
                qkv = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads
                if self.qkv_bias:
                    qkv += hd * (self.n_heads + 2 * self.n_kv_heads)
                o = hd * self.n_heads * d
                if self.n_experts:
                    mlp = self.n_experts * 3 * d * ff + d * self.n_experts
                else:
                    mlp = (3 if self.mlp_type == "glu" else 2) * d * ff
                per_layer[kind] = qkv + o + mlp + 2 * d
            elif kind in ("ssm", "ssm_shared_attn"):
                d_in = self.ssm_expand * d
                nh = d_in // self.ssm_head_dim
                g = 1
                proj_in = d * (2 * d_in + 2 * g * self.ssm_state + nh)
                conv = self.ssm_conv * (d_in + 2 * g * self.ssm_state)
                proj_out = d_in * d
                per_layer[kind] = proj_in + conv + proj_out + 2 * nh + 2 * d + d_in
        n += sum(per_layer[kind] for kind in self.layer_pattern) * self.n_groups
        if self.shared_attn_heads:
            hd2 = self.d_model // self.shared_attn_heads
            n += (
                self.d_model * hd2 * (self.shared_attn_heads + 2 * self.shared_attn_kv_heads)
                + hd2 * self.shared_attn_heads * self.d_model
                + 3 * self.d_model * self.shared_attn_d_ff
                + 2 * self.d_model
            )
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive_per_moe_layer = (self.n_experts - self.top_k) * 3 * d * ff
        n_moe_layers = (
            sum(1 for k in self.layer_pattern if k in ("global", "local")) * self.n_groups
        )
        return full - inactive_per_moe_layer * n_moe_layers


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
