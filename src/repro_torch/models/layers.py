"""Shared layer primitives: RMSNorm, RoPE, the GLU and plain MLPs,
embeddings, soft-capping; the PyTorch port of the reference's
models/layers.py.

Reductions that are sensitive to precision run in float32; weights and
activations stay in the config's dtype (bfloat16 by default).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import ctx as dist_ctx


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 accumulation and the (1 + scale)
    parameterization."""
    xf = x.float()
    if hasattr(xf, "device_mesh"):
        # A DTensor whose last dim may shard over 'model' (the SSM's
        # d_inner): a partial sum, all-reduced, then the division.
        var = dist_ctx.whole_on_model(torch.sum(xf * xf, dim=-1, keepdim=True)) / x.shape[-1]
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return logits
    return (torch.tanh(logits.float() / cap) * cap).to(logits.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # A Python scalar base: a tensor made from theta on the card would be a
    # host-to-device copy, which waits for the stream at every layer.
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, d_head), positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions[..., :, None, None].float() * freqs  # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def mlp_glu(x, wi_gate, wi_up, wo, act: str):
    """SwiGLU / GeGLU: (act(x @ gate) * (x @ up)) @ wo."""
    return (activation(x @ wi_gate, act) * (x @ wi_up)) @ wo


def mlp_plain(x, wi, wo, act: str):
    """The plain MLP: act(x @ wi) @ wo."""
    return activation(x @ wi, act) @ wo


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool) -> torch.Tensor:
    """Token embedding lookup; the gemma family scales by sqrt(d_model)."""
    # A DTensor table (sharded over the vocabulary) takes F.embedding, which
    # DTensor partitions; the single-device path indexes, as it did.
    x = F.embedding(tokens, table) if hasattr(table, "device_mesh") else table[tokens]
    if scale:
        # sqrt(d_model) rounded to the table's dtype, as the reference does,
        # and kept on the host (no copy to the card).
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=x.dtype).item()
    return x


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, tied: bool) -> torch.Tensor:
    if tied:
        return x @ table_or_head.T
    return x @ table_or_head
