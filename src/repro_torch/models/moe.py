"""Mixture-of-Experts FFN with sort-based capacity dispatch; the PyTorch
port of the reference's models/moe.py on one device.

Each token's router picks its top_k experts; a scatter builds the
(E, C, D) expert buffer (C the per-expert capacity), the expert GLU runs
as batched products over every expert, and a scatter-add combines the
outputs back, weighted by the renormalised gates. A token past its
expert's capacity is dropped from that expert (GShard semantics): which
ones drop is fixed by a stable sort of the flat expert ids, as in the
reference. The router's Switch-style aux loss keeps the load balanced in
training.

The reference's expert-parallel mesh path (its shard_map over the
'model' axis) and its sharding constraints are left out: the port has
one GPU and no mesh.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .layers import activation


def init_moe_params(normal, n_layers: int, d_model: int, d_ff: int, n_experts: int,
                    dtype: torch.dtype) -> dict:
    """The reference's MoE leaves, stacked over ``n_layers``: the router in
    float32, the experts' gate, up and down projections in ``dtype``.
    ``normal(shape, std, dtype)`` draws a seeded leaf."""
    std_in, std_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    n, e = n_layers, n_experts
    return {"router": normal((n, d_model, e), std_in, torch.float32),
            "wi_gate": normal((n, e, d_model, d_ff), std_in, dtype),
            "wi_up": normal((n, e, d_model, d_ff), std_in, dtype),
            "wo": normal((n, e, d_ff, d_model), std_out, dtype)}


def capacity_for(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-expert capacity, the reference's: rows rounded up to 128 from
    1,024 tokens on, to 8 below (decode-sized batches)."""
    c = int(math.ceil(n_tokens * top_k * capacity_factor / n_experts))
    if n_tokens >= 1024:
        return max(((c + 127) // 128) * 128, 128)
    return max(((c + 7) // 8) * 8, 8)


def _dispatch_compute_combine(xf, router, wi_gate, wi_up, wo, *, top_k: int, cap: int,
                              act: str):
    """Route xf (T, D) to the experts with capacity ``cap`` each, run the
    GLU FFN, combine back weighted by the gates. Returns (y (T, D), aux
    float32)."""
    t, d = xf.shape
    e = router.shape[1]
    probs = torch.softmax(xf.float() @ router, dim=-1)  # (T, E) float32
    gates, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # Switch-style aux load-balancing loss.
    flat_e = idx.reshape(-1)
    me = probs.mean(dim=0)
    # A scatter-add of ones, as the reference counts (torch.bincount would
    # wait for the device to size its output).
    ce = probs.new_zeros(e).index_add_(0, flat_e, probs.new_ones(t * top_k)) / (t * top_k)
    aux = e * torch.sum(me * ce)

    se, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(se, torch.arange(e, dtype=se.dtype, device=se.device))
    pos_in_e = torch.arange(t * top_k, device=se.device) - starts[se]
    keep = pos_in_e < cap
    token_of = order // top_k
    gate_of = gates.reshape(-1)[order]

    # A token past capacity writes to the overflow row e * cap, cut off.
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)
    buf = xf.new_zeros((e * cap + 1, d)).index_copy(0, slot, xf[token_of])
    buf = buf[: e * cap].reshape(e, cap, d)

    out_buf = torch.bmm(activation(torch.bmm(buf, wi_gate), act) * torch.bmm(buf, wi_up), wo)
    picked = out_buf.reshape(e * cap, d)[torch.clamp(slot, max=e * cap - 1)]
    contrib = picked * torch.where(keep, gate_of, 0.0).to(picked.dtype)[:, None]
    y = xf.new_zeros((t, d)).index_add(0, token_of, contrib)
    return y, aux


def moe_ffn(params: dict, x, *, top_k: int, capacity_factor: float,
            act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss, a float32 scalar). All B x S
    tokens share each expert's capacity."""
    b, s, d = x.shape
    t = b * s
    cap = capacity_for(t, params["router"].shape[1], top_k, capacity_factor)
    y, aux = _dispatch_compute_combine(
        x.reshape(t, d), params["router"], params["wi_gate"], params["wi_up"], params["wo"],
        top_k=top_k, cap=cap, act=act)
    return y.reshape(b, s, d), aux
