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

On a mesh (a step built with one, whose sharding context is current),
with a 'model' axis over 1 that divides the experts and data axes that
divide the batch, the expert-parallel path runs, as the reference's
shard_map does: each rank routes its data-local tokens (replicated over
'model') to its own experts, with the capacity of the local token count,
so tokens drop per data shard; y is summed over 'model' (the combine a
dense tensor-parallel FFN pays too) and aux is averaged over the data
shards. Otherwise the dispatch is global: on a mesh its inputs are
gathered whole on every rank (the sort, searchsorted and scatters have
no DTensor rule), and each rank computes all of it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..distributed import ctx as dist_ctx
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
                              act: str, e_first: int = 0, e_local: Optional[int] = None):
    """Route xf (T, D) to experts [e_first, e_first + e_local) with
    capacity ``cap`` each, run the GLU FFN, combine back weighted by the
    gates. Returns (y (T, D), partial over the expert range, aux
    float32)."""
    t, d = xf.shape
    e = router.shape[1]
    e_local = e if e_local is None else e_local
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
    if e_local != e:  # the expert-parallel call: this rank's experts only
        se = se - e_first
        keep = keep & (se >= 0) & (se < e_local)
    token_of = order // top_k
    gate_of = gates.reshape(-1)[order]

    # A token past capacity, or routed to another rank's expert, writes to
    # the overflow row e_local * cap, cut off.
    slot = torch.where(keep, se * cap + pos_in_e, e_local * cap)
    buf = xf.new_zeros((e_local * cap + 1, d)).index_copy(0, slot, xf[token_of])
    buf = buf[: e_local * cap].reshape(e_local, cap, d)
    buf = dist_ctx.constrain("moe_buf", buf) if e_local == e else buf

    out_buf = torch.bmm(activation(torch.bmm(buf, wi_gate), act) * torch.bmm(buf, wi_up), wo)
    out_buf = dist_ctx.constrain("moe_buf", out_buf) if e_local == e else out_buf
    picked = out_buf.reshape(e_local * cap, d)[torch.clamp(slot, max=e_local * cap - 1)]
    contrib = picked * torch.where(keep, gate_of, 0.0).to(picked.dtype)[:, None]
    y = xf.new_zeros((t, d)).index_add(0, token_of, contrib)
    return y, aux


def moe_ffn(params: dict, x, *, top_k: int, capacity_factor: float,
            act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss, a float32 scalar). All B x S
    tokens share each expert's capacity."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    mesh = dist_ctx.current_mesh()
    if mesh is not None:
        from ..distributed.sharding import dp_size, model_axis_size

        nm = model_axis_size(mesh)
        if nm > 1 and e % nm == 0 and b % dp_size(mesh) == 0:
            return _moe_ffn_expert_parallel(params, x, top_k=top_k,
                                            capacity_factor=capacity_factor, act=act,
                                            mesh=mesh)
    t = b * s
    cap = capacity_for(t, e, top_k, capacity_factor)
    names = ("router", "wi_gate", "wi_up", "wo")

    def dense(xx, *w):
        y, aux = _dispatch_compute_combine(xx.reshape(t, d), *w, top_k=top_k, cap=cap,
                                           act=act)
        return y.reshape(b, s, d), aux

    if mesh is None:
        return dense(x, *(params[k] for k in names))
    whole = dist_ctx.P()
    return dist_ctx.per_shard(dense, (x, *(params[k] for k in names)), (whole,) * 5,
                              (whole, whole))


def _moe_ffn_expert_parallel(params, x, *, top_k, capacity_factor, act, mesh):
    """The reference's _moe_ffn_shard_map on DTensors: x batch-sharded over
    the data axes and replicated over 'model', the experts sharded over
    'model'. Each rank's y is its experts' part, a partial sum over
    'model'; its aux (the same on every 'model' rank) enters a partial sum
    over all ranks scaled by 1 / (data shards x 'model' ranks), so the sum
    is the mean over the data shards. The gradients of inputs replicated
    where the outputs are partial are partial sums there."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..distributed.sharding import dp_size

    b, s, d = x.shape
    e = params["router"].shape[1]
    names = mesh.mesh_dim_names
    nm = mesh.size(names.index("model"))
    n_dp = dp_size(mesh)
    t_loc = (b // n_dp) * s
    cap = capacity_for(t_loc, e, top_k, capacity_factor)
    e_loc = e // nm
    e_first = mesh.get_local_rank("model") * e_loc
    is_model = [n == "model" for n in names]

    def pl(on_model, on_dp):
        return tuple(on_model if m else on_dp for m in is_model)

    def inner(x_loc, router, wg, wu, wo):
        bl, sl, dl = x_loc.shape
        y, aux = _dispatch_compute_combine(x_loc.reshape(bl * sl, dl), router, wg, wu, wo,
                                           top_k=top_k, cap=cap, act=act, e_first=e_first,
                                           e_local=e_loc)
        return y.reshape(bl, sl, dl), aux / (n_dp * nm)

    x_pl, w_pl, r_pl = pl(Replicate(), Shard(0)), pl(Shard(0), Replicate()), pl(Replicate(),
                                                                                 Replicate())
    grads = (pl(Partial(), Shard(0)), pl(Partial(), Partial()),
             *(pl(Shard(0), Partial()),) * 3)
    return dist_ctx.per_shard(
        inner, (x, params["router"], params["wi_gate"], params["wi_up"], params["wo"]),
        (x_pl, r_pl, w_pl, w_pl, w_pl),
        (pl(Partial(), Shard(0)), pl(Partial(), Partial())), grad_specs=grads)
