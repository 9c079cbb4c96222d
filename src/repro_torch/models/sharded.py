"""The model's blocks that DTensor cannot partition by itself, on a mesh.

A step built on a mesh passes DTensors through the model, and DTensor
propagates each op's sharding, as GSPMD does for the reference. The
blocks here hold ops without a DTensor sharding rule (the flash
attention's autograd.Function, in-place cache writes) or whose partition
the reference gets from GSPMD's collectives (a softmax over a
sequence-sharded cache), so they run per shard
(``distributed.ctx.per_shard``) with their sharded dims stated:

* attention is batch-local over the data axes and head-local over
  'model' when the query heads shard there: with the kv heads sharded
  too, or (they do not divide 'model') with each rank reading the kv
  heads of its query heads from the replicated K and V; otherwise its
  inputs are replicated over 'model' and every 'model' rank computes the
  same heads;
* decode attention over a cache whose sequence dim shards over 'model'
  (the kv heads do not divide) takes each rank's slots and combines the
  ranks' partial softmaxes (max, sum, weighted values), the
  flash-decoding form;
* a decode step writes its token's K/V into the rank's own shard of the
  cache, in place.

(SSD's chunked scan runs per shard the same way, models/ssm.py::ssd.)

Every function takes plain tensors too and then calls the single-device
code unchanged.
"""
from __future__ import annotations

import torch

from ..distributed.ctx import batch_layout as _layout
from ..distributed.ctx import is_sharded as _sharded
from ..distributed.ctx import per_shard
from .attention import NEG_INF, _capped, decode_attention, flash_attention


def _is_dt(*ts) -> bool:
    # A DTensor carries its mesh. Plain tensors are told apart without
    # importing torch.distributed.tensor, which the single-device path never
    # loads (its import leaves some 70,000 more objects for the collector).
    return any(hasattr(t, "device_mesh") for t in ts)


def _as_dt(t, mesh):
    """A plain tensor (every rank holding all of it) as a replicated
    DTensor; None and DTensors pass."""
    from torch.distributed.tensor import DTensor, Replicate

    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, tuple(Replicate() for _ in mesh.mesh_dim_names),
                              run_check=False)


def like(x, ref):
    """A block's output in the residual stream's layout before it is
    added: the tensor-parallel all-reduce of its partial sums (a
    reduce-scatter onto the sequence under sequence parallelism), stated
    so that DTensor does not pick another layout for the sum."""
    if not _is_dt(x, ref) or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def gather_seq(x):
    """A block's normed input whole over 'model': under sequence
    parallelism the residual stream's sequence (dim 1) shards over
    'model' between blocks, and is gathered where a block's projections
    begin (Megatron's sequence-parallel all-gather). Otherwise ``x``
    passes."""
    if not _is_dt(x) or not _sharded(x, 1):
        return x
    return x.redistribute(x.device_mesh, _layout(x))


def _kv_slice(q, k):
    """Where the query heads shard over 'model' and the kv heads do not
    divide it, the kv heads [lo, hi) this rank's query heads read, or
    None when its heads straddle groups unevenly."""
    mesh = q.device_mesh
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    h, kh = q.shape[2], k.shape[2]
    local, group = h // n_model, h // kh
    if local % group and group % local:
        return None
    r = mesh.get_local_rank("model")
    return (r * local) // group, ((r + 1) * local - 1) // group + 1


def flash(q, k, v, **kw):
    """flash_attention on a mesh (plain tensors: unchanged)."""
    if not _is_dt(q, k, v):
        return flash_attention(q, k, v, **kw)
    if _sharded(q, 2) and not _sharded(k, 2):
        span = _kv_slice(q, k)
        if span is not None:
            # Each rank's query heads read their own kv heads of the
            # replicated K and V, whose gradients are then partial sums.
            from torch.distributed.tensor import Partial

            lo, hi = span
            qpl, kpl = _layout(q, 2), _layout(k)
            kgrad = tuple(Partial() if n == "model" else p
                          for n, p in zip(q.device_mesh.mesh_dim_names, kpl))
            return per_shard(lambda a, b, c: flash_attention(a, b[:, :, lo:hi], c[:, :, lo:hi],
                                                             **kw),
                             (q, k, v), (qpl, kpl, kpl), qpl, grad_specs=(qpl, kgrad, kgrad))
    heads = _sharded(q, 2) and _sharded(k, 2)
    pl = _layout(q, 2 if heads else None)
    return per_shard(lambda a, b, c: flash_attention(a, b, c, **kw), (q, k, v),
                     (pl, pl, pl), pl)


def decode(q, k_cache, v_cache, cur_pos, *, slot_positions=None, **kw):
    """decode_attention on a mesh (plain tensors: unchanged)."""
    if not _is_dt(q, k_cache, v_cache):
        return decode_attention(q, k_cache, v_cache, cur_pos, slot_positions=slot_positions,
                                **kw)
    mesh = q.device_mesh
    cur_pos, slot_positions = _as_dt(cur_pos, mesh), _as_dt(slot_positions, mesh)
    pos_pl = _layout(q)
    if not _sharded(k_cache, 1):
        heads = _sharded(q, 2) and _sharded(k_cache, 2)
        pl = _layout(q, 2 if heads else None)
        cpl = _layout(k_cache, 2 if heads else None)
        args = (q, k_cache, v_cache, cur_pos, slot_positions)
        specs = (pl, cpl, cpl, pos_pl, pos_pl)
        return per_shard(lambda a, b, c, d, e: decode_attention(a, b, c, d, slot_positions=e,
                                                                 **kw),
                         args, specs, pl)
    return _decode_seq_sharded(q, k_cache, v_cache, cur_pos, slot_positions, **kw)


def _decode_seq_sharded(q, k_cache, v_cache, cur_pos, slot_positions, *, window=None,
                        softcap_val=None, scale=None):
    from torch.distributed.tensor import Shard

    mesh = q.device_mesh
    b, _, h, d = q.shape
    length, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    if slot_positions is None:
        slot_positions = _as_dt(torch.arange(length, device=k_cache.device)[None, :]
                                .expand(b, length).contiguous(), mesh)

    def partial(qq, kc, vc, cur, pos):
        bl = qq.shape[0]
        qf = qq.float().reshape(bl, kh, g, d)
        logits = _capped(torch.einsum("bkgd,blkd->bkgl", qf, kc.float()), scale, softcap_val)
        mask = (pos <= cur[:, None]) & (pos >= 0)
        if window is not None:
            mask &= pos > cur[:, None] - window
        logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
        top = logits.amax(dim=-1)
        p = torch.exp(logits - top[..., None])
        out = torch.einsum("bkgl,blkd->bkgd", p, vc.float())
        return out[None], top[None], p.sum(dim=-1)[None]

    qpl = _layout(q)
    cpl = _layout(k_cache, 1)
    pos_pl = _layout(q)
    slot_pl = tuple(Shard(1) if name == "model" else p
                    for name, p in zip(mesh.mesh_dim_names, pos_pl))
    # Each rank's partials gain a leading dim of one, sharded over 'model'.
    rank_pl = tuple(Shard(0) if name == "model" else (Shard(1) if p == Shard(0) else p)
                    for name, p in zip(mesh.mesh_dim_names, qpl))
    out, top, total = per_shard(partial, (q, k_cache, v_cache, cur_pos, slot_positions),
                                (qpl, cpl, cpl, pos_pl, slot_pl), (rank_pl, rank_pl, rank_pl))
    best = top.amax(dim=0)
    w = torch.exp(top - best)
    num = (w[..., None] * out).sum(dim=0)
    den = (w * total).sum(dim=0)
    return (num / den[..., None]).reshape(b, 1, h, d).to(q.dtype)


def write_token(cache, k_new, v_new, slot):
    """Write each sequence's new K and V (B, 1, K, D) at its slot (B,) of
    ``cache`` {"k", "v"} (B, L, K, D), in place."""
    if not _is_dt(cache["k"]):
        bidx = torch.arange(slot.shape[0], device=slot.device)
        cache["k"][bidx, slot] = k_new[:, 0]
        cache["v"][bidx, slot] = v_new[:, 0]
        return
    ck = cache["k"]
    mesh = ck.device_mesh
    slot = _as_dt(slot, mesh)
    cpl = tuple(ck.placements)
    if not _sharded(ck, 1):
        def put(c, n, s):
            c[torch.arange(c.shape[0], device=c.device), s] = n[:, 0]

        new_pl = cpl
    else:
        n_model = mesh.size(mesh.mesh_dim_names.index("model"))
        first = mesh.get_local_rank("model") * (ck.shape[1] // n_model)

        def put(c, n, s):
            # Only the rank whose slots hold ``s`` writes; the others
            # rewrite the slot they read.
            loc = s.long() - first
            ok = (loc >= 0) & (loc < c.shape[1])
            idx = loc.clamp(0, c.shape[1] - 1)
            bi = torch.arange(c.shape[0], device=c.device)
            c[bi, idx] = torch.where(ok[:, None, None], n[:, 0].to(c.dtype), c[bi, idx])

        new_pl = _layout(ck)
    for c, n in ((ck, k_new), (cache["v"], v_new)):
        per_shard(put, (c, n, slot), (cpl, new_pl, _layout(ck)), None)


def fill_cache(k_new, slots: int, ring: bool):
    """A prefill's cache of ``slots`` positions from its K or V (B, S, K,
    D): the prompt at its start, or for a ring (a local layer's window)
    the last ``slots`` tokens at position % slots."""

    def fill(kn):
        b, s = kn.shape[:2]
        kc = kn.new_zeros((b, slots) + tuple(kn.shape[2:]))
        if s <= slots:
            kc[:, :s] = kn
        else:
            if not ring:
                raise ValueError(f"prompt of {s} tokens exceeds cache_len {slots}")
            idx = torch.arange(s - slots, s, device=kn.device) % slots
            kc[:, idx] = kn[:, s - slots:]
        return kc

    if not _is_dt(k_new):
        return fill(k_new)
    pl = tuple(k_new.placements)
    return per_shard(fill, (k_new,), (pl,), pl)

