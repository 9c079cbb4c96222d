"""Blocked (flash-style) attention for training and prefill, with the
reference's memory-saving backward, and the masked full-cache read used
at decode; the PyTorch port of the reference's models/attention.py.

The reference computes attention in jnp, outside any Pallas kernel, so
PyTorch ops serve here. Its masking semantics are kept: causal (query i
sees keys j <= i + q_offset), a sliding window (j > i - window) and logit
soft-capping before the mask. Queries are taken in chunks with the
reference's static per-chunk KV extent (causal chunks read only the
prefix they need, window chunks skip blocks behind the window), so the
logits held at once are (B, H, q_chunk, extent). Within a chunk the
softmax is taken whole rather than online; the result is the same up to
float rounding. All logits, softmax and the value product run in float32.

The backward is the reference's custom VJP (after FlashAttention's
dq/dk/dv pass, arXiv:2205.14135), as a torch.autograd.Function: the
forward saves only (q, k, v, out, lse), with lse each query row's
log-sum-exp over its chunk's extent, and the backward recomputes every
chunk's probabilities from lse. Autograd of the forward would keep every
chunk's probabilities instead, (B, H, q_chunk, extent) float32 each.
Without autograd (prefill) the forward skips lse; the output is the same.

GQA: queries reshape to (B, S, n_kv, group, d), so KV is never repeated.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

NEG_INF = -2.0e30


class _Opts(NamedTuple):
    causal: bool
    window: Optional[int]
    softcap_val: Optional[float]
    scale: float
    q_chunk: int
    kv_block: int
    q_offset: int


def _chunk_plan(sq: int, skv: int, causal: bool, window: Optional[int], q_chunk: int,
                kv_block: int, q_offset: int):
    """Static per-query-chunk KV extents: (q0, q1, abs_q0, kv_start,
    kv_end)."""
    q_chunk = min(q_chunk, sq)
    kv_block = min(kv_block, skv)
    plans = []
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        abs_q0, abs_q1 = q_offset + q0, q_offset + q1
        kv_end = skv if not causal else max(min(skv, abs_q1), 1)
        kv_start = 0
        if window is not None:
            kv_start = max(0, ((abs_q0 - window + 1) // kv_block) * kv_block)
            kv_start = min(kv_start, max(kv_end - kv_block, 0))
        plans.append((q0, q1, abs_q0, kv_start, kv_end))
    return plans


def _plans(sq: int, skv: int, o: _Opts):
    return _chunk_plan(sq, skv, o.causal, o.window, o.q_chunk, o.kv_block, o.q_offset)


def _capped(s: torch.Tensor, scale: float, softcap_val: Optional[float]) -> torch.Tensor:
    s = s * scale
    if softcap_val is not None:
        s = torch.tanh(s / softcap_val) * softcap_val
    return s


def _mask(abs_q0: int, sq: int, kv_start: int, kv_end: int, o: _Opts, device) -> torch.Tensor:
    """(sq, kv_end - kv_start) bool: which keys each query of the chunk sees."""
    qi = abs_q0 + torch.arange(sq, device=device)[:, None]
    kj = kv_start + torch.arange(kv_end - kv_start, device=device)[None, :]
    mask = torch.ones((sq, kv_end - kv_start), dtype=torch.bool, device=device)
    if o.causal:
        mask &= kj <= qi
    if o.window is not None:
        mask &= kj > qi - o.window
    return mask


def _flash_forward(q, k, v, o: _Opts, with_lse: bool):
    """Returns (out (B, Sq, H, D) in q.dtype, lse (B, K, G, Sq) float32 or
    None)."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    qf = q.float().reshape(b, sq, kh, g, d)
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for q0, q1, abs_q0, kv_start, kv_end in _plans(sq, skv, o):
        s = _capped(torch.einsum("bqkgd,bskd->bkgqs", qf[:, q0:q1], kf[:, kv_start:kv_end]),
                    o.scale, o.softcap_val)
        s = s.masked_fill(~_mask(abs_q0, q1 - q0, kv_start, kv_end, o, q.device), NEG_INF)
        p = torch.softmax(s, dim=-1)
        if with_lse:
            # A row's largest probability is exp(max - lse): two reads of the
            # chunk's logits where logsumexp would take four and two writes.
            lses.append(s.amax(dim=-1) - torch.log(p.amax(dim=-1)))
        out = torch.einsum("bkgqs,bskd->bqkgd", p, vf[:, kv_start:kv_end])
        outs.append(out.reshape(b, q1 - q0, h, d))
    lse = torch.cat(lses, dim=-1) if with_lse else None
    return torch.cat(outs, dim=1).to(q.dtype), lse


def _flash_backward(q, k, v, out, lse, dout, o: _Opts):
    """The reference's _flash_bwd, one query chunk at a time over the
    forward's extents: probabilities from lse, float32 accumulators cast
    to the inputs' dtypes."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    qf = q.float().reshape(b, sq, kh, g, d)
    kf, vf = k.float(), v.float()
    doutf = dout.float().reshape(b, sq, kh, g, d)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", doutf, out.float().reshape(b, sq, kh, g, d))
    dq = torch.zeros((b, sq, kh, g, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, skv, kh, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, skv, kh, d), dtype=torch.float32, device=q.device)
    for q0, q1, abs_q0, kv_start, kv_end in _plans(sq, skv, o):
        qc, dc = qf[:, q0:q1], doutf[:, q0:q1]
        kc, vc = kf[:, kv_start:kv_end], vf[:, kv_start:kv_end]
        masked = ~_mask(abs_q0, q1 - q0, kv_start, kv_end, o, q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc).mul_(o.scale)
        if o.softcap_val is not None:
            t = s.div_(o.softcap_val).tanh_()
            p = t * o.softcap_val
        else:
            t, p = None, s
        p = p.masked_fill_(masked, NEG_INF).sub_(lse[..., q0:q1, None]).exp_()
        dv[:, kv_start:kv_end] += torch.einsum("bkgqs,bqkgd->bskd", p, dc)
        ds = torch.einsum("bqkgd,bskd->bkgqs", dc, vc)
        ds = ds.sub_(delta[..., q0:q1, None]).mul_(p)  # d/d capped logits
        del p
        if t is not None:
            ds = ds.mul_(t.mul_(t).neg_().add_(1.0))  # through the tanh cap
            del t
        ds = ds.mul_(o.scale).masked_fill_(masked, 0.0)
        dq[:, q0:q1] += torch.einsum("bkgqs,bskd->bqkgd", ds, kc)
        dk[:, kv_start:kv_end] += torch.einsum("bkgqs,bqkgd->bskd", ds, qc)
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, opts: _Opts):
        out, lse = _flash_forward(q, k, v, opts, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_backward(q, k, v, out, lse, dout, ctx.opts), None)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap_val: Optional[float] = None, scale: Optional[float] = None,
                    q_chunk: int = 1024, kv_block: int = 1024, q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, K, D) with H % K == 0. Returns
    (B, Sq, H, D) in q.dtype, differentiable in q, k and v."""
    opts = _Opts(causal, window, softcap_val,
                 scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]),
                 q_chunk, kv_block, q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, opts)
    return _flash_forward(q, k, v, opts, with_lse=False)[0]


def naive_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap_val: Optional[float] = None, scale: Optional[float] = None,
                    q_offset: int = 0):
    """The plain version flash_attention is held to: every logit at once,
    (B, K, G, Sq, Skv) float32, with the same masks and cap; autograd
    gives its gradients."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, kh, h // kh, d)
    s = _capped(torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()), scale, softcap_val)
    o = _Opts(causal, window, softcap_val, scale, sq, skv, q_offset)
    p = torch.softmax(s.masked_fill(~_mask(q_offset, sq, 0, skv, o, q.device), NEG_INF), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float()).reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_pos, *, window: Optional[int] = None,
                     softcap_val: Optional[float] = None, scale: Optional[float] = None,
                     slot_positions=None):
    """Single-step decode: q (B, 1, H, D) against a cache (B, L, K, D);
    positions > cur_pos, < 0, or outside the window are masked.
    slot_positions (B, L): the absolute position each cache slot holds
    (default arange(L), a linear cache; ring caches pass their map). The
    whole cache is read once."""
    b, _, h, d = q.shape
    _, L, kh, _ = k_cache.shape
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, kh, g, d)
    logits = _capped(torch.einsum("bkgd,blkd->bkgl", qf, k_cache.float()), scale, softcap_val)
    if slot_positions is None:
        pos = torch.arange(L, device=q.device)[None, :].expand(b, L)
    else:
        pos = slot_positions
    mask = (pos <= cur_pos[:, None]) & (pos >= 0)
    if window is not None:
        mask &= pos > cur_pos[:, None] - window
    p = torch.softmax(logits.masked_fill(~mask[:, None, None, :], NEG_INF), dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def ring_slot_positions(cur_pos: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Absolute position held by each slot of a ring cache written at
    (pos % n_slots): slot j holds the largest p <= cur with p % W == j;
    negative means not yet written."""
    j = torch.arange(n_slots, dtype=torch.int32, device=cur_pos.device)[None, :]
    cur = cur_pos[:, None].to(torch.int32)
    return cur - torch.remainder(cur - j, n_slots)
