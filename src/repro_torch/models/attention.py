"""Attention for prefill and scoring (the forward of the reference's
blocked flash attention) and the masked full-cache read used at decode;
the PyTorch port of the reference's models/attention.py, forward only.

The reference computes attention in jnp, outside any Pallas kernel, so
plain PyTorch serves here. Its masking semantics are kept: causal (query
i sees keys j <= i + q_offset), a sliding window (j > i - window) and
logit soft-capping before the mask. Queries are taken in chunks with the
reference's static per-chunk KV extent (causal chunks read only the
prefix they need, window chunks skip blocks behind the window), so the
logits held at once are (B, H, q_chunk, extent). Within a chunk the
softmax is taken whole rather than online; the result is the same up to
float rounding. All logits, softmax and the value product run in float32.
The custom backward (the reference's custom VJP) waits for the training
slice.

GQA: queries reshape to (B, S, n_kv, group, d), so KV is never repeated.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e30


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


def _capped(s: torch.Tensor, scale: float, softcap_val: Optional[float]) -> torch.Tensor:
    s = s * scale
    if softcap_val is not None:
        s = torch.tanh(s / softcap_val) * softcap_val
    return s


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap_val: Optional[float] = None, scale: Optional[float] = None,
                    q_chunk: int = 1024, kv_block: int = 1024, q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, K, D) with H % K == 0. Returns
    (B, Sq, H, D) in q.dtype."""
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, kh, g, d)
    kf, vf = k.float(), v.float()
    outs = []
    for q0, q1, abs_q0, kv_start, kv_end in _chunk_plan(sq, skv, causal, window, q_chunk,
                                                        kv_block, q_offset):
        s = _capped(torch.einsum("bqkgd,bskd->bkgqs", qf[:, q0:q1], kf[:, kv_start:kv_end]),
                    scale, softcap_val)
        qi = abs_q0 + torch.arange(q1 - q0, device=q.device)[:, None]
        kj = kv_start + torch.arange(kv_end - kv_start, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, kv_end - kv_start), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kj <= qi
        if window is not None:
            mask &= kj > qi - window
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, vf[:, kv_start:kv_end])
        outs.append(out.reshape(b, q1 - q0, h, d))
    return torch.cat(outs, dim=1).to(q.dtype)


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
