"""The decoder stack of the LM; the PyTorch port of the reference's
models/model.py, every layer kind it has: global layers, sliding-window
local layers with ring caches, gated cross-attention layers over vision
states, MoE FFNs (models/moe.py), Mamba2 SSM layers (models/ssm.py) and
zamba2's shared attention block, with the options the configs set (qkv
bias, qk norm, sandwich norms, soft-capping, a local RoPE base, attention
scale, the GLU or plain MLP, tied or untied embeddings, precomputed input
embeddings).

Parameters keep the reference's tree: {["embed"], ["lm_head"],
"final_norm", "groups": (one layer dict per position of the layer
pattern), ["shared_attn"]}, each layer leaf (the "moe" and "ssm"
sub-dicts' too) stacked over the pattern's n_groups repetitions on a
leading axis, so models/carry.py maps the reference's tree one to one.
The reference scans over that axis; here a Python loop walks the layers
group-major (group g runs pattern positions 0..P-1, layer g * P + p),
each taking its slice of every stacked leaf (a view, so the gradients
land in the stacked leaf). The shared block's weights are one unstacked
dict that every ssm_shared_attn layer applies.

Entry points:
  forward_train   causal forward + chunked cross-entropy, differentiable
                  (remat: one activation checkpoint per layer)
  prefill         forward returning per-layer KV caches (no autograd)
  decode_step     one token against the caches, written in place (no
                  autograd)

Caches mirror the reference's: a tuple per layer-pattern position, each
leaf stacked over n_groups. Attention layers hold {"k", "v"} tensors
(n_groups, B, L, n_kv, head_dim), with L the cache length for global
layers, min(window, cache length) for local layers (a ring: position p
sits in slot p % L) and the image tokens for cross layers. SSM layers
hold {"state" (n_groups, B, H, N, P), "conv" (n_groups, B, d_conv - 1,
conv_dim)}, both float32, and an ssm_shared_attn layer also its own
application's {"sa": {"k", "v"}}.

On a mesh (a step of launch/steps.py built with one) the same code runs
on DTensors: the reference's ``constrain`` hooks pin the residual stream
("activations", at each group's start) and the loss's logits chunks
("logits_chunk"); the blocks DTensor cannot partition by itself run per
shard (models/sharded.py); each block's output is laid out as the
residual stream before it is added (the tensor-parallel all-reduce);
and the cross-entropy takes the vocab-parallel form. On plain tensors
every one of these is the single-device code.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..distributed import ctx as dist_ctx
from ..tree import tree_flatten, tree_map, tree_unflatten
from .attention import ring_slot_positions
from .layers import apply_rope, embed, mlp_glu, mlp_plain, rms_norm, softcap, unembed
from .moe import init_moe_params, moe_ffn
from .sharded import decode, fill_cache, flash, gather_seq, like, write_token
from .ssm import init_ssm_params, spec_from_cfg, ssm_decode_step, ssm_forward

PyTree = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Leaves the reference keeps in float32 whatever the model's dtype: the
# cross gates, the MoE router, and the SSM's dt bias, decay and skip.
FLOAT32_LEAVES = frozenset({"gate_attn", "gate_mlp", "router", "dt_bias", "A_log", "D"})
SSM_KINDS = ("ssm", "ssm_shared_attn")
LAYER_KINDS = ("global", "local", "cross") + SSM_KINDS


def _dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config whose layer pattern names a kind the model does
    not have, or applies the shared block without its heads."""
    unknown = sorted(set(cfg.layer_pattern) - set(LAYER_KINDS))
    if unknown:
        raise ValueError(f"{cfg.name}: unknown layer kinds {unknown}; known: {LAYER_KINDS}")
    if "ssm_shared_attn" in cfg.layer_pattern and not cfg.shared_attn_heads:
        raise ValueError(f"{cfg.name}: ssm_shared_attn layers need shared_attn_heads")


# =====================================================================
# Parameter init
# =====================================================================
def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> PyTree:
    """Seeded random parameters (no weights exist in the repository): the
    reference's shapes, scales and dtypes. Each leaf is allocated on
    ``device`` in its dtype and drawn in float32 from ``generator`` on
    the generator's own device (a CUDA generator keeps the draw off the
    host), a stacked leaf one group's slice at a time: the float32 draw
    of a whole expert leaf would not fit beside the model."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dt(cfg)
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    nh, nkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_groups

    def draw(shape, std):
        return torch.randn(shape, generator=generator, device=generator.device).mul_(std)

    def normal(shape, std, dtype=dt):
        """A leaf stacked over its leading axis, drawn slice by slice."""
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            out[i] = draw(shape[1:], std)
        return out

    def whole(shape, std):
        return draw(shape, std).to(device=dev, dtype=dt)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def layer(kind: str) -> Dict[str, Any]:
        if kind in SSM_KINDS:
            return {"norm": zeros(n, d), "ssm": init_ssm_params(normal, full, n,
                                                                spec_from_cfg(cfg), dt)}
        std = 1.0 / math.sqrt(d)
        p = {"norm": zeros(n, d),
             "wq": normal((n, d, nh * hd), std),
             "wk": normal((n, d, nkv * hd), std),
             "wv": normal((n, d, nkv * hd), std),
             "wo": normal((n, nh * hd, d), std)}
        if cfg.qkv_bias:
            p.update(bq=zeros(n, nh * hd), bk=zeros(n, nkv * hd), bv=zeros(n, nkv * hd))
        if cfg.qk_norm:
            p.update(q_norm=zeros(n, hd), k_norm=zeros(n, hd))
        if cfg.sandwich_norm:
            p["post_norm"] = zeros(n, d)
        if kind == "cross":
            p.update(gate_attn=zeros(n, dtype=torch.float32),
                     gate_mlp=zeros(n, dtype=torch.float32))
        p["mlp_norm"] = zeros(n, d)
        if cfg.n_experts:
            p["moe"] = init_moe_params(normal, n, d, ff, cfg.n_experts, dt)
        else:
            if cfg.mlp_type == "glu":
                p.update(wi_gate=normal((n, d, ff), std), wi_up=normal((n, d, ff), std))
            else:
                p["wi"] = normal((n, d, ff), std)
            p["wo_mlp"] = normal((n, ff, d), 1.0 / math.sqrt(ff))
        if cfg.sandwich_norm:
            p["post_mlp_norm"] = zeros(n, d)
        return p

    params: Dict[str, Any] = {}
    if cfg.embed_input:
        params["embed"] = whole((cfg.vocab_size, d), 0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = whole((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    params["final_norm"] = zeros(d)
    params["groups"] = tuple(layer(kind) for kind in cfg.layer_pattern)
    if cfg.shared_attn_heads:
        # zamba2's shared transformer block: one set of weights, applied by
        # every ssm_shared_attn layer.
        snh, snkv, sff = cfg.shared_attn_heads, cfg.shared_attn_kv_heads, cfg.shared_attn_d_ff
        shd = d // snh
        std = 1.0 / math.sqrt(d)
        params["shared_attn"] = {
            "norm": zeros(d),
            "wq": whole((d, snh * shd), std), "wk": whole((d, snkv * shd), std),
            "wv": whole((d, snkv * shd), std), "wo": whole((snh * shd, d), std),
            "mlp_norm": zeros(d),
            "wi_gate": whole((d, sff), std), "wi_up": whole((d, sff), std),
            "wo_mlp": whole((sff, d), 1.0 / math.sqrt(sff)),
        }
    return params


# =====================================================================
# Layer application
# =====================================================================
def _attn_block(p: Dict, h, cfg: ModelConfig, kind: str, *, mode: str, positions,
                cache: Optional[Dict], cur_pos, vision_states, cache_len: int):
    """One attention layer of ``kind``. Returns (attn_out, new_cache); at
    decode the new token's K/V are written into ``cache`` in place."""
    b, s, _ = h.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    attn_kw = dict(softcap_val=cfg.attn_softcap, scale=cfg.attn_scale)
    x = gather_seq(rms_norm(h, p["norm"], cfg.norm_eps))
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, s, nh, hd)
    local = kind == "local"
    window = cfg.window if local else None
    theta = cfg.rope_theta_local if local and cfg.rope_theta_local is not None else cfg.rope_theta

    if kind == "cross":
        # K/V of the vision states, cached at prefill; every image token is
        # visible, and no RoPE.
        if mode == "decode":
            k, v = cache["k"], cache["v"]
            new_cache = cache
        else:
            if vision_states is None:
                raise ValueError(f"{cfg.name}: a cross layer needs batch['vision_states']")
            src = vision_states.to(p["wk"].dtype)
            k = (src @ p["wk"]).reshape(b, -1, nkv, hd)
            v = (src @ p["wv"]).reshape(b, -1, nkv, hd)
            new_cache = {"k": k, "v": v} if mode == "prefill" else None
        if cfg.qk_norm:  # on the cached K too, as the reference does
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if mode == "decode":
            every = torch.full((b,), k.shape[1] - 1, dtype=torch.int64, device=h.device)
            out = decode(q, k, v, every, **attn_kw)
        else:
            out = flash(q, k, v, causal=False, **attn_kw)
    else:
        kx, vx = x @ p["wk"], x @ p["wv"]
        if cfg.qkv_bias:
            kx, vx = kx + p["bk"], vx + p["bv"]
        k_new, v_new = kx.reshape(b, s, nkv, hd), vx.reshape(b, s, nkv, hd)
        if cfg.qk_norm:  # before RoPE
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k_new = rms_norm(k_new, p["k_norm"], cfg.norm_eps)
        q = apply_rope(q, positions, theta)
        k_new = apply_rope(k_new, positions, theta)
        if mode in ("train", "prefill"):
            out = flash(q, k_new, v_new, causal=True, window=window, **attn_kw)
        if mode == "train":
            new_cache = None
        elif mode == "prefill":
            # A local layer keeps a ring of min(window, cache_len) slots,
            # position t in slot t % slots: a longer prompt leaves its last
            # tokens there. A global layer's cache must hold the prompt.
            slots = min(window, cache_len) if local else cache_len
            new_cache = {"k": fill_cache(k_new, slots, local),
                         "v": fill_cache(v_new, slots, local)}
        else:  # decode
            slots = cache["k"].shape[1]
            slot = cur_pos % slots if local else cur_pos
            write_token(cache, k_new, v_new, slot)
            slot_pos = ring_slot_positions(cur_pos, slots) if local else None
            out = decode(q, cache["k"], cache["v"], cur_pos, window=window,
                         slot_positions=slot_pos, **attn_kw)
            new_cache = cache

    out = out.reshape(b, s, nh * hd) @ p["wo"]
    if cfg.sandwich_norm:
        out = rms_norm(out, p["post_norm"], cfg.norm_eps)
    if kind == "cross":
        out = out * torch.tanh(p["gate_attn"]).to(out.dtype)
    return out, new_cache


def _mlp_block(p: Dict, h, cfg: ModelConfig, kind: str):
    """Returns (mlp_out, the MoE's aux loss, None for a dense MLP)."""
    x = gather_seq(rms_norm(h, p["mlp_norm"], cfg.norm_eps))
    aux = None
    if cfg.n_experts:
        out, aux = moe_ffn(p["moe"], x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                           act=cfg.act)
    elif cfg.mlp_type == "glu":
        out = mlp_glu(x, p["wi_gate"], p["wi_up"], p["wo_mlp"], cfg.act)
    else:
        out = mlp_plain(x, p["wi"], p["wo_mlp"], cfg.act)
    if cfg.sandwich_norm:
        out = rms_norm(out, p["post_mlp_norm"], cfg.norm_eps)
    if kind == "cross":
        out = out * torch.tanh(p["gate_mlp"]).to(out.dtype)
    return out, aux


def _shared_attn_block(sp: Dict, h, cfg: ModelConfig, *, mode: str, positions, cache, cur_pos,
                       cache_len: Optional[int]):
    """zamba2's shared transformer block: full causal attention (head dim
    d_model // shared_attn_heads, RoPE at rope_theta) then a GLU MLP, each
    added to the residual stream. Returns (h, this application's new
    {"k", "v"} cache); at decode the new token's K/V are written into
    ``cache`` in place."""
    b, s, d = h.shape
    nh, nkv = cfg.shared_attn_heads, cfg.shared_attn_kv_heads
    hd = d // nh
    x = gather_seq(rms_norm(h, sp["norm"], cfg.norm_eps))
    q = apply_rope((x @ sp["wq"]).reshape(b, s, nh, hd), positions, cfg.rope_theta)
    k_new = apply_rope((x @ sp["wk"]).reshape(b, s, nkv, hd), positions, cfg.rope_theta)
    v_new = (x @ sp["wv"]).reshape(b, s, nkv, hd)
    new_cache = None
    if mode in ("train", "prefill"):
        out = flash(q, k_new, v_new, causal=True)
    if mode == "prefill":
        new_cache = {"k": fill_cache(k_new, cache_len, False),
                     "v": fill_cache(v_new, cache_len, False)}
    elif mode == "decode":
        write_token(cache, k_new, v_new, cur_pos)
        out = decode(q, cache["k"], cache["v"], cur_pos)
        new_cache = cache
    h = h + like(out.reshape(b, s, nh * hd) @ sp["wo"], h)
    x2 = gather_seq(rms_norm(h, sp["mlp_norm"], cfg.norm_eps))
    return h + like(mlp_glu(x2, sp["wi_gate"], sp["wi_up"], sp["wo_mlp"], cfg.act), h), new_cache


def _ssm_layer(p: Dict, h, cfg: ModelConfig, kind: str, *, mode: str, positions, cache,
               cur_pos, cache_len: Optional[int], shared):
    """A Mamba2 block added to the residual stream; an ssm_shared_attn
    layer then applies the shared block. Returns (h, the layer's new
    cache); at decode the state, conv tail and shared K/V are written
    into ``cache`` in place."""
    spec = spec_from_cfg(cfg)
    x = gather_seq(rms_norm(h, p["norm"], cfg.norm_eps))
    new_cache = None
    if mode == "train":
        h = h + like(ssm_forward(p["ssm"], x, spec), h)
    elif mode == "prefill":
        out, (state, conv) = ssm_forward(p["ssm"], x, spec, return_state=True)
        h = h + like(out, h)
        new_cache = {"state": state, "conv": conv}
    else:
        out, (state, conv) = ssm_decode_step(p["ssm"], x, (cache["state"], cache["conv"]), spec)
        h = h + like(out, h)
        cache["state"].copy_(state)
        cache["conv"].copy_(conv)
        new_cache = cache
    if kind == "ssm_shared_attn":
        h, sa = _shared_attn_block(shared, h, cfg, mode=mode, positions=positions,
                                   cache=None if cache is None else cache["sa"],
                                   cur_pos=cur_pos, cache_len=cache_len)
        if mode == "prefill":
            new_cache["sa"] = sa
    return h, new_cache


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _layer(p: Dict, h, cfg: ModelConfig, kind: str, *, shared=None, vision_states=None, **kw):
    """One layer: an SSM block, or attention then the MLP, each added to
    the residual stream. Returns (h, the layer's new cache, the MoE's aux
    loss or None)."""
    if kind in SSM_KINDS:
        return (*_ssm_layer(p, h, cfg, kind, shared=shared, **kw), None)
    attn_out, new_cache = _attn_block(p, h, cfg, kind, vision_states=vision_states, **kw)
    h = h + like(attn_out, h)
    mlp_out, aux = _mlp_block(p, h, cfg, kind)
    return h + like(mlp_out, h), new_cache, aux


def _train_layer(h, positions, vision_states, *leaves, layer_def, shared_def, cfg: ModelConfig,
                 kind: str):
    """One layer in training from flat leaves (the checkpoint's inputs):
    the layer's, then the shared block's where the layer applies it.
    Returns (h, aux or None)."""
    n = layer_def.num_leaves
    shared = None if shared_def is None else tree_unflatten(shared_def, leaves[n:])
    h, _, aux = _layer(tree_unflatten(layer_def, leaves[:n]), h, cfg, kind, mode="train",
                       positions=positions, cache=None, cur_pos=None,
                       vision_states=vision_states, cache_len=h.shape[1], shared=shared)
    return h, aux


def _group_slices(tree, n: int) -> List:
    """The n slices of a dict tree whose leaves are stacked on a leading
    axis of n: per group, the same tree of that group's views (one unbind
    per leaf, so the gradients land in the stacked leaves)."""
    if isinstance(tree, dict):
        per_key = {k: _group_slices(v, n) for k, v in tree.items()}
        return [{k: sl[g] for k, sl in per_key.items()} for g in range(n)]
    return tree.unbind(0)


def _stack(params: PyTree, cfg: ModelConfig, h, *, mode: str, positions, caches, cur_pos,
           vision_states, cache_len: Optional[int], remat: bool = False):
    """Every layer in order, group-major. Returns (h, caches, aux): prefill
    builds the caches, decode writes into the ones given, train returns
    None; aux is the MoE layers' aux losses summed in layer order (None
    without MoE).

    Training with remat runs each layer under an activation checkpoint,
    so the backward keeps only the residual stream entering each layer and
    recomputes the layer's inside. The reference checkpoints its scan body
    and nests the scan two levels deep (sqrt-L), a memory layout of XLA's
    with the same values; one checkpoint per layer is its counterpart.
    The shared block's leaves enter each applying layer's checkpoint as
    inputs, so their gradients from every application add up in them."""
    pattern = cfg.layer_pattern
    n = cfg.n_groups
    shared = params.get("shared_attn")
    shared_leaves, shared_def = tree_flatten(shared) if shared is not None else ([], None)
    per_pos = [_group_slices(layers, n) for layers in params["groups"]]
    cache_pos = None if caches is None else [_group_slices(c, n) for c in caches]
    new = [[] for _ in pattern]
    aux = None
    for g in range(n):
        h = dist_ctx.constrain("activations", h)
        for pos, kind in enumerate(pattern):
            layer = per_pos[pos][g]
            if mode == "train":
                leaves, layer_def = tree_flatten(layer)
                applies = kind == "ssm_shared_attn"
                fn = functools.partial(_train_layer, layer_def=layer_def,
                                       shared_def=shared_def if applies else None,
                                       cfg=cfg, kind=kind)
                args = (h, positions, vision_states, *leaves,
                        *(shared_leaves if applies else ()))
                if remat and _needs_grad(*args):
                    h, a = checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
                else:
                    h, a = fn(*args)
            else:
                cache = None if cache_pos is None else cache_pos[pos][g]
                h, nc, a = _layer(layer, h, cfg, kind, mode=mode, positions=positions,
                                  cache=cache, cur_pos=cur_pos, vision_states=vision_states,
                                  cache_len=cache_len, shared=shared)
                new[pos].append(nc)
            if a is not None:
                aux = a if aux is None else aux + a
    if mode == "prefill":
        caches = tuple(tree_map(lambda *cs: torch.stack(cs), *per) for per in new)
    return h, caches, aux


def _inputs_to_h(params, cfg: ModelConfig, batch: Dict):
    """Token ids through the embedding, or (embed_input=False, musicgen)
    the batch's precomputed embeddings in the model's dtype."""
    if cfg.embed_input:
        return embed(batch["inputs"], params["embed"], cfg.scale_embedding)
    return batch["embeds"].to(_dt(cfg))


def _logits(params, cfg: ModelConfig, h):
    h = gather_seq(rms_norm(h, params["final_norm"], cfg.norm_eps))
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return softcap(unembed(h, table, cfg.tie_embeddings).float(), cfg.final_softcap)


def _xent_chunk(hh, tt, table, *, cfg: ModelConfig):
    """Summed NLL and counted targets of one sequence chunk."""
    logits = dist_ctx.constrain("logits_chunk", unembed(hh, table, cfg.tie_embeddings).float())
    logits = softcap(logits, cfg.final_softcap)
    tgt = tt.clamp(0, cfg.vocab_size - 1).long()
    if hasattr(logits, "device_mesh"):
        # The vocab-parallel form (Megatron's): the vocab may be sharded, so
        # the max, the sum of exponentials and the picked logit reduce over
        # it as partial sums (no gather of the chunk's logits).
        whole = dist_ctx.whole_on_model
        top = whole(logits.detach().amax(dim=-1, keepdim=True))
        lse = torch.log(whole(torch.exp(logits - top).sum(dim=-1))) + top[..., 0]
        hit = tgt[..., None] == torch.arange(cfg.vocab_size, device=tgt.device)
        picked = whole((logits * hit).sum(dim=-1))
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
    mask = (tt >= 0).float()
    return ((lse - picked) * mask).sum(), mask.sum()


def chunked_xent(params, cfg: ModelConfig, h, targets, chunk: int = 512):
    """Mean cross-entropy over targets >= 0 without holding (B, S, V)
    float32 logits: the sequence is taken ``chunk`` positions at a time,
    and under autograd each chunk's logits are recomputed in the backward
    (an activation checkpoint per chunk, as the reference's
    jax.checkpoint on its chunk body). Returns (mean loss, counted
    targets)."""
    h = gather_seq(rms_norm(h, params["final_norm"], cfg.norm_eps))
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    body = functools.partial(_xent_chunk, cfg=cfg)
    remat = _needs_grad(h, table)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        args = (h[:, c0: c0 + chunk], targets[:, c0: c0 + chunk], table)
        if remat:
            nll, n = checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            nll, n = body(*args)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0), cnt


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def forward_train(params, cfg: ModelConfig, batch: Dict, remat: bool = True,
                  loss_chunk: int = 512):
    """batch {'inputs' (B, S) int | 'embeds' (B, S, D), 'targets' (B, S)
    int, optional 'vision_states' (B, N, D)}. Returns (loss + 0.01 * the
    MoE aux loss, metrics) as the reference does (aux is 0 without MoE).
    Differentiable in every parameter leaf; with ``remat`` each layer is
    an activation checkpoint. Without autograd (no leaf requires grad, or
    under torch.no_grad) it only scores."""
    h = _inputs_to_h(params, cfg, batch)
    b, s = h.shape[:2]
    h, _, aux = _stack(params, cfg, h, mode="train", positions=_positions(b, s, h.device),
                       caches=None, cur_pos=None, vision_states=batch.get("vision_states"),
                       cache_len=s, remat=remat)
    loss, n_tok = chunked_xent(params, cfg, h, batch["targets"], chunk=loss_chunk)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux, "tokens": n_tok}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: Dict, cache_len: Optional[int] = None):
    """batch as forward_train's, without targets. Returns (last-position
    logits (B, V) float32, caches, last_pos (B,))."""
    h = _inputs_to_h(params, cfg, batch)
    b, s = h.shape[:2]
    h, caches, _ = _stack(params, cfg, h, mode="prefill",
                          positions=_positions(b, s, h.device), caches=None, cur_pos=None,
                          vision_states=batch.get("vision_states"), cache_len=cache_len or s)
    logits = _logits(params, cfg, h[:, -1:, :])[:, 0]
    return logits, caches, torch.full((b,), s - 1, dtype=torch.int32, device=h.device)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: Dict, caches, cur_pos):
    """One decode step. batch {'inputs' (B, 1) | 'embeds' (B, 1, D)};
    cur_pos (B,) the position of the new token. Writes its K/V (an SSM
    layer its state and conv tail) into ``caches`` and returns (logits
    (B, V) float32, caches). Cross layers read the vision K/V their
    prefill cached."""
    h = _inputs_to_h(params, cfg, batch)
    cur_pos = cur_pos.long()
    # Each layer takes its cache's own length at decode.
    h, caches, _ = _stack(params, cfg, h, mode="decode", positions=cur_pos[:, None],
                          caches=caches, cur_pos=cur_pos, vision_states=None, cache_len=None)
    return _logits(params, cfg, h)[:, 0], caches


def init_caches(params, cfg: ModelConfig, batch: int, cache_len: int, n_img: int = 0) -> Tuple:
    """Zero caches on the parameters' device, for decode from scratch: per
    pattern position {"k", "v"} with min(window, cache_len) slots for a
    local layer and ``n_img`` for a cross layer; for an SSM layer its
    float32 {"state", "conv"}, and the shared block's {"k", "v"} under
    "sa" where the layer applies it."""
    dev = params["final_norm"].device
    g = cfg.n_groups

    def kv(length, heads, head_dim):
        shape = (g, batch, length, heads, head_dim)
        return {"k": torch.zeros(shape, dtype=_dt(cfg), device=dev),
                "v": torch.zeros(shape, dtype=_dt(cfg), device=dev)}

    per_pos = []
    for kind in cfg.layer_pattern:
        if kind in SSM_KINDS:
            spec = spec_from_cfg(cfg)
            c = {"state": torch.zeros((g, batch, spec.n_heads, spec.d_state, spec.head_dim),
                                      device=dev),
                 "conv": torch.zeros((g, batch, spec.d_conv - 1, spec.conv_dim), device=dev)}
            if kind == "ssm_shared_attn":
                c["sa"] = kv(cache_len, cfg.shared_attn_kv_heads,
                             cfg.d_model // cfg.shared_attn_heads)
            per_pos.append(c)
        else:
            length = {"local": min(cfg.window, cache_len), "cross": n_img}.get(kind, cache_len)
            per_pos.append(kv(length, cfg.n_kv_heads, cfg.head_dim_))
    return tuple(per_pos)


def cast_params(params: PyTree, dtype: torch.dtype) -> PyTree:
    """The same tree with every leaf cast to ``dtype``, but the leaves the
    reference keeps in float32 (``FLOAT32_LEAVES``)."""
    if isinstance(params, dict):
        return {k: v if k in FLOAT32_LEAVES else cast_params(v, dtype)
                for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return tuple(cast_params(v, dtype) for v in params)
    return params.to(dtype)


def _leaves(tree: PyTree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


class Model(nn.Module):
    """The entry points bound to one parameter tree, whose leaves are the
    module's buffers (so ``.to()`` moves them). ``loss`` is differentiable
    in the buffers that require grad."""

    def __init__(self, cfg: ModelConfig, params: PyTree):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self._names = []
        for path, t in _leaves(params):
            name = path.replace(".", "__")
            self.register_buffer(name, t)
            self._names.append((path, name))

    @property
    def params(self) -> PyTree:
        tree: Dict[str, Any] = {}
        for path, name in self._names:
            node, keys = tree, path.split(".")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = getattr(self, name)
        tree["groups"] = tuple(tree["groups"][str(i)] for i in range(len(tree["groups"])))
        return tree

    def forward(self, batch: Dict):
        return forward_train(self.params, self.cfg, batch)

    def loss(self, batch: Dict, remat: bool = True):
        return forward_train(self.params, self.cfg, batch, remat=remat)

    def prefill(self, batch: Dict, cache_len: Optional[int] = None):
        return prefill(self.params, self.cfg, batch, cache_len)

    def decode_step(self, batch: Dict, caches, cur_pos):
        return decode_step(self.params, self.cfg, batch, caches, cur_pos)
