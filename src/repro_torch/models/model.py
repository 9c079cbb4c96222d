"""The decoder stack of the LM; the PyTorch port of the reference's
models/model.py, cut to its attention-side layers: global layers,
sliding-window local layers with ring caches, and gated cross-attention
layers over vision states, with the options the configs set (qkv bias,
qk norm, sandwich norms, soft-capping, a local RoPE base, attention
scale, the GLU or plain MLP, tied or untied embeddings, precomputed input
embeddings). The MoE, SSM and shared-attention layers wait for a later
slice (``check_supported``).

Parameters keep the reference's tree: {["embed"], ["lm_head"],
"final_norm", "groups": (one layer dict per position of the layer
pattern)}, each layer leaf stacked over the pattern's n_groups
repetitions on a leading axis, so models/carry.py maps the reference's
tree one to one. The reference scans over that axis; here a Python loop
walks the layers group-major (group g runs pattern positions 0..P-1,
layer g * P + p), each taking its slice of every stacked leaf (a view,
so the gradients land in the stacked leaf).

Entry points:
  forward_train   causal forward + chunked cross-entropy, differentiable
                  (remat: one activation checkpoint per layer)
  prefill         forward returning per-layer KV caches (no autograd)
  decode_step     one token against the caches, written in place (no
                  autograd)

Caches mirror the reference's: a tuple per layer-pattern position of
{"k", "v"} tensors (n_groups, B, L, n_kv, head_dim), with L the cache
length for global layers, min(window, cache length) for local layers (a
ring: position p sits in slot p % L) and the image tokens for cross
layers. The port has one GPU and no mesh, so the reference's sharding
constraints are gone.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from .attention import decode_attention, flash_attention, ring_slot_positions
from .layers import apply_rope, embed, mlp_glu, mlp_plain, rms_norm, softcap, unembed

PyTree = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Leaves the reference keeps in float32 whatever the model's dtype.
FLOAT32_LEAVES = frozenset({"gate_attn", "gate_mlp"})


def _dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config that needs a layer this port has not ported."""
    missing = [name for name, cut in (
        ("MoE", cfg.n_experts > 0),
        ("SSM layers", any(k in ("ssm", "ssm_shared_attn") for k in cfg.layer_pattern)),
        ("shared attention", cfg.shared_attn_heads > 0),
    ) if cut]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(missing)}")


# =====================================================================
# Parameter init
# =====================================================================
def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> PyTree:
    """Seeded random parameters (no weights exist in the repository): the
    reference's shapes, scales and dtypes, drawn in float32 from
    ``generator`` on its own device (a CUDA generator keeps the draw off
    the host), then cast and moved to ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dt(cfg)
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    nh, nkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_groups

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=generator.device).mul_(std)
        return x.to(device=dev, dtype=dt)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def layer(kind: str) -> Dict[str, torch.Tensor]:
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
        params["embed"] = normal((cfg.vocab_size, d), 0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    params["final_norm"] = zeros(d)
    params["groups"] = tuple(layer(kind) for kind in cfg.layer_pattern)
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
    x = rms_norm(h, p["norm"], cfg.norm_eps)
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
            out = decode_attention(q, k, v, every, **attn_kw)
        else:
            out = flash_attention(q, k, v, causal=False, **attn_kw)
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
            out = flash_attention(q, k_new, v_new, causal=True, window=window, **attn_kw)
        if mode == "train":
            new_cache = None
        elif mode == "prefill":
            # A local layer keeps a ring of min(window, cache_len) slots,
            # position t in slot t % slots: a longer prompt leaves its last
            # tokens there. A global layer's cache must hold the prompt.
            slots = min(window, cache_len) if local else cache_len
            if not local and s > cache_len:
                raise ValueError(f"prompt of {s} tokens exceeds cache_len {cache_len}")
            kc = k_new.new_zeros((b, slots, nkv, hd))
            vc = v_new.new_zeros((b, slots, nkv, hd))
            if s <= slots:
                kc[:, :s] = k_new
                vc[:, :s] = v_new
            else:
                idx = torch.arange(s - slots, s, device=h.device) % slots
                kc[:, idx] = k_new[:, s - slots:]
                vc[:, idx] = v_new[:, s - slots:]
            new_cache = {"k": kc, "v": vc}
        else:  # decode
            slots = cache["k"].shape[1]
            bidx = torch.arange(b, device=h.device)
            slot = cur_pos % slots if local else cur_pos
            cache["k"][bidx, slot] = k_new[:, 0]
            cache["v"][bidx, slot] = v_new[:, 0]
            slot_pos = ring_slot_positions(cur_pos, slots) if local else None
            out = decode_attention(q, cache["k"], cache["v"], cur_pos, window=window,
                                   slot_positions=slot_pos, **attn_kw)
            new_cache = cache

    out = out.reshape(b, s, nh * hd) @ p["wo"]
    if cfg.sandwich_norm:
        out = rms_norm(out, p["post_norm"], cfg.norm_eps)
    if kind == "cross":
        out = out * torch.tanh(p["gate_attn"]).to(out.dtype)
    return out, new_cache


def _mlp_block(p: Dict, h, cfg: ModelConfig, kind: str):
    x = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    if cfg.mlp_type == "glu":
        out = mlp_glu(x, p["wi_gate"], p["wi_up"], p["wo_mlp"], cfg.act)
    else:
        out = mlp_plain(x, p["wi"], p["wo_mlp"], cfg.act)
    if cfg.sandwich_norm:
        out = rms_norm(out, p["post_mlp_norm"], cfg.norm_eps)
    if kind == "cross":
        out = out * torch.tanh(p["gate_mlp"]).to(out.dtype)
    return out


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _layer(p: Dict, h, cfg: ModelConfig, kind: str, **attn_kw):
    """One layer: attention then MLP, each added to the residual stream.
    Returns (h, the layer's new cache)."""
    attn_out, new_cache = _attn_block(p, h, cfg, kind, **attn_kw)
    h = h + attn_out
    return h + _mlp_block(p, h, cfg, kind), new_cache


def _train_layer(h, positions, vision_states, *leaves, names, cfg: ModelConfig, kind: str):
    return _layer(dict(zip(names, leaves)), h, cfg, kind, mode="train", positions=positions,
                  cache=None, cur_pos=None, vision_states=vision_states,
                  cache_len=h.shape[1])[0]


def _stack(params: PyTree, cfg: ModelConfig, h, *, mode: str, positions, caches, cur_pos,
           vision_states, cache_len: int, remat: bool = False):
    """Every layer in order, group-major. Returns (h, caches): prefill
    builds them, decode writes into the ones given, train returns None.

    Training with remat runs each layer under an activation checkpoint,
    so the backward keeps only the residual stream entering each layer and
    recomputes the layer's inside. The reference checkpoints its scan body
    and nests the scan two levels deep (sqrt-L), a memory layout of XLA's
    with the same values; one checkpoint per layer is its counterpart."""
    pattern = cfg.layer_pattern
    per_pos = []  # per pattern position: leaf names, and per group its leaves
    for layers in params["groups"]:
        names = tuple(layers)
        per_pos.append((names, list(zip(*(layers[k].unbind(0) for k in names)))))
    new = [[] for _ in pattern]
    for g in range(cfg.n_groups):
        for pos, kind in enumerate(pattern):
            names, per_group = per_pos[pos]
            leaves = per_group[g]
            if mode == "train":
                fn = functools.partial(_train_layer, names=names, cfg=cfg, kind=kind)
                if remat and _needs_grad(h, vision_states, *leaves):
                    h = checkpoint(fn, h, positions, vision_states, *leaves, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    h = fn(h, positions, vision_states, *leaves)
                continue
            cache = None if caches is None else {k: v[g] for k, v in caches[pos].items()}
            h, nc = _layer(dict(zip(names, leaves)), h, cfg, kind, mode=mode,
                           positions=positions, cache=cache, cur_pos=cur_pos,
                           vision_states=vision_states, cache_len=cache_len)
            new[pos].append(nc)
    if mode == "prefill":
        caches = tuple({name: torch.stack([c[name] for c in per]) for name in ("k", "v")}
                       for per in new)
    return h, caches


def _inputs_to_h(params, cfg: ModelConfig, batch: Dict):
    """Token ids through the embedding, or (embed_input=False, musicgen)
    the batch's precomputed embeddings in the model's dtype."""
    if cfg.embed_input:
        return embed(batch["inputs"], params["embed"], cfg.scale_embedding)
    return batch["embeds"].to(_dt(cfg))


def _logits(params, cfg: ModelConfig, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return softcap(unembed(h, table, cfg.tie_embeddings).float(), cfg.final_softcap)


def _xent_chunk(hh, tt, table, *, cfg: ModelConfig):
    """Summed NLL and counted targets of one sequence chunk."""
    logits = softcap(unembed(hh, table, cfg.tie_embeddings).float(), cfg.final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = tt.clamp(0, cfg.vocab_size - 1).long()
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
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
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
    int, optional 'vision_states' (B, N, D)}. Returns (loss, metrics) as
    the reference does (the attention-side stack has no auxiliary loss).
    Differentiable in every parameter leaf; with ``remat`` each layer is
    an activation checkpoint. Without autograd (no leaf requires grad, or
    under torch.no_grad) it only scores."""
    h = _inputs_to_h(params, cfg, batch)
    b, s = h.shape[:2]
    h, _ = _stack(params, cfg, h, mode="train", positions=_positions(b, s, h.device),
                  caches=None, cur_pos=None, vision_states=batch.get("vision_states"),
                  cache_len=s, remat=remat)
    loss, n_tok = chunked_xent(params, cfg, h, batch["targets"], chunk=loss_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux, "tokens": n_tok}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: Dict, cache_len: Optional[int] = None):
    """batch as forward_train's, without targets. Returns (last-position
    logits (B, V) float32, caches, last_pos (B,))."""
    h = _inputs_to_h(params, cfg, batch)
    b, s = h.shape[:2]
    h, caches = _stack(params, cfg, h, mode="prefill", positions=_positions(b, s, h.device),
                       caches=None, cur_pos=None, vision_states=batch.get("vision_states"),
                       cache_len=cache_len or s)
    logits = _logits(params, cfg, h[:, -1:, :])[:, 0]
    return logits, caches, torch.full((b,), s - 1, dtype=torch.int32, device=h.device)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: Dict, caches, cur_pos):
    """One decode step. batch {'inputs' (B, 1) | 'embeds' (B, 1, D)};
    cur_pos (B,) the position of the new token. Writes its K/V into
    ``caches`` and returns (logits (B, V) float32, caches). Cross layers
    read the vision K/V their prefill cached."""
    h = _inputs_to_h(params, cfg, batch)
    cur_pos = cur_pos.long()
    # cache_len is not read at decode (each layer takes its cache's own
    # length); like the reference's caches_len it is position 0's, which
    # for gemma2 is the local ring's.
    h, caches = _stack(params, cfg, h, mode="decode", positions=cur_pos[:, None],
                       caches=caches, cur_pos=cur_pos, vision_states=None,
                       cache_len=caches[0]["k"].shape[2])
    return _logits(params, cfg, h)[:, 0], caches


def init_caches(params, cfg: ModelConfig, batch: int, cache_len: int, n_img: int = 0) -> Tuple:
    """Zero caches on the parameters' device, for decode from scratch: one
    {"k", "v"} per pattern position, min(window, cache_len) slots for a
    local layer, ``n_img`` for a cross layer."""
    dev = params["final_norm"].device
    per_pos = []
    for kind in cfg.layer_pattern:
        length = {"local": min(cfg.window, cache_len), "cross": n_img}.get(kind, cache_len)
        shape = (cfg.n_groups, batch, length, cfg.n_kv_heads, cfg.head_dim_)
        per_pos.append({"k": torch.zeros(shape, dtype=_dt(cfg), device=dev),
                        "v": torch.zeros(shape, dtype=_dt(cfg), device=dev)})
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
