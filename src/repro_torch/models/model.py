"""The dense decoder stack of the analytics LM; the PyTorch port of the
reference's models/model.py, cut to what the dense ``llcysa`` config
calls (global attention with RoPE, the GLU MLP, tied or untied
embeddings, optional soft-capping). The MoE, SSM, cross-attention and
local-window layers wait for a later slice.

Parameters keep the reference's tree: {"embed", ["lm_head"],
"final_norm", "groups": (layer dict,)}, each layer leaf stacked over the
layers on a leading axis, so models/carry.py maps the reference's tree
one to one. The reference scans over that axis; here a Python loop walks
the layers, each taking its slice of every stacked leaf (a view, so the
gradients land in the stacked leaf).

Entry points:
  forward_train   causal forward + chunked cross-entropy, differentiable
                  (remat: one activation checkpoint per layer)
  prefill         forward returning per-layer KV caches (no autograd)
  decode_step     one token against the caches, written in place (no
                  autograd)

Caches mirror the reference's: a tuple per layer-pattern position of
{"k", "v"} tensors (n_layers, B, L, n_kv, head_dim). The port has one
GPU and no mesh, so the reference's sharding constraints are gone.
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
from .attention import decode_attention, flash_attention
from .layers import apply_rope, embed, mlp_glu, rms_norm, softcap, unembed

PyTree = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config that needs a layer this slice has not ported."""
    missing = [name for name, cut in (
        ("layer_pattern other than ('global',)", tuple(cfg.layer_pattern) != ("global",)),
        ("MoE", cfg.n_experts > 0),
        ("precomputed embeddings", not cfg.embed_input),
        ("plain MLP", cfg.mlp_type != "glu"),
        ("qkv bias", cfg.qkv_bias),
        ("qk norm", cfg.qk_norm),
        ("sandwich norm", cfg.sandwich_norm),
        ("shared attention", cfg.shared_attn_heads > 0),
    ) if cut]
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(missing)}")


# =====================================================================
# Parameter init
# =====================================================================
def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> PyTree:
    """Seeded random parameters (no weights exist in the repository): the
    reference's shapes and scales, drawn from ``generator`` on its own
    device, then moved to ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dt(cfg)
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    nh, nkv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_groups

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, device=generator.device) * std
        return x.to(device=dev, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    params: Dict[str, Any] = {"embed": normal((cfg.vocab_size, d), 0.02)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    params["final_norm"] = zeros(d)
    std = 1.0 / math.sqrt(d)
    params["groups"] = ({
        "norm": zeros(n, d),
        "wq": normal((n, d, nh * hd), std),
        "wk": normal((n, d, nkv * hd), std),
        "wv": normal((n, d, nkv * hd), std),
        "wo": normal((n, nh * hd, d), std),
        "mlp_norm": zeros(n, d),
        "wi_gate": normal((n, d, ff), std),
        "wi_up": normal((n, d, ff), std),
        "wo_mlp": normal((n, ff, d), 1.0 / math.sqrt(ff)),
    },)
    return params


# =====================================================================
# Layer application
# =====================================================================
def _attn_block(p: Dict, h, cfg: ModelConfig, *, mode: str, positions, cache: Optional[Dict],
                cur_pos, cache_len: int):
    """One global attention layer. Returns (attn_out, new_cache); at
    decode the new token's K/V are written into ``cache`` in place."""
    b, s, _ = h.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x = rms_norm(h, p["norm"], cfg.norm_eps)
    q = apply_rope((x @ p["wq"]).reshape(b, s, nh, hd), positions, cfg.rope_theta)
    k_new = apply_rope((x @ p["wk"]).reshape(b, s, nkv, hd), positions, cfg.rope_theta)
    v_new = (x @ p["wv"]).reshape(b, s, nkv, hd)
    if mode == "train":
        out = flash_attention(q, k_new, v_new, causal=True, softcap_val=cfg.attn_softcap,
                              scale=cfg.attn_scale)
        new_cache = None
    elif mode == "prefill":
        out = flash_attention(q, k_new, v_new, causal=True, softcap_val=cfg.attn_softcap,
                              scale=cfg.attn_scale)
        if s > cache_len:
            raise ValueError(f"prompt of {s} tokens exceeds cache_len {cache_len}")
        kc = k_new.new_zeros((b, cache_len, nkv, hd))
        vc = v_new.new_zeros((b, cache_len, nkv, hd))
        kc[:, :s] = k_new
        vc[:, :s] = v_new
        new_cache = {"k": kc, "v": vc}
    else:  # decode
        bidx = torch.arange(b, device=h.device)
        cache["k"][bidx, cur_pos] = k_new[:, 0]
        cache["v"][bidx, cur_pos] = v_new[:, 0]
        out = decode_attention(q, cache["k"], cache["v"], cur_pos,
                               softcap_val=cfg.attn_softcap, scale=cfg.attn_scale)
        new_cache = cache
    return out.reshape(b, s, nh * hd) @ p["wo"], new_cache


def _mlp_block(p: Dict, h, cfg: ModelConfig):
    x = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    return mlp_glu(x, p["wi_gate"], p["wi_up"], p["wo_mlp"], cfg.act)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _layer(p: Dict, h, cfg: ModelConfig, **attn_kw):
    """One layer: attention then MLP, each added to the residual stream.
    Returns (h, the layer's new cache)."""
    attn_out, new_cache = _attn_block(p, h, cfg, **attn_kw)
    h = h + attn_out
    return h + _mlp_block(p, h, cfg), new_cache


def _train_layer(h, positions, *leaves, names, cfg: ModelConfig):
    return _layer(dict(zip(names, leaves)), h, cfg, mode="train", positions=positions,
                  cache=None, cur_pos=None, cache_len=h.shape[1])[0]


def _stack(params: PyTree, cfg: ModelConfig, h, *, mode: str, positions, caches, cur_pos,
           cache_len: int, remat: bool = False):
    """Every layer in order. Returns (h, caches): prefill builds them,
    decode writes into the ones given, train returns None.

    Training with remat runs each layer under an activation checkpoint,
    so the backward keeps only the residual stream entering each layer and
    recomputes the layer's inside. The reference checkpoints its scan body
    and nests the scan two levels deep (sqrt-L), a memory layout of XLA's
    with the same values; one checkpoint per layer is its counterpart."""
    layers = params["groups"][0]
    names = tuple(layers)
    per_layer = list(zip(*(layers[k].unbind(0) for k in names)))
    new = []
    for i, leaves in enumerate(per_layer):
        if mode == "train":
            fn = functools.partial(_train_layer, names=names, cfg=cfg)
            if remat and _needs_grad(h, *leaves):
                h = checkpoint(fn, h, positions, *leaves, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = fn(h, positions, *leaves)
            continue
        cache = None if caches is None else {k: v[i] for k, v in caches[0].items()}
        h, nc = _layer(dict(zip(names, leaves)), h, cfg, mode=mode, positions=positions,
                       cache=cache, cur_pos=cur_pos, cache_len=cache_len)
        new.append(nc)
    if mode == "prefill":
        caches = ({"k": torch.stack([c["k"] for c in new]),
                   "v": torch.stack([c["v"] for c in new])},)
    return h, caches


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
    """batch {'inputs' (B, S), 'targets' (B, S)} int. Returns (loss,
    metrics) as the reference does (the dense stack has no auxiliary
    loss). Differentiable in every parameter leaf; with ``remat`` each
    layer is an activation checkpoint. Without autograd (no leaf requires
    grad, or under torch.no_grad) it only scores."""
    h = embed(batch["inputs"], params["embed"], cfg.scale_embedding)
    b, s = h.shape[:2]
    h, _ = _stack(params, cfg, h, mode="train", positions=_positions(b, s, h.device),
                  caches=None, cur_pos=None, cache_len=s, remat=remat)
    loss, n_tok = chunked_xent(params, cfg, h, batch["targets"], chunk=loss_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux, "tokens": n_tok}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: Dict, cache_len: Optional[int] = None):
    """Returns (last-position logits (B, V) float32, caches, last_pos (B,))."""
    h = embed(batch["inputs"], params["embed"], cfg.scale_embedding)
    b, s = h.shape[:2]
    h, caches = _stack(params, cfg, h, mode="prefill", positions=_positions(b, s, h.device),
                       caches=None, cur_pos=None, cache_len=cache_len or s)
    logits = _logits(params, cfg, h[:, -1:, :])[:, 0]
    return logits, caches, torch.full((b,), s - 1, dtype=torch.int32, device=h.device)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: Dict, caches, cur_pos):
    """One decode step. batch {'inputs' (B, 1)}; cur_pos (B,) the position
    of the new token. Writes its K/V into ``caches`` and returns
    (logits (B, V) float32, caches)."""
    h = embed(batch["inputs"], params["embed"], cfg.scale_embedding)
    cur_pos = cur_pos.long()
    h, caches = _stack(params, cfg, h, mode="decode", positions=cur_pos[:, None],
                       caches=caches, cur_pos=cur_pos, cache_len=caches[0]["k"].shape[2])
    return _logits(params, cfg, h)[:, 0], caches


def init_caches(params, cfg: ModelConfig, batch: int, cache_len: int) -> Tuple:
    """Zero caches on the parameters' device, for decode from scratch."""
    shape = (cfg.n_groups, batch, cache_len, cfg.n_kv_heads, cfg.head_dim_)
    dev = params["embed"].device
    return ({"k": torch.zeros(shape, dtype=_dt(cfg), device=dev),
             "v": torch.zeros(shape, dtype=_dt(cfg), device=dev)},)


def cast_params(params: PyTree, dtype: torch.dtype) -> PyTree:
    """The same tree with every leaf cast to ``dtype``."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
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
