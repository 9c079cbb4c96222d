"""AdamW with float32 state over (possibly bf16) parameters, global-norm
clipping, a linear-warmup cosine schedule and optional error-feedback
gradient compression; the PyTorch port of the reference's
training/optimizer.py.

Gradient compression: gradients quantize to bf16 with a float32
error-feedback accumulator before entering Adam (EF-SGD, Karimireddy et
al.); the error buffer makes the compression unbiased over time.

Trees are walked in JAX's flatten order (repro_torch/tree.py), and every
scalar of the update is float32, as in the reference (constants are
rounded to float32 on the host, so no update copies a scalar to the
card), so the values are the reference's up to float rounding. The
update runs without autograd and returns new tensors; the inputs are left
as they were.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from ..tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    compress_grads: bool = False  # bf16 + error feedback


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), float32: linear
    warmup, then cosine decay to a tenth of ``lr``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params: PyTree, cfg: OptConfig) -> PyTree:
    """{'step': int32 0, 'm', 'v' (and with compression 'err'): float32
    zeros shaped like the parameters, on their devices}."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = tree_flatten(params)[0]
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
    }
    if cfg.compress_grads:
        state["err"] = tree_map(zeros32, params)
    return state


def _global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_flatten(tree)[0]]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, state: PyTree,
                 cfg: OptConfig) -> Tuple[PyTree, PyTree, dict]:
    """One AdamW step. Returns (new params in their dtypes, new state,
    {'grad_norm' (before the clip), 'lr'})."""
    step = state["step"] + 1  # int32 + Python int stays int32
    lr = schedule(cfg, step)

    flat_p, treedef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} parameters")
    new_err = None
    if cfg.compress_grads:
        # Error-feedback bf16 compression: g_c = bf16(g + err); err += g - g_c.
        g32 = [g.float() + e for g, e in zip(flat_g, tree_flatten(state["err"])[0])]
        flat_g = [g.to(torch.bfloat16).float() for g in g32]
        new_err = tree_unflatten(treedef, [a - b for a, b in zip(g32, flat_g)])

    gnorm = _global_norm(flat_g)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = np.float32(cfg.b1), np.float32(cfg.b2)
    c1 = 1.0 - float(b1) ** step.float()
    c2 = 1.0 - float(b2) ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = float(b1) * m + float(1 - b1) * g
        v = float(b2) * v + float(1 - b2) * g * g
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, tree_flatten(state["m"])[0],
                                                 tree_flatten(state["v"])[0])]
    new_state = {
        "step": step,
        "m": tree_unflatten(treedef, [o[1] for o in out]),
        "v": tree_unflatten(treedef, [o[2] for o in out]),
    }
    if new_err is not None:
        new_state["err"] = new_err
    return tree_unflatten(treedef, [o[0] for o in out]), new_state, {"grad_norm": gnorm,
                                                                      "lr": lr}
