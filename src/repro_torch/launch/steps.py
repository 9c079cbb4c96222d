"""Step builders: (config x shape) -> the train step; the PyTorch port of
the reference's launch/steps.py, on one device and without a mesh.

The reference jits each step with shardings over a mesh. The port runs
on one device, so what the mesh decides there is gone: ``zero1`` (the
optimizer state sharded over the data axes) and ``seq_parallel`` (the
activations sharded over the sequence) have nothing to shard and are
left out. The prefill and decode step builders wait with the dry-run,
which the port does not queue.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.device import resolve_device
from ..models.model import _DTYPES, forward_train
from ..training.optimizer import OptConfig, adamw_update
from ..tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one input, without its data."""

    shape: tuple
    dtype: torch.dtype


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """The input batch of one shape cell."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    out: Dict[str, TensorSpec] = {}
    if cfg.embed_input:
        out["inputs"] = TensorSpec((b, s), torch.int32)
    else:
        out["embeds"] = TensorSpec((b, s, cfg.d_model), _DTYPES[cfg.dtype])
    if shape.kind == "train":
        out["targets"] = TensorSpec((b, s), torch.int32)
    if cfg.family == "vlm":
        out["vision_states"] = TensorSpec((b, cfg.n_image_tokens, cfg.d_model),
                                          _DTYPES[cfg.dtype])
    return out


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, opt_cfg: Optional[OptConfig] = None,
                     remat: bool = True, loss_chunk: int = 512, accum_steps: int = 1,
                     device="cuda") -> Callable:
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``device`` (default cuda; raises without CUDA unless
    device='cpu'): value and gradient of forward_train, then AdamW. The
    batch's tensors (or arrays) are moved to the device.

    accum_steps > 1: gradient accumulation; the global batch splits into
    accum_steps microbatches run in turn, their gradients summed in
    float32 and divided by accum_steps, the loss their mean; aux_loss and
    tokens are then reported as 0, as the reference reports them."""
    opt_cfg = opt_cfg or OptConfig()
    dev = resolve_device(device)
    if shape.global_batch % accum_steps:
        raise ValueError(f"global batch {shape.global_batch} is not a multiple of "
                         f"accum_steps {accum_steps}")

    def grad_fn(params, batch):
        flat, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = forward_train(tree_unflatten(treedef, leaves), cfg, batch,
                                          remat=remat, loss_chunk=loss_chunk)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, tree_unflatten(treedef, list(grads))

    def step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if accum_steps == 1:
            loss, metrics, grads = grad_fn(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            mb = batch["targets"].shape[0] // accum_steps
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
                             params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum_steps):
                micro = {k: v[i * mb: (i + 1) * mb] for k, v in batch.items()}
                l_i, _, g_i = grad_fn(params, micro)
                for a, g in zip(tree_flatten(grads)[0], tree_flatten(g_i)[0]):
                    a.add_(g.float())
                loss = loss + l_i
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            metrics = {"loss": loss, "aux_loss": zero, "tokens": zero}
        new_params, new_opt, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return new_params, new_opt, {**metrics, **opt_metrics, "total_loss": loss}

    return step
