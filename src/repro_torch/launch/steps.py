"""Step builders: (config x shape [x mesh]) -> the train, prefill and
decode steps; the PyTorch port of the reference's launch/steps.py.

Without a mesh, build_train_step returns the single-device train step.
With a ``DeviceMesh`` (axes ('data', 'model') or ('pod', 'data',
'model')), a step is a ``BuiltStep``: its function distributes the
parameters, optimizer state, batch and caches to their partition specs
(distributed/sharding.py) as DTensors, runs the same model code inside
``sharding_context(mesh, rules)`` (so the model's ``constrain`` hooks and
the MoE's expert-parallel path are live) and returns its outputs in the
reference's out-shardings: parameters and caches as DTensors laid out by
their specs, logits batch- and vocab-sharded, metrics as plain tensors
holding the replicated value. Adam's m and v shard over the data axes
too (ZeRO-1, ``zero1_specs``, always on a mesh as in the reference,
whose ``--zero1`` cannot be turned off); ``seq_parallel`` shards the residual
stream's sequence over 'model' between layers. Tensors given whole (the
same on every rank, e.g. from one seed) are sliced to the local shard
without communication; DTensors already laid out pass as they are. The
reference's disable_x64 has no counterpart: every tensor of the step has
an explicit 32-bit (or bf16) dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.device import resolve_device
from ..distributed import ctx as dist_ctx
from ..distributed.sharding import (
    P,
    batch_specs,
    cache_specs,
    distribute_tree,
    dp_axes,
    dp_size,
    model_axis_size,
    param_specs,
    spec_map,
    zero1_specs,
)
from ..models.model import _DTYPES, decode_step, forward_train, init_caches, init_params, prefill
from ..training.optimizer import OptConfig, adamw_update
from ..tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any


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
                     device="cuda", mesh=None, seq_parallel: bool = False):
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``device`` (default cuda; raises without CUDA unless
    device='cpu'): value and gradient of forward_train, then AdamW. The
    batch's tensors (or arrays) are moved to the device.

    accum_steps > 1: gradient accumulation; the global batch splits into
    accum_steps microbatches run in turn, their gradients summed in
    float32 and divided by accum_steps, the loss their mean; aux_loss and
    tokens are then reported as 0, as the reference reports them.

    With a ``mesh`` it returns a ``BuiltStep`` over it (the device is the
    mesh's; ZeRO-1 and ``seq_parallel`` as the module says); without one,
    the step function, and ``seq_parallel`` has nothing to shard."""
    opt_cfg = opt_cfg or OptConfig()
    dev = resolve_device(device) if mesh is None else _mesh_device(mesh)
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
        if mesh is None:
            batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if accum_steps == 1:
            loss, metrics, grads = grad_fn(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            mb = batch["targets"].shape[0] // accum_steps
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum_steps):
                # On a mesh, keep each microbatch sharded over the data axes.
                micro = {k: dist_ctx.constrain("microbatch_" + ("3d" if v.ndim == 3 else "2d"),
                                               v[i * mb: (i + 1) * mb])
                         for k, v in batch.items()}
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

    if mesh is None:
        return step
    pshapes = param_shapes(cfg)
    pspecs = param_specs(cfg, mesh)
    ospecs = opt_state_specs(mesh, pspecs, pshapes, opt_cfg)
    bshapes = batch_shapes(cfg, shape)
    bspecs = _filter_tree(batch_specs(cfg, mesh, shape.global_batch), bshapes)
    rules = dist_ctx.default_rules(cfg, mesh, shape.global_batch, seq_parallel=seq_parallel,
                                   seq_len=shape.seq_len)
    in_sh = (pspecs, ospecs, bspecs)
    out_sh = (pspecs, ospecs, None)
    oshapes = opt_state_shapes(pshapes, opt_cfg)
    return BuiltStep(_on_mesh(step, mesh, rules, in_sh, out_sh), (pshapes, oshapes, bshapes),
                     in_sh, out_sh, rules)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _filter_tree(tree: Dict, keys) -> Dict:
    return {k: v for k, v in tree.items() if k in keys}


@dataclass
class BuiltStep:
    """A step on a mesh: ``fn`` (also called by calling the step), the
    abstract arguments (trees of ``TensorSpec``), the partition-spec trees
    of its inputs and outputs (None: plain tensors holding the replicated
    values, the train step's metrics) and the constraint rules it runs
    under."""

    fn: Callable
    abstract_args: Tuple
    in_shardings: PyTree
    out_shardings: PyTree
    rules: Dict

    def __call__(self, *args):
        return self.fn(*args)


def _spec_of(t) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype)


def param_shapes(cfg: ModelConfig) -> PyTree:
    """init_params' tree as ``TensorSpec`` leaves, traced on fake tensors
    (nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return tree_map(_spec_of, params)


def opt_state_shapes(pshapes: PyTree, opt_cfg: OptConfig) -> PyTree:
    """adamw_init's tree as ``TensorSpec`` leaves."""
    f32 = tree_map(lambda s: TensorSpec(s.shape, torch.float32), pshapes)
    st = {"step": TensorSpec((), torch.int32), "m": f32, "v": f32}
    if opt_cfg.compress_grads:
        st["err"] = f32
    return st


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig) -> PyTree:
    """init_caches' tree for one shape cell, as ``TensorSpec`` leaves."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        caches = init_caches({"final_norm": torch.empty(0)}, cfg, shape.global_batch,
                             shape.seq_len, n_img=cfg.n_image_tokens)
    return tree_map(_spec_of, caches)


def opt_state_specs(mesh, pspecs, pshapes, opt_cfg: OptConfig):
    """adamw_init's specs: m and v (and the compression error) ZeRO-1
    sharded, the step count replicated."""
    mv = zero1_specs(pspecs, pshapes, mesh)
    st = {"step": P(), "m": mv, "v": mv}
    if opt_cfg.compress_grads:
        st["err"] = mv
    return st


def _to_out(tree, specs, mesh):
    """Outputs in their out-shardings: DTensors laid out by their specs, or
    for a None spec plain tensors holding the replicated value."""
    from torch.distributed.tensor import DTensor, Replicate

    if specs is not None:
        return spec_map(lambda s, t: distribute_tree(t, s, mesh), specs, tree)
    whole = tuple(Replicate() for _ in mesh.mesh_dim_names)
    return tree_map(lambda t: t.redistribute(mesh, whole).to_local()
                    if isinstance(t, DTensor) else t, tree)


def _on_mesh(step, mesh, rules, in_specs, out_specs):
    """``step`` on DTensors: inputs distributed to ``in_specs``, the body in
    the sharding context, outputs laid out by ``out_specs``."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args):
        with dist_ctx.sharding_context(mesh, rules), implicit_replication():
            args = tuple(a if s is None else distribute_tree(a, s, mesh)
                         for a, s in zip(args, in_specs))
            out = step(*args)
            return tuple(_to_out(o, s, mesh) for o, s in zip(out, out_specs))

    return run


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> BuiltStep:
    """``(params, batch) -> (last-position logits (B, V) float32, caches,
    last_pos)`` with caches of ``shape.seq_len`` positions, on ``mesh``."""
    pshapes = param_shapes(cfg)
    pspecs = param_specs(cfg, mesh)
    bshapes = batch_shapes(cfg, shape)
    bspecs = _filter_tree(batch_specs(cfg, mesh, shape.global_batch), bshapes)
    cspecs = cache_specs(cfg, mesh, shape.global_batch)
    rules = dist_ctx.default_rules(cfg, mesh, shape.global_batch)
    b_ax = _batch_axes(mesh, shape)
    vdiv = cfg.vocab_size % model_axis_size(mesh) == 0

    def step(params, batch):
        return prefill(params, cfg, batch, cache_len=shape.seq_len)

    in_sh = (pspecs, bspecs)
    out_sh = (P(b_ax, "model" if vdiv else None), cspecs, P(b_ax))
    return BuiltStep(_on_mesh(step, mesh, rules, in_sh, out_sh), (pshapes, bshapes), in_sh,
                     out_sh, rules)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh) -> BuiltStep:
    """``(params, batch, caches, cur_pos) -> (logits (B, V) float32,
    caches)`` on ``mesh``; the new token's K/V (an SSM layer's state) are
    written into the caches, which are returned: caches given whole are
    first distributed, so use the returned ones."""
    pshapes = param_shapes(cfg)
    pspecs = param_specs(cfg, mesh)
    bshapes = batch_shapes(cfg, shape)
    bspecs = _filter_tree(batch_specs(cfg, mesh, shape.global_batch), bshapes)
    cshapes = cache_shapes(cfg, shape)
    cspecs = cache_specs(cfg, mesh, shape.global_batch)
    rules = dist_ctx.default_rules(cfg, mesh, shape.global_batch)
    b_ax = _batch_axes(mesh, shape)
    vdiv = cfg.vocab_size % model_axis_size(mesh) == 0
    pos_shape = TensorSpec((shape.global_batch,), torch.int32)

    def step(params, batch, caches, cur_pos):
        return decode_step(params, cfg, batch, caches, cur_pos)

    in_sh = (pspecs, bspecs, cspecs, P(b_ax))
    out_sh = (P(b_ax, "model" if vdiv else None), cspecs)
    return BuiltStep(_on_mesh(step, mesh, rules, in_sh, out_sh),
                     (pshapes, bshapes, cshapes, pos_shape), in_sh, out_sh, rules)


def _batch_axes(mesh, shape: ShapeConfig):
    return dp_axes(mesh) if shape.global_batch % dp_size(mesh) == 0 else None


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw) -> BuiltStep:
    """The step of ``shape``'s kind on ``mesh``."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh=mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    return build_decode_step(cfg, shape, mesh)
