"""Sharding-constraint context; the PyTorch port of the reference's
distributed/ctx.py.

Model code stays mesh-agnostic: a step built on a mesh runs its body in
``sharding_context(mesh, rules)``, and the model calls
``constrain(name, x)`` at the few points where the layout is pinned (the
residual stream, the MoE expert buffers, the loss's logits chunks).
Outside a context, or on a tensor that is not a DTensor, these return
their input, so single-device runs never touch mesh machinery. Inside,
the DTensor is redistributed to the rule's placements (the counterpart
of the reference's with_sharding_constraint).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

from .sharding import P, dp_axes, dp_size, model_axis_size, to_placements

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sharding_ctx",
                                                      default=None)


@contextlib.contextmanager
def sharding_context(mesh, rules: Dict[str, P]):
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def constrain(name: str, x):
    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = rules.get(name)
    if spec is None:
        return x
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def current_mesh():
    """The mesh of the enclosing context, if any (modules that switch to
    explicit per-shard code read it, e.g. the MoE dispatch)."""
    ctx = _CTX.get()
    return None if ctx is None else ctx[0]


def default_rules(cfg, mesh, global_batch: int, seq_parallel: bool = False,
                  seq_len: int = 0) -> Dict[str, P]:
    """The standard rule set, from the same divisibility logic as
    sharding.py. seq_parallel: Megatron-style sequence parallelism — the
    residual stream lives S-sharded over 'model' between blocks."""
    dp = dp_axes(mesh)
    b = dp if global_batch % dp_size(mesh) == 0 else None
    nm = model_axis_size(mesh)
    vocab_ok = cfg.vocab_size % nm == 0
    experts_ok = cfg.n_experts and cfg.n_experts % nm == 0
    sp = seq_parallel and seq_len > 0 and seq_len % nm == 0
    rules = {
        "activations": P(b, "model" if sp else None, None),
        "logits_chunk": P(b, None, "model" if vocab_ok else None),
        "microbatch_2d": P(b, None),
        "microbatch_3d": P(b, None, None),
    }
    if experts_ok:
        rules["moe_buf"] = P("model", None, None)
    if any(k.startswith("ssm") for k in cfg.layer_pattern):
        from ..models.ssm import spec_from_cfg

        spec = spec_from_cfg(cfg)
        if spec.n_heads % nm == 0 and spec.d_inner % nm == 0:
            rules["ssm_x4"] = P(b, None, "model", None)
            rules["ssm_heads3"] = P(b, None, "model")
    return rules


def _placements(spec, mesh):
    if spec is None or isinstance(spec, P):
        return None if spec is None else to_placements(spec, mesh)
    return tuple(spec)


def per_shard(fn, args, in_specs, out_specs, grad_specs=None):
    """``fn`` on each rank's local shards: the counterpart of the
    reference's shard_map for a block written on plain tensors. Each
    DTensor of ``args`` is redistributed to its entry of ``in_specs`` (a
    ``P``, or a tuple of placements) and passed as its local tensor;
    other arguments pass as they are. ``fn`` returns a tensor or a tuple,
    wrapped as DTensors by ``out_specs`` (a ``P`` or placements per
    output, ``Partial`` among them for a partial sum that DTensor reduces
    when it is read). ``grad_specs`` are the placements of the inputs'
    local gradients (default: their forward placements); an input that
    is replicated on a mesh dim over which the outputs are sharded or
    partial has a partial gradient there. Without DTensor arguments ``fn``
    runs as it is."""
    from torch.distributed.tensor import DTensor

    dt = [a for a in args if isinstance(a, DTensor)]
    if not dt:
        return fn(*args)
    mesh = dt[0].device_mesh
    local = []
    for i, (a, spec) in enumerate(zip(args, in_specs)):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        pl = _placements(spec, mesh) or tuple(a.placements)
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        g = None if grad_specs is None else _placements(grad_specs[i], mesh)
        local.append(a.to_local(grad_placements=g))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    specs = (out_specs,) if single else out_specs
    wrapped = tuple(
        o if s is None else DTensor.from_local(o, mesh, _placements(s, mesh), run_check=False)
        for o, s in zip(outs, specs))
    return wrapped[0] if single else wrapped


def is_sharded(t, dim: int, axis: str = "model") -> bool:
    """Whether DTensor ``t``'s dim ``dim`` shards over mesh axis ``axis``."""
    from torch.distributed.tensor import Shard

    names = t.device_mesh.mesh_dim_names
    return axis in names and t.placements[names.index(axis)] == Shard(dim)


def batch_layout(t, model_dim=None):
    """Placements keeping DTensor ``t``'s batch (dim 0) sharding over the
    data axes, with Shard(model_dim) (or Replicate) on 'model'."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if name == "model":
            out.append(Replicate() if model_dim is None else Shard(model_dim))
        else:
            out.append(Shard(0) if p == Shard(0) else Replicate())
    return tuple(out)


def whole_on_model(x):
    """A DTensor replicated over 'model', its batch sharding kept: a
    reduction over a dim sharded there (a partial sum or max) completed by
    an all-reduce, stated so that DTensor does not scatter it onto another
    dim instead. A plain tensor passes."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    pl = batch_layout(x)
    return x if tuple(x.placements) == pl else x.redistribute(x.device_mesh, pl)
