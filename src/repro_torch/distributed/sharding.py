"""Partition-rule trees: cfg + mesh -> partition-spec trees; the PyTorch
port of the reference's distributed/sharding.py.

Axis conventions: batch shards over dp = ('pod', 'data') (or ('data',)
on one pod); tensor and expert parallelism over 'model'. Rules are
divisibility-guarded: anything that does not divide evenly over 'model'
replicates (the Megatron "don't shard what doesn't divide" fallback) —
qwen1.5's 20 heads on a 16-way model axis is the live example.

KV caches: kv-head sharding over 'model' when kv_heads divides;
otherwise the cache's sequence dim shards over 'model'.

A spec is ``P``, a tuple of per-dim entries (None, an axis name, or a
tuple of names), so a spec tree compares with the reference's by
``tuple(spec)``. ``to_placements`` turns one into DTensor placements on
a ``DeviceMesh``: Shard(i) on each mesh dim that shards tensor dim i,
Replicate() on the others. A tensor dim over two mesh axes, ('pod',
'data'), is split pod first, then data, as the reference's
NamedSharding splits it (DTensor applies placements in mesh-dim order).
The spec functions read only the mesh's axis names and sizes, so a
``MeshShape`` stands in for a mesh that does not exist.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig

PyTree = Any


def _entry(p):
    if isinstance(p, (tuple, list)):
        p = tuple(p)
        return None if not p else (p[0] if len(p) == 1 else p)
    return p


class P(tuple):
    """A partition spec: one entry per tensor dim (trailing dims
    replicate). An entry of one axis name in a tuple is that name, and an
    empty tuple None, as the reference's PartitionSpec normalizes them."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(p) for p in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without devices, for the spec
    functions (DeviceMesh has the same two attributes)."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or a MeshShape."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh_axes(mesh).get("model", 1)


def dp_size(mesh) -> int:
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for a in dp_axes(mesh))


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def _ssm_spec(cfg: ModelConfig):
    # Imported here: models/moe.py imports this package's ctx.
    from ..models.ssm import spec_from_cfg

    return spec_from_cfg(cfg)


def spec_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """fn over the specs of a spec tree (dicts and tuples; a ``P`` is a
    leaf) and, leaf for leaf, over trees of the same structure."""
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(spec_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def param_specs(cfg: ModelConfig, mesh) -> Dict:
    """The spec tree mirroring init_params' structure."""
    nm = model_axis_size(mesh)
    hd = cfg.head_dim_
    heads_div = _div(cfg.n_heads * hd, nm) and _div(cfg.n_heads, nm)
    kv_div = _div(cfg.n_kv_heads, nm)
    ff_div = _div(cfg.d_ff, nm)
    vocab_div = _div(cfg.vocab_size, nm)
    experts_div = _div(cfg.n_experts, nm)

    def attn_specs(kind: str) -> Dict:
        s = {
            "norm": P(None),
            "wq": P(None, "model") if heads_div else P(None, None),
            "wk": P(None, "model") if kv_div else P(None, None),
            "wv": P(None, "model") if kv_div else P(None, None),
            "wo": P("model", None) if heads_div else P(None, None),
        }
        if cfg.qkv_bias:
            s["bq"] = P("model") if heads_div else P(None)
            s["bk"] = P("model") if kv_div else P(None)
            s["bv"] = P("model") if kv_div else P(None)
        if cfg.qk_norm:
            s["q_norm"] = P(None)
            s["k_norm"] = P(None)
        if cfg.sandwich_norm:
            s["post_norm"] = P(None)
        if kind == "cross":
            s["gate_attn"] = P()
            s["gate_mlp"] = P()
        return s

    def mlp_specs() -> Dict:
        s: Dict[str, Any] = {"mlp_norm": P(None)}
        if cfg.n_experts:
            e = "model" if experts_div else None
            s["moe"] = {
                "router": P(None, None),
                "wi_gate": P(e, None, None),
                "wi_up": P(e, None, None),
                "wo": P(e, None, None),
            }
        elif cfg.mlp_type == "glu":
            s["wi_gate"] = P(None, "model") if ff_div else P(None, None)
            s["wi_up"] = P(None, "model") if ff_div else P(None, None)
            s["wo_mlp"] = P("model", None) if ff_div else P(None, None)
        else:
            s["wi"] = P(None, "model") if ff_div else P(None, None)
            s["wo_mlp"] = P("model", None) if ff_div else P(None, None)
        if cfg.sandwich_norm:
            s["post_mlp_norm"] = P(None)
        return s

    def ssm_specs() -> Dict:
        spec = _ssm_spec(cfg)
        m = "model" if _div(spec.d_inner, nm) and _div(spec.n_heads, nm) else None
        return {
            "norm": P(None),
            "ssm": {
                "in_z": P(None, m),
                "in_x": P(None, m),
                "in_B": P(None, None),
                "in_C": P(None, None),
                "in_dt": P(None, m),
                "conv_x_w": P(None, m),
                "conv_x_b": P(m),
                "conv_B_w": P(None, None),
                "conv_B_b": P(None),
                "conv_C_w": P(None, None),
                "conv_C_b": P(None),
                "dt_bias": P(m),
                "A_log": P(m),
                "D": P(m),
                "norm": P(m),
                "out_proj": P(m, None),
            },
        }

    def layer_specs(kind: str) -> Dict:
        if kind in ("ssm", "ssm_shared_attn"):
            return ssm_specs()
        return {**attn_specs(kind), **mlp_specs()}

    def add_group_dim(tree):
        return spec_map(lambda p: P(None, *p), tree)

    specs: Dict[str, Any] = {
        "final_norm": P(None),
        "groups": tuple(add_group_dim(layer_specs(k)) for k in cfg.layer_pattern),
    }
    if cfg.embed_input:
        specs["embed"] = P("model", None) if vocab_div else P(None, None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model") if vocab_div else P(None, None)
    if cfg.shared_attn_heads:
        sa_div = _div(cfg.shared_attn_heads, nm) and _div(cfg.shared_attn_kv_heads, nm)
        m = "model" if sa_div else None
        f = "model" if _div(cfg.shared_attn_d_ff, nm) else None
        specs["shared_attn"] = {
            "norm": P(None),
            "wq": P(None, m),
            "wk": P(None, m),
            "wv": P(None, m),
            "wo": P(m, None),
            "mlp_norm": P(None),
            "wi_gate": P(None, f),
            "wi_up": P(None, f),
            "wo_mlp": P(f, None),
        }
    return specs


def batch_specs(cfg: ModelConfig, mesh, global_batch: int) -> Dict:
    """Specs of train and serve input batches (keys optional per family)."""
    bspec = dp_axes(mesh) if _div(global_batch, dp_size(mesh)) else None
    return {
        "inputs": P(bspec, None),
        "targets": P(bspec, None),
        "embeds": P(bspec, None, None),
        "vision_states": P(bspec, None, None),
    }


def cache_specs(cfg: ModelConfig, mesh, global_batch: int) -> Tuple:
    """Specs mirroring init_caches' structure (a dict per pattern
    position)."""
    nm = model_axis_size(mesh)
    b = dp_axes(mesh) if _div(global_batch, dp_size(mesh)) else None
    kv_div = _div(cfg.n_kv_heads, nm)
    per_pos = []
    for kind in cfg.layer_pattern:
        if kind in ("ssm", "ssm_shared_attn"):
            h_div = _div(_ssm_spec(cfg).n_heads, nm)
            c: Dict[str, Any] = {
                "state": P(None, b, "model" if h_div else None, None, None),
                "conv": P(None, b, None, None),
            }
            if kind == "ssm_shared_attn":
                s = (P(None, b, None, "model", None) if _div(cfg.shared_attn_kv_heads, nm)
                     else P(None, b, "model", None, None))
                c["sa"] = {"k": s, "v": s}
            per_pos.append(c)
        elif kind == "cross":
            s = P(None, b, None, "model", None) if kv_div else P(None, b, None, None, None)
            per_pos.append({"k": s, "v": s})
        else:
            s = (P(None, b, None, "model", None) if kv_div
                 else P(None, b, "model", None, None))  # sequence-sharded cache
            per_pos.append({"k": s, "v": s})
    return tuple(per_pos)


def zero1_specs(param_spec_tree, shapes, mesh):
    """ZeRO-1: additionally shard optimizer-state leaves over dp on the
    first replicated dim that divides. Applied to Adam's float32 m and v,
    which dominate training memory. ``shapes``: a tree of the leaves'
    shapes (tensors, or anything with ``.shape``) matching the spec
    tree."""
    dps = dp_size(mesh)
    dp = dp_axes(mesh)

    def upgrade(spec: P, x) -> P:
        shape = tuple(x.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (p, dim) in enumerate(zip(parts, shape)):
            if p is None and dim > 0 and dim % dps == 0:
                parts[i] = dp
                return P(*parts)
        return spec

    return spec_map(upgrade, param_spec_tree, shapes)


def to_placements(spec: P, mesh) -> Tuple:
    """One DTensor placement per mesh dim: Shard(i) where that axis
    shards tensor dim i, Replicate() otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, p in enumerate(spec)
                if p == name or (isinstance(p, tuple) and name in p)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards more than one dim of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` under
    ``spec`` (every sharded dim divides, as the rules guarantee)."""
    axes = mesh_axes(mesh)
    out = list(shape)
    for i, p in enumerate(spec):
        names = p if isinstance(p, tuple) else (() if p is None else (p,))
        for n in names:
            if out[i] % axes[n]:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {n!r}")
            out[i] //= axes[n]
    return tuple(out)


def distribute_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Each tensor of ``tree`` as a DTensor on ``mesh`` laid out by its
    spec. Every rank holds the whole tensor (the same values, as from one
    seed) and keeps its shard; a tensor that already is a DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    dev = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
           else torch.device(mesh.device_type))

    def one(spec, t):
        placements = to_placements(spec, mesh)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == placements else t.redistribute(mesh, placements)
        return distribute_tensor(torch.as_tensor(t, device=dev), mesh, placements,
                                 src_data_rank=None)

    return spec_map(one, specs, tree)


def shard_tree_empty(shapes: PyTree, specs: PyTree, mesh) -> PyTree:
    """DTensors of the given global shapes and dtypes whose local shards
    are uninitialized ``torch.empty`` (the dry-run builds its arguments
    so, under FakeTensorMode, with no collective)."""
    from torch.distributed.tensor import DTensor

    def one(spec, x):
        loc = torch.empty(local_shape(x.shape, spec, mesh), dtype=x.dtype,
                          device=mesh.device_type)
        return DTensor.from_local(loc, mesh, to_placements(spec, mesh), run_check=False,
                                  shape=torch.Size(x.shape),
                                  stride=torch.empty(x.shape, device="meta").stride())

    return spec_map(one, specs, shapes)
