"""Rank bodies of tests/test_torch_distributed.py: four gloo processes on
CPU meshes. Imports torch and repro_torch only (the spawned ranks need no
JAX); rank 0 saves the results for the test process to compare."""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

# tests/test_distributed.py's config; "gqa" one kv head, which does not
# divide the 'model' axis (the kv-slice attention and the sequence-sharded
# cache); "mamba" the SSM (SSD per shard).
VARIANTS = {
    "gemma": ("gemma2-9b", dict(n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512)),
    "gqa": ("gemma2-9b", dict(n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=512)),
    "mamba": ("mamba2-780m", {}),
}
# Train runs per variant: (variant, name, build_train_step options); every
# mesh step shards Adam's m and v over 'data' (ZeRO-1).
TRAIN_RUNS = [
    ("gemma", "zero1", {}),
    ("gemma", "seq_parallel", dict(seq_parallel=True)),
    ("gemma", "accum", dict(accum_steps=2)),
    ("gqa", "zero1", {}),
    ("mamba", "seq_parallel", dict(seq_parallel=True)),
]
RTOL = 1e-5
# A parameter's update differs by more than this share of the step's
# learning rate only where Adam's first steps flip lr x sign(g) for a
# gradient within rounding of zero.
UPDATE_TOL = 0.1


def _cfg(variant):
    from repro_torch.models import get_config

    arch, kw = VARIANTS[variant]
    return get_config(arch, smoke=True).replace(dtype="float32", **kw)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def layout(res):
    """Each rank's local slab of a ('pod', 'data')-sharded batch on a
    (pod=2, data=2, model=1) mesh, with its mesh coordinates."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import P, distribute_tree

    mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    batch = torch.arange(8 * 3, dtype=torch.int32).reshape(8, 3)
    local = distribute_tree(batch, P(("pod", "data"), None), mesh).to_local()
    slabs = [None] * dist.get_world_size()
    dist.all_gather_object(slabs, (mesh.get_coordinate(), local.tolist()))
    res["layout"] = slabs


def mesh_errors(res):
    from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh

    for name, fn in (("production", lambda: make_production_mesh(device_type="cpu")),
                     ("dev", lambda: make_dev_mesh(2, 4, device_type="cpu"))):
        try:
            fn()
            res[f"mesh_error_{name}"] = None
        except ValueError as e:
            res[f"mesh_error_{name}"] = str(e)


def _worst(got, want):
    """The largest |got - want| / (RTOL x (|want| + the leaf's max |want|))
    over a tree's leaves: at most 1 where every element is within rtol
    1e-5, and atol 1e-5 of the leaf's scale."""
    from repro_torch.tree import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a = _full(a)
        tol = RTOL * (b.abs() + b.abs().max())
        worst = max(worst, float(((a - b).abs() / tol.clamp_min(1e-30)).max()))
    return worst


def _update_off_share(after, before, after_plain, before_plain, lr):
    """The share of parameter elements whose update on the mesh differs
    from the single-device one by more than UPDATE_TOL x lr."""
    from repro_torch.tree import tree_leaves

    off = n = 0
    for a, b, ap, bp in zip(*(tree_leaves(t) for t in (after, before, after_plain,
                                                          before_plain))):
        d = (_full(a) - _full(b)) - (ap - bp)
        off += int((d.abs() > UPDATE_TOL * lr).sum())
        n += d.numel()
    return off / n


def train(res, mesh):
    from torch.distributed.tensor import Shard

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import OptConfig, adamw_init
    from repro_torch.tree import tree_leaves, tree_map

    shape = ShapeConfig("t", 64, 4, "train")
    g = torch.Generator().manual_seed(1)
    batch = {"inputs": torch.randint(0, 512, (4, 64), generator=g, dtype=torch.int32),
             "targets": torch.randint(0, 512, (4, 64), generator=g, dtype=torch.int32)}
    opt_cfg = OptConfig()
    res["train_lr"] = [float(x) for x in (opt_cfg.lr / opt_cfg.warmup_steps,
                                          2 * opt_cfg.lr / opt_cfg.warmup_steps)]
    for variant, name, kw in TRAIN_RUNS:
        key = f"{variant}-{name}"
        cfg = _cfg(variant)
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        plain = build_train_step(cfg, shape, opt_cfg, device="cpu",
                                 accum_steps=kw.get("accum_steps", 1))
        built = build_train_step(cfg, shape, opt_cfg, mesh=mesh, **kw)
        p1, o1 = params, adamw_init(params, opt_cfg)
        p2, o2 = params, adamw_init(params, opt_cfg)
        got, state, off = [], [], []
        for i in range(2):
            q1, q2 = p1, p2
            p1, o1, m1 = plain(p1, o1, batch)
            p2, o2, m2 = built(p2, o2, batch)
            got.append([(float(m1[k]), float(m2[k])) for k in ("loss", "grad_norm")])
            # Adam's state after this step: its count, and m and v, which
            # are continuous in the gradient.
            state.append({"step": (int(o1["step"]), int(_full(o2["step"]))),
                          "m": _worst(o2["m"], o1["m"]),
                          "sqrt_v": _worst(tree_map(lambda t: _full(t).sqrt(), o2["v"]),
                                           tree_map(torch.sqrt, o1["v"]))})
            off.append(_update_off_share(p2, q2, p1, q1, float(m1["lr"])))
        res[f"train_{key}"] = got
        res[f"opt_state_{key}"] = state
        res[f"update_off_share_{key}"] = off
        res[f"param_err_{key}"] = max(float((a - _full(b)).abs().max())
                                      for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
        res[f"embed_placements_{key}"] = str(p2["embed"].placements)
        names = mesh.mesh_dim_names
        res[f"m_data_sharded_{key}"] = any(
            isinstance(x.placements[names.index("data")], Shard) for x in tree_leaves(o2["m"]))
        res[f"rules_{key}"] = {k: list(v) for k, v in built.rules.items()}


def launcher(res, mesh):
    """launch/train.py's batch and stop flag on a mesh: each rank offers a
    different batch, as each rank's own pipeline would draw; every rank
    must step on rank 0's, and a stop on one rank must reach all."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import next_batch, stop_anywhere
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import OptConfig, adamw_init

    rank = dist.get_rank()
    shape = ShapeConfig("t", 64, 4, "train")
    drawn = [np.random.default_rng(40 + r).integers(0, 512, (4, 65)).astype(np.int32)
             for r in range(dist.get_world_size())]
    raw = next_batch(iter([drawn[rank]]), shape, torch.device("cpu"), mesh)
    cfg = _cfg("gemma")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = OptConfig()
    _, _, m = build_train_step(cfg, shape, opt_cfg, mesh=mesh)(
        params, adamw_init(params, opt_cfg), {"inputs": raw[:, :-1], "targets": raw[:, 1:]})
    flags = [stop_anywhere(rank == 1, torch.device("cpu"), mesh),
             stop_anywhere(False, torch.device("cpu"), mesh)]
    mine = {"batch_is_rank0s": bool(torch.equal(raw, torch.from_numpy(drawn[0]))),
            "loss": float(m["loss"]), "stop_flags": flags}
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, mine)
    res["launcher_ranks"] = seen
    if rank == 0:
        raw0 = torch.from_numpy(drawn[0])
        _, _, want = build_train_step(cfg, shape, opt_cfg, device="cpu")(
            params, adamw_init(params, opt_cfg), {"inputs": raw0[:, :-1],
                                                  "targets": raw0[:, 1:]})
        res["launcher_plain_loss"] = float(want["loss"])


def serve(res, mesh):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_step
    from repro_torch.models.model import decode_step, init_params, prefill

    g = torch.Generator().manual_seed(2)
    prompts = {"inputs": torch.randint(0, 512, (8, 40), generator=g, dtype=torch.int32)}
    for variant in VARIANTS:
        cfg = _cfg(variant)
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        lg1, c1, lp1 = prefill(params, cfg, prompts, cache_len=64)
        lg2, c2, lp2 = build_step(cfg, ShapeConfig("p", 64, 8, "prefill"), mesh)(params,
                                                                                 prompts)
        res[f"prefill_{variant}"] = (lg1.numpy().tolist(), _full(lg2).numpy().tolist())
        step = build_step(cfg, ShapeConfig("d", 64, 8, "decode"), mesh)
        tok, pos = lg1.argmax(-1).to(torch.int32)[:, None], lp1 + 1
        out = []
        for _ in range(3):
            d1, c1 = decode_step(params, cfg, {"inputs": tok}, c1, pos)
            d2, c2 = step(params, {"inputs": tok}, c2, pos)
            out.append((d1.numpy().tolist(), _full(d2).numpy().tolist()))
            tok, pos = d1.argmax(-1).to(torch.int32)[:, None], pos + 1
        res[f"decode_{variant}"] = out
        first = c2[0]["k"] if "k" in c2[0] else c2[0]["state"]
        res[f"cache_placements_{variant}"] = str(first.placements)


def moe(res, mesh, inputs):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P, distribute_tree
    from repro_torch.models.moe import moe_ffn

    x = torch.from_numpy(inputs["x"])
    params = {k: torch.from_numpy(inputs[k]) for k in ("router", "wi_gate", "wi_up", "wo")}
    specs = {"router": P(None, None), "wi_gate": P("model", None, None),
             "wi_up": P("model", None, None), "wo": P("model", None, None)}
    top_k = int(inputs["top_k"])
    for cf in (float(c) for c in inputs["factors"]):
        with ctx.sharding_context(mesh, {}), implicit_replication():
            xd = distribute_tree(x, P("data", None, None), mesh)
            pd = distribute_tree(params, specs, mesh)
            y, aux = moe_ffn(pd, xd, top_k=top_k, capacity_factor=cf, act="silu")
        res[f"moe_{cf}"] = (_full(y).numpy().tolist(), float(_full(aux)))
    # Gradients through the expert-parallel path against autograd of the
    # single-device path, at a capacity where no token drops.
    w = torch.from_numpy(inputs["w"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xg = x.clone().requires_grad_(True)
    y0, _ = moe_ffn(leaves, xg, top_k=top_k, capacity_factor=16.0, act="silu")
    (y0 * w).sum().backward()
    want = {"x": xg.grad, **{k: v.grad for k, v in leaves.items()}}
    with ctx.sharding_context(mesh, {}), implicit_replication():
        xd = distribute_tree(x, P("data", None, None), mesh).requires_grad_(True)
        pd = {k: v.requires_grad_(True)
              for k, v in distribute_tree(params, specs, mesh).items()}
        y1, _ = moe_ffn(pd, xd, top_k=top_k, capacity_factor=16.0, act="silu")
        (y1 * w).sum().backward()
        got = {"x": _full(xd.grad), **{k: _full(v.grad) for k, v in pd.items()}}
    res["moe_grad_err"] = {k: float((want[k] - got[k]).abs().max()) for k in want}
    res["moe_grad_scale"] = {k: float(want[k].abs().max()) for k in want}
    res["moe_y_nodrop_err"] = float((y0.detach() - _full(y1).detach()).abs().max())


def main(rank: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, 4)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=4)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        res = {}
        inputs = dict(np.load(os.path.join(out_dir, "moe_inputs.npz")))
        layout(res)
        mesh_errors(res)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        moe(res, mesh, inputs)
        train(res, mesh)
        launcher(res, mesh)
        serve(res, mesh)
        if rank == 0:
            with open(os.path.join(out_dir, "torch_result.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()
