"""Training launcher; the port of the reference's launch/train.py.

    PYTHONPATH=src python -m repro_torch.launch.train --device cuda|cpu \
        [--mesh dev|single_pod|multi_pod] \
        [--arch llcysa-analytics-100m] [--shape train_4k] [--smoke] \
        [--steps N] [--global-batch B] [--seq S] \
        [--ckpt-dir DIR] [--ckpt-every K] [--resume] [--compress-grads]

It runs build_train_step's step over the store-fed data pipeline: a
SyntheticWebProxySource stages 4 files of 4,000 lines, an
IngestWorkerPool of 2 workers ingests them into an EventStore on the
device, and the EventTokenizer turns the stored events into token
sequences, so --arch takes the configs with token inputs alone (every
registered one but musicgen-medium and llama-3.2-vision-11b; the
reference's launcher fails on those two), for example --arch gemma2-9b
--smoke, the MoE configs moonshot-v1-16b-a3b and phi3.5-moe-42b-a6.6b
(the loss adds 0.01 x the router's aux loss) and the SSM configs
mamba2-780m and zamba2-2.7b. --device defaults to cuda, raising without
CUDA; --smoke takes the config's smoke() reduction (sequence 256, batch
4 unless given).

Without --mesh the step runs on the one device, without a mesh. With
--mesh it is build_train_step's BuiltStep over a DeviceMesh (ZeRO-1, as
in the reference), one process per rank:

    torchrun --nproc-per-node N -m repro_torch.launch.train --mesh dev --device cuda

takes its process group from torchrun's environment (NCCL on cuda, gloo
on cpu; rank r on cuda:LOCAL_RANK); run without torchrun, the launcher
makes a group of one rank itself. 'dev' is a (world size, 1) mesh over
(data, model), so (1, 1) on the caller's device for one process;
'single_pod' and 'multi_pod' are launch/mesh.py's production meshes and
raise on fewer ranks than they need. Every rank draws the same seeded
parameters and keeps its shards. Rank 0 alone runs the data pipeline
(its two ingest workers' order varies between runs) and broadcasts each
batch, so every rank slices its shard of the same batch. Rank 0 prints
and saves checkpoints of the gathered parameters. A SIGTERM on any rank
reaches every rank at the next step (an all-reduce of the flag), so all
of them gather the checkpoint and leave the loop together. The launcher
destroys the group when it ends.

Fault tolerance in the loop, as in the reference:
  * async checkpoints every --ckpt-every steps, keep-3, atomic renames;
  * --resume picks up the latest checkpoint;
  * SIGTERM (a preemption notice) triggers a final checkpoint and exit.
As in the reference, a checkpoint holds the parameters only, so a resume
restarts the optimizer (its moments and step) from zero.
"""
from __future__ import annotations

import argparse
import signal
import tempfile
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llcysa-analytics-100m",
                    help="a registered config with token inputs, e.g. gemma2-9b, "
                         "moonshot-v1-16b-a3b, phi3.5-moe-42b-a6.6b, mamba2-780m, zamba2-2.7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", choices=["dev", "single_pod", "multi_pod"], default=None)
    ap.add_argument("--smoke", action="store_true", help="the config's smoke() reduction")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    args = ap.parse_args(argv)

    from ..core.device import resolve_device
    from ..models import get_config

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not args.mesh:
        _train(args, ap, cfg, dev, None)
        return
    import torch.distributed as dist

    dev = _join_group(dev)
    try:
        _train(args, ap, cfg, dev, _make_mesh(args.mesh, dev))
    finally:
        dist.destroy_process_group()


def _join_group(dev):
    """Join torchrun's process group, or make one of one rank. Returns the
    rank's device."""
    import os

    import torch
    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(tempfile.mktemp(prefix="repro_train_store_"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return dev


def _make_mesh(kind: str, dev):
    import torch.distributed as dist

    from ..launch.mesh import make_dev_mesh, make_production_mesh

    if kind == "dev":
        return make_dev_mesh(dist.get_world_size(), 1, device_type=dev.type)
    return make_production_mesh(multi_pod=(kind == "multi_pod"), device_type=dev.type)


def _train(args, ap, cfg, dev, mesh) -> None:
    import torch

    from ..checkpointing import CheckpointManager
    from ..configs.base import SHAPES, ShapeConfig
    from ..core import EventStore, web_proxy_schema
    from ..launch.steps import build_train_step
    from ..models import init_params
    from ..pipeline import EventTokenizer, IngestWorkerPool, SyntheticWebProxySource
    from ..training.optimizer import OptConfig, adamw_init
    from ..tree import tree_map

    lead = mesh is None or torch.distributed.get_rank() == 0
    if not cfg.embed_input or "cross" in cfg.layer_pattern:
        ap.error(f"{cfg.name} also takes frame embeddings or vision states; the launcher "
                 "feeds token sequences alone")
    base = SHAPES[args.shape]
    shape = ShapeConfig(base.name, args.seq or (256 if args.smoke else base.seq_len),
                        args.global_batch or (4 if args.smoke else base.global_batch), "train")
    opt_cfg = OptConfig(total_steps=args.steps, compress_grads=args.compress_grads)
    if mesh is None:
        step = build_train_step(cfg, shape, opt_cfg=opt_cfg, device=dev)
    else:
        step = build_train_step(cfg, shape, opt_cfg=opt_cfg, mesh=mesh)
    if lead:
        where = f"device={dev}"
        if mesh is not None:
            where += f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M {where} "
              f"batch={shape.global_batch}x{shape.seq_len}", flush=True)

    # Data: the paper's pipeline, into a store on the device (rank 0's).
    batches = None
    if lead:
        store = EventStore(web_proxy_schema(), n_shards=4, device=dev)
        with tempfile.TemporaryDirectory(prefix="repro_train_staged_") as stage:
            files = SyntheticWebProxySource(seed=0).write_files(stage, 4, 4000, 0, 4 * 3600)
            pool = IngestWorkerPool(store, n_workers=2)
            for f in files:
                pool.submit_file(f)
            pool.drain()
        tok = EventTokenizer(store, vocab_size=cfg.vocab_size)
        batches = tok.sequences(0, 4 * 3600, seq_len=shape.seq_len + 1,
                                batch=shape.global_batch)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = adamw_init(params, opt_cfg)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=3)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, params = mgr.restore_latest(params)
        if lead:
            print(f"resumed at step {start}", flush=True)

    stop = {"now": False}

    def on_term(signum, frame):  # preemption notice
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, on_term)
    try:
        t0 = time.perf_counter()
        for i in range(start, args.steps):
            raw = next_batch(batches, shape, dev, mesh)
            batch = {"inputs": raw[:, :-1], "targets": raw[:, 1:]}
            params, opt_state, metrics = step(params, opt_state, batch)
            stop["now"] = stop_anywhere(stop["now"], dev, mesh)
            if lead and (i % 10 == 0 or i == args.steps - 1):
                tps = (shape.global_batch * shape.seq_len * (i - start + 1)
                       / (time.perf_counter() - t0))
                print(f"step {i:5d} loss {float(metrics['loss']):.4f} {tps:,.0f} tok/s",
                      flush=True)
            if (i + 1) % args.ckpt_every == 0 or stop["now"]:
                # On a mesh every rank gathers the parameters; rank 0 saves.
                whole = params if mesh is None else tree_map(lambda t: t.full_tensor(), params)
                if lead:
                    mgr.save(i + 1, whole)
            if stop["now"]:
                if lead:
                    print("preemption: checkpointed, exiting", flush=True)
                break
        mgr.wait()
    finally:
        signal.signal(signal.SIGTERM, previous)
    if lead:
        print(f"checkpoints: {ckpt_dir}", flush=True)


def next_batch(batches, shape, dev, mesh):
    """The next (global batch, sequence + 1) int32 token batch from
    ``batches``. On a mesh rank 0 draws it and every rank receives rank
    0's (the other ranks' ``batches`` are not read, and may be None): the
    step slices each rank's shard of a batch it takes to be the same on
    every rank."""
    import numpy as np
    import torch

    if mesh is None:
        return torch.from_numpy(next(batches)).to(dev)
    import torch.distributed as dist

    if dist.get_rank() == 0:
        raw = torch.from_numpy(np.asarray(next(batches), np.int32)).to(dev)
    else:
        raw = torch.empty((shape.global_batch, shape.seq_len + 1), dtype=torch.int32,
                          device=dev)
    dist.broadcast(raw, src=0)
    return raw


def stop_anywhere(stop: bool, dev, mesh) -> bool:
    """Whether this rank or, on a mesh, any rank was told to stop: every
    rank then takes the checkpoint's gather and leaves the loop at the
    same step."""
    if mesh is None:
        return stop
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(stop)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


if __name__ == "__main__":
    main()
