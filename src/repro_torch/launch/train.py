"""Training launcher; the port of the reference's launch/train.py.

    PYTHONPATH=src python -m repro_torch.launch.train --device cuda|cpu \
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
mamba2-780m and zamba2-2.7b. --device replaces the reference's --mesh (one device, no mesh)
and defaults to cuda, raising without CUDA; --smoke takes the config's
smoke() reduction (sequence 256, batch 4 unless given).

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
    ap.add_argument("--smoke", action="store_true", help="the config's smoke() reduction")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from ..checkpointing import CheckpointManager
    from ..configs.base import SHAPES, ShapeConfig
    from ..core import EventStore, web_proxy_schema
    from ..core.device import resolve_device
    from ..launch.steps import build_train_step
    from ..models import get_config, init_params
    from ..pipeline import EventTokenizer, IngestWorkerPool, SyntheticWebProxySource
    from ..training.optimizer import OptConfig, adamw_init

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.embed_input or "cross" in cfg.layer_pattern:
        ap.error(f"{cfg.name} also takes frame embeddings or vision states; the launcher "
                 "feeds token sequences alone")
    base = SHAPES[args.shape]
    shape = ShapeConfig(base.name, args.seq or (256 if args.smoke else base.seq_len),
                        args.global_batch or (4 if args.smoke else base.global_batch), "train")
    opt_cfg = OptConfig(total_steps=args.steps, compress_grads=args.compress_grads)
    step = build_train_step(cfg, shape, opt_cfg=opt_cfg, device=dev)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M device={dev} "
          f"batch={shape.global_batch}x{shape.seq_len}", flush=True)

    # Data: the paper's pipeline, into a store on the device.
    store = EventStore(web_proxy_schema(), n_shards=4, device=dev)
    with tempfile.TemporaryDirectory(prefix="repro_train_staged_") as stage:
        files = SyntheticWebProxySource(seed=0).write_files(stage, 4, 4000, 0, 4 * 3600)
        pool = IngestWorkerPool(store, n_workers=2)
        for f in files:
            pool.submit_file(f)
        pool.drain()
    tok = EventTokenizer(store, vocab_size=cfg.vocab_size)
    batches = tok.sequences(0, 4 * 3600, seq_len=shape.seq_len + 1, batch=shape.global_batch)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = adamw_init(params, opt_cfg)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=3)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, params = mgr.restore_latest(params)
        print(f"resumed at step {start}", flush=True)

    stop = {"now": False}

    def on_term(signum, frame):  # preemption notice
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, on_term)
    try:
        t0 = time.perf_counter()
        for i in range(start, args.steps):
            raw = torch.from_numpy(next(batches)).to(dev)
            batch = {"inputs": raw[:, :-1], "targets": raw[:, 1:]}
            params, opt_state, metrics = step(params, opt_state, batch)
            if i % 10 == 0 or i == args.steps - 1:
                tps = (shape.global_batch * shape.seq_len * (i - start + 1)
                       / (time.perf_counter() - t0))
                print(f"step {i:5d} loss {float(metrics['loss']):.4f} {tps:,.0f} tok/s",
                      flush=True)
            if (i + 1) % args.ckpt_every == 0 or stop["now"]:
                mgr.save(i + 1, params)
            if stop["now"]:
                print("preemption: checkpointed, exiting", flush=True)
                break
        mgr.wait()
    finally:
        signal.signal(signal.SIGTERM, previous)
    print(f"checkpoints: {ckpt_dir}", flush=True)


if __name__ == "__main__":
    main()
