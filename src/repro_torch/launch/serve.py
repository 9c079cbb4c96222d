"""Serving launcher: continuous batching with adaptive admission; the
port of the reference's launch/serve.py.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda|cpu \
        [--arch llcysa-analytics-100m] [--requests 16] [--max-batch 8] \
        [--cache-len 256] [--max-new-tokens 16]

As in the reference, --smoke is on by default (the config's smoke()
reduction); the weights are seeded random. --arch takes any registered
config whose inputs are tokens alone (ServeEngine refuses musicgen-medium
and llama-3.2-vision-11b): llcysa-analytics-100m, gemma2-9b, gemma3-12b,
internlm2-20b, qwen1.5-4b, the MoE configs moonshot-v1-16b-a3b and
phi3.5-moe-42b-a6.6b, and the SSM configs mamba2-780m and zamba2-2.7b.
--device defaults to cuda and raises without CUDA.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llcysa-analytics-100m",
                    help="a registered config with token inputs, e.g. gemma2-9b, "
                         "moonshot-v1-16b-a3b, phi3.5-moe-42b-a6.6b, mamba2-780m, zamba2-2.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..core.device import resolve_device
    from ..models import get_config, init_params
    from ..serving import AdaptiveRequestBatcher, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch, cache_len=args.cache_len,
                      batcher=AdaptiveRequestBatcher(max_batch=args.max_batch), device=dev)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 64))),
                   max_new_tokens=args.max_new_tokens)
    done = eng.run()
    ttft = sorted(r.ttft for r in done)
    lat = sorted(r.finished_at - r.submitted_at for r in done)
    n = len(done)
    print(f"served {n} requests; TTFT p50 {1e3*ttft[n//2]:.1f} ms, "
          f"p95 {1e3*ttft[int(0.95*(n-1))]:.1f} ms; E2E p50 {1e3*lat[n//2]:.1f} ms")
    print(f"adaptive admission k -> {eng.batcher.k:.1f}")


if __name__ == "__main__":
    main()
