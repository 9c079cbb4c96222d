"""Path 7's serving repeated in one process, for comparing two trees of
the port on one card.

    python3 scripts/lm_serve_repeat.py [--root DIR]

Imports ``repro_torch`` and ``chip_smoke`` from DIR (default: this
checkout), so a second tree unpacked beside this one is measured by the
same code. It draws llcysa-analytics-100m in bf16 from seed 7, as path 7
does, and runs that tree's ``chip_smoke.serve_prompts`` REPS times:
ServeEngine(max_batch 8, cache_len 256) answers 32 prompts of 112 tokens
with 16 new tokens each, then one decode step of the 8 slots and one
prefill are timed. Seeded prompts in path 6's token range stand in for
path 6's sequences: the config has no end token, so every request
decodes 16 tokens whatever its ids, and the work is the same. The last
line of its output is one JSON object: every run's serve report and
breakdown. Needs a CUDA card; exits 2 without one.
"""
import argparse
import json
import os
import sys

REPS = 3
SEED = 7


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args(argv).root)
    sys.path[:0] = [root, os.path.join(root, "src")]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lm_serve_repeat: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.llcysa import CONFIG as cfg
    from repro_torch.models.model import init_params

    dev = torch.device("cuda", 0)
    prompts = np.random.default_rng(SEED).integers(
        0, 32768, (cs.LM_REQUESTS, cs.LM_PROMPT_EVENTS * 14)).astype(np.int32)
    base_alloc = torch.cuda.memory_allocated(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    runs = []
    for _ in range(REPS):
        torch.cuda.reset_peak_memory_stats(dev)
        serve, breakdown = cs.serve_prompts(cfg, params, dev, prompts, base_alloc, "lm")[:2]
        runs.append({"serve": serve, "breakdown": breakdown})
    print(json.dumps({"root": root, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
