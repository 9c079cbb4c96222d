"""Path 7's or path 10a/10b's serving repeated in one process, for
comparing two trees of the port on one card.

    python3 scripts/lm_serve_repeat.py [--root DIR] [--arch NAME ...]

Imports ``repro_torch`` and ``chip_smoke`` from DIR (default: this
checkout), so a second tree unpacked beside this one is measured by the
same code. For each --arch (default llcysa-analytics-100m, path 7's; or
path 10's moonshot-v1-16b-a3b and zamba2-2.7b, uncut) it draws the
config in bf16 from seed 7 on the card, as those paths do, and runs that
tree's ``chip_smoke.serve_prompts`` REPS times: ServeEngine(max_batch 8,
cache_len 256) answers 32 prompts of 112 tokens with 16 new tokens each,
then one decode step of the 8 slots (for path 10's configs the engine's
first round over prefilled caches, as path 10 times it) and one prefill
are timed. Seeded prompts in path 6's token range (modulo the config's
vocabulary) stand in for path 6's sequences: no config has an end token,
so every request decodes 16 tokens whatever its ids, and the work is the
same. The last line of its output is one JSON object: every run's serve
report and breakdown by config. Needs a CUDA card; exits 2 without one.
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
    ap.add_argument("--arch", nargs="+", default=["llcysa-analytics-100m"],
                    choices=["llcysa-analytics-100m", "moonshot-v1-16b-a3b", "zamba2-2.7b"])
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lm_serve_repeat: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.models import get_config
    from repro_torch.models.model import init_params

    dev = torch.device("cuda", 0)
    drawn = np.random.default_rng(SEED).integers(
        0, 32768, (cs.LM_REQUESTS, cs.LM_PROMPT_EVENTS * 14)).astype(np.int32)
    runs = {}
    for arch in args.arch:
        cfg = get_config(arch)
        path7 = arch == "llcysa-analytics-100m"
        kw = {} if path7 else {"prefilled": True, "profiled_calls": cs.MOE_SSM_PROFILED_CALLS}
        prompts = drawn % cfg.vocab_size
        base_alloc = torch.cuda.memory_allocated(dev)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        runs[arch] = []
        for _ in range(REPS):
            torch.cuda.reset_peak_memory_stats(dev)
            serve, breakdown = cs.serve_prompts(cfg, params, dev, prompts, base_alloc,
                                                "lm" if path7 else "moe_ssm", **kw)[:2]
            runs[arch].append({"serve": serve, "breakdown": breakdown})
        del params
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
