"""Hand-written Hopper kernels and their plain PyTorch versions.

  merge_runs       output ranks of K sorted runs (major compaction's merge)
  filter_scan      the postfix predicate program over dictionary codes
  merge_intersect  membership of probe keys in a sorted set (the device
                   index AND; the host AND of intersect_sorted)
  combine_scan     the predicate program fused with a segmented aggregate
                   over rows sorted by group key (scan-time aggregation)
  aggregate_combine  head flags and per-key count sums of sorted runs (the
                   aggregate family's combiner-on-compaction)

Each subpackage has ``ref.py`` (the plain version; filter_scan's runs the
program evaluator of ``program_eval.py``) and ``ops.py`` (the wrapper:
plain version for CPU tensors, the CUDA kernel for CUDA tensors, with a
launch counter). The CUDA sources live in ``csrc/`` and are built
by ``build.py`` at first use.
"""
