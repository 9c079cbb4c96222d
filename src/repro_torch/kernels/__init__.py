"""Hand-written Hopper kernels and their plain PyTorch versions.

  merge_runs       output ranks of K sorted runs (major compaction's merge)
  filter_scan      the postfix predicate program over dictionary codes
  merge_intersect  membership of probe keys in a sorted set (the device
                   index AND)

Each subpackage has ``ref.py`` (the plain version; filter_scan's runs the
program evaluator of ``program_eval.py``) and ``ops.py`` (the wrapper:
plain version for CPU tensors, the CUDA kernel for CUDA tensors, with a
launch counter). The CUDA sources live in ``csrc/`` and are built
by ``build.py`` at first use.
"""
