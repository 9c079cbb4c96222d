from .ops import merge_pair_device, merge_ranks, merge_sorted_device, merge_sorted_runs  # noqa: F401
from .ref import merge_ranks_ref  # noqa: F401
