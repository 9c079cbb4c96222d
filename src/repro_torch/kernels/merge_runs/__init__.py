from .ops import (  # noqa: F401
    merge_pair_device,
    merge_ranks,
    merge_sorted_device,
    merge_sorted_runs,
    merge_window_keys,
)
from .ref import merge_ranks_ref  # noqa: F401
