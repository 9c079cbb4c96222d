from .ops import combine_blocks, combine_sorted_counts  # noqa: F401
from .ref import combine_blocks_ref  # noqa: F401
