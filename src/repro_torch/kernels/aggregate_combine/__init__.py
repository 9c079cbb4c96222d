from .ops import combine_blocks, combine_compact, combine_sorted_counts  # noqa: F401
from .ref import combine_blocks_ref, combine_compact_ref  # noqa: F401
