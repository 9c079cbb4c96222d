from .ops import intersect_sorted, member_mask, union_sorted  # noqa: F401
from .ref import member_mask_keys  # noqa: F401
