from .ops import member_mask  # noqa: F401
from .ref import member_mask_keys  # noqa: F401
