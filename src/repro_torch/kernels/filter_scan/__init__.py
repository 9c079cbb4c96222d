from .ops import filter_scan, pad_program  # noqa: F401
from .ref import filter_scan_ref  # noqa: F401
