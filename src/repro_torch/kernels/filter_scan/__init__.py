from .ops import filter_rows, filter_scan, pad_program, program_tensors  # noqa: F401
from .ref import filter_scan_ref  # noqa: F401
