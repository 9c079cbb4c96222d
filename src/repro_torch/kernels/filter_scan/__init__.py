from .ops import (  # noqa: F401
    filter_rows,
    filter_scan,
    filter_scan_levels,
    pad_program,
    program_tensors,
)
from .ref import filter_scan_ref  # noqa: F401
