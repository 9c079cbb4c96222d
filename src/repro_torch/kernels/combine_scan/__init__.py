from .ops import OPS, combine_groups, combine_scan, combine_segments, trivial_program  # noqa: F401
from .ref import combine_groups_ref, combine_scan_ref  # noqa: F401
