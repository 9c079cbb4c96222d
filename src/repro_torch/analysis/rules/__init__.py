"""Rule registry. Order here is report order for equal file:line."""
from .capture_purity import CapturePurityRule
from .guarded_by import GuardedByRule
from .hot_path import HotPathSyncRule
from .kernel_contract import KernelContractRule
from .no_inplace import NoInplaceInPlaneRule

REGISTRY = [
    GuardedByRule,
    HotPathSyncRule,
    CapturePurityRule,
    NoInplaceInPlaneRule,
    KernelContractRule,
]

__all__ = [
    "REGISTRY",
    "GuardedByRule",
    "HotPathSyncRule",
    "CapturePurityRule",
    "NoInplaceInPlaneRule",
    "KernelContractRule",
]
