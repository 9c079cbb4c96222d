"""Where the device plane lives: an explicit device, never a silent
fallback."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for ``device`` ('cuda', 'cuda:N' or 'cpu'). Raises
    when CUDA is asked for and missing: the CPU runs only when the caller
    says device='cpu'."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return d
