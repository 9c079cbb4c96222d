"""The benchmark's tests: ``python -m pytest bench/tests`` (CPU, small
sizes). Tests marked ``gpu`` run the benchmark at a cell's own size and
skip without a CUDA card; on the card: ``python -m pytest bench/tests -m
gpu``."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# The CPU tests' sizes: a few tens of thousands of events in 8 tablets, and
# the traffic cut to match.
TINY = {"events": 20000, "tablets": 8, "capacity": 8192, "mem_rows": 256, "max_runs": 2,
        "append_rows": 128,
        "traffic": {"chunk_rows": 2048, "preload_chunk_rows": 2048, "deck": 40,
                    "set_size": 500, "check_rows_share": 0.5}}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    return copy.deepcopy(TINY)
