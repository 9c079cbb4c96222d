# NOTE: no XLA_FLAGS here by design — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py (and the subprocess spawned
# by test_distributed.py) force placeholder device counts.
import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Property tests use hypothesis when installed (`pip install -e .[test]`);
# hermetic environments without it fall back to a deterministic random-sweep
# shim with the same API so the suite still collects and runs.
try:
    import hypothesis  # noqa: F401
except ImportError:
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_stub", os.path.join(os.path.dirname(__file__), "_hypothesis_stub.py")
    )
    _stub = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_stub)
    _stub.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA); skipped where CUDA is missing"
    )
