"""The analytics LM, ported: the dense decoder stack of the reference's
models/ (the llcysa config), its attention and layer primitives, and the
carry of the reference's parameters."""
from .model import Model, init_params  # noqa: F401
from .registry import get_config, list_archs  # noqa: F401
