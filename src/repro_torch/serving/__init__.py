from .batcher import AdaptiveRequestBatcher  # noqa: F401
from .engine import Request, ServeEngine  # noqa: F401
