from .base import ModelConfig  # noqa: F401
