from .base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401
