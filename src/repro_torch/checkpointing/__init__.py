"""Atomic checkpoints in the reference's on-disk layout, and the async
keep-K manager (the port of the reference's checkpointing/)."""
from .checkpoint import (  # noqa: F401
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
