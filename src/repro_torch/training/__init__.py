"""The training side of the analytics LM: AdamW with clipping, the
schedule and error-feedback compression (the port of the reference's
training/)."""
from .optimizer import OptConfig, adamw_init, adamw_update  # noqa: F401
