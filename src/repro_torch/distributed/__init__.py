"""Distribution layer: mesh axis conventions, partition-rule trees for
parameters, optimizer state, caches and batches, and the
activation-constraint hooks; the PyTorch port of the reference's
distributed/ over a torch DeviceMesh and DTensor."""
from .sharding import (  # noqa: F401
    MeshShape,
    P,
    batch_specs,
    cache_specs,
    distribute_tree,
    dp_axes,
    param_specs,
    to_placements,
    zero1_specs,
)
