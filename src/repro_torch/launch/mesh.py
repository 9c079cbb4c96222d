"""Mesh builders; the PyTorch port of the reference's launch/mesh.py.

Functions, not module-level constants: importing this module touches no
torch.distributed state. A mesh spans the ranks of the default process
group (torchrun's, or the dry-run's fake group), and a mesh whose size is
not the group's world size raises.

The shapes are the reference's, so the cells and spec trees compare: one
pod is 256 GPUs as (data=16, model=16), two pods (pod=2, data=16,
model=16). On HGX H100 a 16-wide 'model' axis spans two 8-GPU NVLink
nodes, so its collectives cross the node boundary; the dry-run's
collective term (launch/cost_analysis.py) prices them at the NVLink rate,
an optimistic bound.
"""
from __future__ import annotations

import math
from typing import Tuple


def _mesh(device_type: str, shape: Tuple[int, ...], names: Tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group: run under torchrun "
                           "(or init_process_group) first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """One pod: (data=16, model=16). Two pods: (pod=2, data=16, model=16),
    the 'pod' axis extending data parallelism across the pods."""
    if multi_pod:
        return _mesh(device_type, (2, 16, 16), ("pod", "data", "model"))
    return _mesh(device_type, (16, 16), ("data", "model"))


def make_dev_mesh(n_data: int = 1, n_model: int = 1, device_type: str = "cuda"):
    """A small (data, model) mesh over the process group's ranks."""
    return _mesh(device_type, (n_data, n_model), ("data", "model"))
