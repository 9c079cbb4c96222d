"""Per-device cost of a step traced on a mesh: the counterpart of the
reference's launch/hlo_analysis.py.

The reference parses the compiled HLO's text; a PyTorch step has no HLO,
so this module measures the step as it runs, on fake tensors over a fake
process group when the mesh does not exist (launch/dryrun.py). Every
count is per device, from the ops DTensor runs on the local shards: a
dispatch mode below DTensor passes each op on DTensors down to DTensor
(it returns NotImplemented) and counts the local ops that DTensor issues
in its place. A mode entered around the DTensor program alone (as
FlopCounterMode is) would count the global op, the whole product.

* FLOPs: torch.utils.flop_counter's formulas (FlopCounterMode's
  registry) over the local ops.
* HBM bytes: a lower bound, the local argument bytes read once, and an
  upper bound, the bytes in and out of every local op that moves memory
  (no fusion; an op whose output is a view of its input, such as view,
  t, expand, slice, permute or detach, moves none and is not counted).
  The roofline's memory term and bottleneck read the upper bound.
* Peak memory: the high-water mark of the bytes of live storages (a view
  shares its base's), the arguments included.
* Collectives: bytes (the operand, as the reference counts it) and
  counts by op from the functional collectives DTensor (or the store's
  mesh steps) issue; the counts also from
  torch.distributed.tensor.debug.CommDebugMode.
* Charged work: what a traced function cannot show (a ctypes kernel
  launch) it states with ``charge`` and makes its outputs ``unseen``;
  the record lists it under ``charged_by_op``.

``roofline_terms`` keeps the reference's signature and keys, with the
H100 SXM data sheet's rates (not measured): 989.4e12 dense bf16 FLOP/s,
3.35e12 B/s of HBM3 and 450e9 B/s of NVLink per direction. A 16-wide
'model' axis spans two 8-GPU NVLink nodes of an HGX H100, so its
collectives leave NVLink; the NVLink rate is then an optimistic bound.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM5 data sheet rates, per GPU (not measured).
PEAK_FLOPS = 989.4e12  # dense bf16 FLOP/s
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 450e9  # B/s per direction, NVLink 4

_COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all", "broadcast")


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float) -> Dict[str, float]:
    """Three roofline terms in seconds, per device, and the largest."""
    terms = {"compute_s": flops_per_device / PEAK_FLOPS,
             "memory_s": bytes_per_device / HBM_BW,
             "collective_s": collective_bytes_per_device / NVLINK_BW}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    return terms


def _collective_name(func) -> str:
    name = func._overloadpacket.__name__
    for c in _COLLECTIVES:
        if name.startswith(c):
            return c.replace("_", "-")
    return ""


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _aliases(func) -> bool:
    """Whether ``func``'s output is a view of its input (no bytes move):
    the aten view ops, and ``_unsafe_view``, which aliases without saying
    so in its schema."""
    return func.is_view or func._overloadpacket.__name__ == "_unsafe_view"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalCost(TorchDispatchMode):
    """Counts the local ops (module docstring). Enter it inside
    FakeTensorMode (or on real tensors) around the step."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0
        self.flops_by_op: Dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.ops = 0
        self.collective_bytes: Dict[str, int] = defaultdict(int)
        self.collective_count: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}  # storage -> [bytes, tensors seen on it]
        self._tensors = set()
        self.paused = 0
        self.charged: Dict[str, Dict[str, int]] = {}

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live while a tensor seen on it lives.
        A view shares its base's storage; it is told by the storage, since
        a view met inside a dispatch mode has no ``_base`` yet."""
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [storage.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        if id(t) in self._tensors:
            return
        self._tensors.add(id(t))
        entry[1] += 1
        weakref.finalize(t, self._release, key, id(t))

    def _release(self, key: int, tensor_id: int) -> None:
        self._tensors.discard(tensor_id)
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.ops += 1
        packet = func._overloadpacket
        if packet in self._flops:
            f = int(self._flops[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[packet.__name__] += f
        coll = _collective_name(func)
        if coll:
            self.collective_bytes[coll] += sum(_nbytes(t) for t in ins)
            self.collective_count[coll] += 1
        elif packet.__name__ != "wait_tensor" and not _aliases(func):
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self.hold(t)
        return out


def _active() -> LocalCost:
    """The innermost LocalCost on the dispatch-mode stack."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    modes = [m for m in _get_current_dispatch_mode_stack() if isinstance(m, LocalCost)]
    if not modes:
        raise RuntimeError("no LocalCost is counting")
    return modes[-1]


def charge(name: str, nbytes: int, flops: int = 0) -> None:
    """Count ``nbytes`` of HBM traffic and ``flops`` for work the trace
    cannot see (a kernel launched through ctypes), under ``name``."""
    cost = _active()
    cost.bytes += nbytes
    cost.flops += flops
    entry = cost.charged.setdefault(name, {"bytes": 0, "flops": 0, "calls": 0})
    entry["bytes"] += nbytes
    entry["flops"] += flops
    entry["calls"] += 1


@contextlib.contextmanager
def unseen():
    """Ops inside are not counted (a charged kernel's stand-in outputs)."""
    cost = _active()
    cost.paused += 1
    try:
        yield
    finally:
        cost.paused -= 1


@contextlib.contextmanager
def _metadata_unseen(cost: LocalCost):
    """DTensor's sharding propagation runs each new op once on fake tensors
    of the global shapes to derive the output's metadata: no device runs
    it, so ``cost`` pauses inside it."""
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
             if hasattr(prop, n)]
    if not names:
        raise RuntimeError("DTensor's sharding propagator has no tensor-meta method to hook")
    name = names[0]
    inner = getattr(prop, name)

    def paused(*a, **k):
        cost.paused += 1
        try:
            return inner(*a, **k)
        finally:
            cost.paused -= 1

    setattr(prop, name, paused)
    try:
        yield
    finally:
        delattr(prop, name)


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors."""
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t) for t in _tensors(tree))


def measure(fn: Callable, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under LocalCost and CommDebugMode; returns
    the per-device record (the reference's cost and collective keys)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    cost = LocalCost()
    for t in _tensors(args):
        cost.hold(t.to_local() if isinstance(t, DTensor) else t)
    comm = CommDebugMode()
    with comm, cost, _metadata_unseen(cost):
        out = fn(*args)
    counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    arg_bytes = local_bytes(args)
    total_coll = float(sum(cost.collective_bytes.values()))
    return {
        "out": out,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": local_bytes(out),
                   "peak_bytes": cost.peak},
        "cost": {"flops_per_device": float(cost.flops), "flops_by_op": dict(cost.flops_by_op),
                 "bytes_per_device": float(cost.bytes),
                 "bytes_lower_per_device": float(arg_bytes), "local_ops": cost.ops,
                 "charged_by_op": {k: dict(v) for k, v in cost.charged.items()}},
        "collectives": {"total_bytes": total_coll,
                        "bytes_by_op": dict(cost.collective_bytes),
                        "count_by_op": dict(cost.collective_count),
                        "comm_debug_counts": counts},
    }
