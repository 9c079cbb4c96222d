"""Fault-tolerant checkpointing: atomic save and restore, and an async
saver with keep-K; the PyTorch port of the reference's
checkpointing/checkpoint.py, with its on-disk layout.

Layout (one step):
    <dir>/step_00000123.tmp-<pid>-<ns>/   written here first
        manifest.json                      structure, shapes, dtypes
        arr_00000.npy ...                  leaves in tree order
    <dir>/step_00000123/                   atomic rename on completion

Leaves go in JAX's flatten order (dict keys sorted, sequences in order;
repro_torch/tree.py), and a dtype numpy cannot save (bfloat16, the fp8
types) is stored as the unsigned integer view of its bits with its
logical dtype in the manifest, as the reference stores it. So each
package restores what the other saved. The manifest's ``treedef`` is
the port's own rendering of the structure; restore never reads it.

Restart safety: a crash mid-write leaves only a .tmp directory, which
restore ignores and the next gc sweeps. ``keep`` bounds disk usage.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_flatten, tree_unflatten

PyTree = Any

# Logical dtype -> (torch dtype, its signed integer view in torch and in
# numpy, the unsigned view it is stored as).
_WIDENED = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.int8, np.int8, np.uint8),
}
_BY_TORCH = {v[0]: k for k, v in _WIDENED.items()}


def _to_storable(leaf, copy: bool = False) -> Tuple[np.ndarray, str]:
    """(array numpy can save, logical dtype name) of a tensor or array;
    with ``copy`` the array shares no memory with ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype in _BY_TORCH:
            name = _BY_TORCH[t.dtype]
            _, int_view, _, stored = _WIDENED[name]
            return t.view(int_view).numpy().view(stored), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=copy)
    name = str(arr.dtype)
    if name in _WIDENED:  # an ml_dtypes array
        return arr.view(_WIDENED[name][3]), name
    return arr, name


def _from_storable(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _WIDENED:
        dtype, _, np_signed, _ = _WIDENED[logical]
        return torch.from_numpy(np.asarray(arr, order="C").view(np_signed)).view(dtype)
    return torch.from_numpy(np.asarray(arr, order="C"))


def save_checkpoint(directory, step: int, tree: PyTree, *, process_index: int = 0) -> Path:
    """Write ``tree`` (tensors or numpy arrays) as step ``step`` under
    ``directory``: into a .tmp directory, renamed when complete."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    leaves, treedef = tree_flatten(tree)
    return _write(d, step, [_to_storable(x) for x in leaves], str(treedef), process_index)


def _write(d: Path, step: int, stored_leaves, treedef: str, process_index: int) -> Path:
    final = d / f"step_{step:08d}"
    tmp = d / f"step_{step:08d}.tmp-{os.getpid()}-{time.time_ns()}"
    tmp.mkdir(parents=True)
    manifest = {"step": step, "process_index": process_index, "treedef": treedef,
                "n_leaves": len(stored_leaves), "leaves": []}
    for i, (stored, logical) in enumerate(stored_leaves):
        np.save(tmp / f"arr_{i:05d}.npy", stored)
        manifest["leaves"].append({"shape": list(stored.shape), "dtype": logical})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic on POSIX
    return final


def list_checkpoints(directory) -> List[Tuple[int, Path]]:
    """[(step, path)] of the complete checkpoints, by step."""
    d = Path(directory)
    if not d.exists():
        return []
    out = []
    for p in sorted(d.iterdir()):
        if p.is_dir() and p.name.startswith("step_") and ".tmp-" not in p.name:
            if (p / "manifest.json").exists():
                out.append((int(p.name.split("_")[1]), p))
    return out


def restore_checkpoint(directory, like: PyTree, step: Optional[int] = None) -> Tuple[int, PyTree]:
    """Restore the latest (or a given) step into the structure of ``like``,
    a tree of tensors: each leaf takes the shape it must have (checked),
    and ``like``'s leaf's dtype (cast where the stored one differs) and
    device. Returns (step, tree)."""
    ckpts = list_checkpoints(directory)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if step is not None:
        matches = [c for c in ckpts if c[0] == step]
        if not matches:
            raise FileNotFoundError(f"step {step} not found under {directory}")
        step_found, path = matches[0]
    else:
        step_found, path = ckpts[-1]
    manifest = json.loads((path / "manifest.json").read_text())
    leaves, treedef = tree_flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, expected {len(leaves)}")
    new_leaves = []
    for i, want in enumerate(leaves):
        t = _from_storable(np.load(path / f"arr_{i:05d}.npy"), manifest["leaves"][i]["dtype"])
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != {tuple(want.shape)}")
        new_leaves.append(t.to(device=want.device, dtype=want.dtype))
    return step_found, tree_unflatten(treedef, new_leaves)


def gc_checkpoints(directory, keep: int) -> None:
    """Keep the ``keep`` latest checkpoints and sweep orphaned .tmp
    directories (crashed writers)."""
    for _, path in list_checkpoints(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(path, ignore_errors=True)
    d = Path(directory)
    if d.exists():
        for p in d.iterdir():
            if ".tmp-" in p.name:
                shutil.rmtree(p, ignore_errors=True)


class CheckpointManager:
    """Async checkpoint writer with keep-K GC and crash recovery."""

    def __init__(self, directory, keep: int = 3):
        self.directory = str(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree, blocking: bool = False) -> None:
        """Copy ``tree`` to host memory, then write it on a thread (or here
        when ``blocking``). The copy is made before this returns, so the
        caller may update its tensors in place at once."""
        self.wait()
        leaves, treedef = tree_flatten(tree)
        stored = [_to_storable(x, copy=True) for x in leaves]

        def work():
            try:
                d = Path(self.directory)
                d.mkdir(parents=True, exist_ok=True)
                _write(d, step, stored, str(treedef), 0)
                gc_checkpoints(self.directory, self.keep)
            except BaseException as e:  # noqa: BLE001
                self._error = e

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, like: PyTree) -> Tuple[int, PyTree]:
        return restore_checkpoint(self.directory, like)

    def latest_step(self) -> Optional[int]:
        ckpts = list_checkpoints(self.directory)
        return ckpts[-1][0] if ckpts else None
