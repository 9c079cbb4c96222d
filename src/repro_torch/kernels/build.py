"""Build and load the CUDA kernels of this package.

At first use, every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its
own ``nvcc`` process (all started together; the shared ``csrc/*.cuh``
headers are included by them), and the objects are linked
into one shared library with a plain C interface under the checkout's
``build/`` directory. The library is loaded with ``ctypes``; every entry
point takes ``c_void_p`` for device pointers and the stream (ctypes arrays
for the few small tables passed from host memory), and a launcher returns
``cudaGetLastError()`` as an int.

The library's file name carries a hash of the sources and headers, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs
at import time: the CPU tests import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_optin: Optional[int] = None
# What the last build printed (ptxas register and shared-memory lines);
# chip_smoke.py reports it.
build_log: List[str] = []


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(sources: List[Path], target: Path) -> None:
    nvcc = _nvcc()
    # Per process, so that two processes building at once never share an
    # object file.
    objdir = target.with_suffix(f".obj{os.getpid()}")
    objdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = objdir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}")
        log.extend(line for line in out.splitlines() if line.strip())
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp = target.with_suffix(f".tmp{os.getpid()}")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    os.replace(tmp, target)
    shutil.rmtree(objdir, ignore_errors=True)
    build_log[:] = log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha1()
        for src in sources + sorted(CSRC.glob("*.cuh")):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"librepro_torch_kernels_{digest.hexdigest()[:12]}.so"
        if not target.exists():
            _build(sources, target)
        lib = ctypes.CDLL(str(target))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        vpp, llp = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)
        for name in ("merge_ranks_i32", "merge_ranks_i64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, llp, vp, vp, ll, i, ll, vp]
            fn.restype = i
        for name in ("merge_ranks_search_i32", "merge_ranks_search_i64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, ll, i, ll, vp]
            fn.restype = i
        lib.filter_scan_levels.argtypes = [vpp, vpp, llp, i, i, vp, i, i, i, vp]
        lib.filter_scan_levels.restype = i
        for name in ("member_mask_i32", "member_mask_i64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, ll, ll, ll, vp, vp]
            fn.restype = i
        inputs = [vp, vp, vp, ll, i, vp, i, i, i, i]
        lib.combine_scan_rows.argtypes = inputs + [vp, vp, vp, vp, ll, vp]
        lib.combine_scan_rows.restype = i
        lib.combine_scan_groups.argtypes = inputs + [vp] * 8 + [ll, vp]
        lib.combine_scan_groups.restype = i
        lib.combine_scan_scratch_bytes.argtypes = [i, i, i, i, i, i]
        lib.combine_scan_scratch_bytes.restype = ll
        lib.combine_scan_reserved_bytes.argtypes = [i, i, i]
        lib.combine_scan_reserved_bytes.restype = i
        for name in ("aggregate_combine_i32", "aggregate_combine_i64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, ll, ll, vp, vp, vp, vp]
            fn.restype = i
        lib.combine_compact.argtypes = [vp, vp, i, vp, ll, ll, ll, ll, vp, vp, vp, vp, vp, vp]
        lib.combine_compact.restype = i
        for name in ("aggregate_combine_tile_rows", "shared_optin_bytes"):
            fn = getattr(lib, name)
            fn.argtypes = []
            fn.restype = i
        _lib = lib
        return lib


def shared_optin_bytes() -> int:
    """Bytes of shared memory a block of the current card may opt in to
    (cudaDevAttrMaxSharedMemoryPerBlockOptin), read once."""
    global _optin
    if _optin is None:
        got = load_library().shared_optin_bytes()
        if got < 0:
            raise RuntimeError("cannot read the card's shared memory per block")
        _optin = got
    return _optin


def check(err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
