"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, in this package's build directory
(tigerbeetle_tpu_torch/build/, listed in .gitignore), and loaded with
ctypes. Every pointer and the stream cross as `c_void_p`, sizes as
`c_int64`, and each entry returns the `cudaError_t` of its launches. The
exact route's two entries, which take some fifty pointers, take them as
one host array of pointers and one array of int64 sizes.

Libraries are built at first use, or all at once by `build_all()` (one
`nvcc` per source, started together). A library's file name carries a
hash of its source and of the shared headers (csrc/*.cuh), so an edited
source is rebuilt and a stale library is never loaded. A failed build
raises.

Wrappers check their arguments with `check`, launch with `launch` (on
the device's current stream; a nonzero cudaError_t raises) and so count
every launch in `LAUNCHES`, which chip_smoke.py resets before a main-path
run and reads after it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

import torch

from tigerbeetle_tpu_torch.native import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64

# entry symbol and argtypes of each source's C interface.
SIGNATURES = {
    "create_transfers_fast": ("tb_create_transfers_fast", [_P] * 22 + [_I, _I, _P]),
    "register_accounts": ("tb_register_accounts", [_P] * 6 + [_I, _I, _P]),
    "read_balances": ("tb_read_balances", [_P] * 9 + [_I, _I, _P]),
    "write_balances": ("tb_write_balances", [_P] * 9 + [_I, _I, _P]),
    "create_transfers_exact": ("tb_create_transfers_exact", [_P, _P, _P]),
    "exact_sort_plan": ("tb_exact_sort_plan", [_P, _P, _P]),
    "query_index_keys": ("tb_query_index_keys", [_P] * 6 + [_I, _P]),
    "query_index_keys_sorted": ("tb_query_index_keys_sorted", [_P] * 6 + [_I, _P]),
    "merge_kernel_tiled": ("tb_merge_kernel_tiled", [_P] * 6 + [_I, _I, _I, _P]),
    "scan_intersect_mask": ("tb_scan_intersect_mask", [_P] * 3 + [_I, _I, _P]),
    "merge_kernel": ("tb_merge_kernel", [_P] * 6 + [_I, _I, _I, _P]),
    "compact_fold_kernel": ("tb_compact_fold", [_P] * 5 + [_I, _I, _P]),
    # the commit path over balance tables sharded on a device mesh
    "sharded_apply": ("tb_sharded_apply", [_P] * 15 + [_I] * 3 + [_P]),
    "sharded_apply_grouped": ("tb_sharded_apply_grouped", [_P] * 3 + [_I] + [_P] * 7 + [_I, _I, _P]),
    # one C entry each, launched under the name of the wrapper that calls it
    # (the one-slice, one-shard wrapper or the mesh's grouped one), so that
    # each wrapper's launches count apart
    "sharded_validate": ("tb_sharded_validate", [_P] * 14 + [_I] * 3 + [_P]),
    "sharded_validate_grouped": ("tb_sharded_validate", [_P] * 14 + [_I] * 3 + [_P]),
    "sharded_read": ("tb_sharded_read", [_P, _P, _I] + [_P] * 5 + [_I] * 4 + [_P]),
    "sharded_read_grouped": ("tb_sharded_read", [_P, _P, _I] + [_P] * 5 + [_I] * 4 + [_P]),
    "register_accounts_sharded": ("tb_register_accounts_sharded", [_P, _P, _I] + [_P] * 4 + [_I, _I, _P]),
}

# The source of each entry that is not csrc/<entry>.cu.
SOURCES = {"register_accounts_sharded": "register_accounts",
           "sharded_apply_grouped": "sharded_apply",
           "sharded_validate_grouped": "sharded_validate",
           "sharded_read_grouped": "sharded_read"}

# Kernel launches per entry (plain-version calls do not count).
LAUNCHES: Dict[str, int] = dict.fromkeys(SIGNATURES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_loaded: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}  # kernel -> nvcc's output (-Xptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:12]}.so")


def build_all(names: List[str] = None) -> None:
    """Compile the missing libraries of entries `names` (default: all), one
    nvcc process per source, all started together; raises with nvcc's
    output if any build fails."""
    names = list(SIGNATURES) if names is None else names
    sources = dict.fromkeys(SOURCES.get(n, n) for n in names)
    todo = [n for n in sources if not os.path.exists(_lib_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = _nvcc()
    procs = []
    for n in todo:
        out = _lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it if needed."""
    name = SOURCES.get(name, name)
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib


def entry(name: str):
    """The C entry of kernel `name`, building its library if needed."""
    fn = _loaded.get(name)
    if fn is None:
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(_library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def helper(name: str, symbol: str, argtypes, restype):
    """A host-side helper `symbol` of kernel `name`'s library (a size
    query: it launches nothing)."""
    fn = _loaded.get(symbol)
    if fn is None:
        fn = getattr(_library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _loaded[symbol] = fn
    return fn


def launch(name: str, device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream (appended to
    `args`); raise on the cudaError_t its C entry returns, and count the
    launch."""
    fn = entry(name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous, 16-byte aligned `dtype` tensor of
    `shape` on `device` (a wrapper's argument check before a launch)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def pointer_array(ptrs) -> ctypes.Array:
    """A host array of device pointers (ints), for the array entries."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def size_array(sizes) -> ctypes.Array:
    return (ctypes.c_int64 * len(sizes))(*sizes)
