"""Build, load and bind the hand-written CUDA kernels in ``csrc/``.

New in the port (the JAX package compiled its Pallas kernels through
``pallas_call``).  Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  The build runs at first use, all sources at once in parallel,
into ``build/kernels/`` at the root of the checkout, keyed by a hash of the
source and the flags, so a fresh checkout builds everything on its first
kernel call and later processes reuse the libraries.

Every C entry returns ``cudaGetLastError()``; :func:`call` raises when it is
not 0.  :func:`call` is on every launch's path, so it keeps its host work
small: each C function is looked up once and kept with its argtypes, and
when the tensor's device is the current device the stream handle is read
directly, without entering a device context.

``LAUNCHES`` is the program's table of counters, plain integers: one per
kernel, which its wrapper adds to where it launches the kernel and nowhere
else, so a run can show which kernels its path went through (and the
elements the optimizer's kernels stepped); the host
cost of :func:`call` while a ``torch.profiler`` session runs (otherwise it
costs one test of the profiler's flag); the training BNs that run on
torch's ops, counted the same way (``ops/layers.py``); and the tiled
requests' tiles against the encoder slots they take (``inference/tiled.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _torch_profiler

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_F = ctypes.c_float
_RESIZE_ARGS = [_P] * 8 + [_I] * 6 + [_P]              # the scalar route
_RESIZE_TILED_ARGS = [_P] * 10 + [_I] * 10 + [_P]      # + spans; tile, lanes, shared memory
_RESIZE_BWD_TILED_ARGS = [_P] * 10 + [_I] * 12 + [_P]  # + the most pairs of a tile (row:
                                                       # the row pitch in the lanes' place)
_RESIZE_ROW_ARGS = [_P] * 10 + [_I] * 10 + [_P]         # + spans; tile, row pitch, shared memory
_CONV_ARGS = [_P] * 7 + [_I] * 6 + [_P]
_CONV_F32_ARGS = [_P] * 7 + [_I] * 8 + [_P]            # + the padded Ci and Co of the weights

# library -> {C function: argtypes}; every function returns int (cudaError_t)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "reparam": {
        "vaeunet_normal": [_P, _I64, _U64, _P],
        "vaeunet_reparam": [_P, _P, _F, _P, _I64, _U64, _P],
    },
    "bn_relu": {
        # x, y, scale, bias, mean, var, eps, rows, C, then the plan: V, block, grid
        "vaeunet_bn_relu_f32": [_P] * 6 + [_F, _I64] + [_I] * 6 + [_P],
        "vaeunet_bn_relu_bf16": [_P] * 6 + [_F, _I64] + [_I] * 6 + [_P],
    },
    "bn_train": {
        # y, out, s, q, weight, bias, running mean, var, count; 1 / n, eps,
        # momentum, 1 - momentum, n / (n - 1); rows; C, the plan, flags
        "vaeunet_bn_train_fwd_f32": [_P] * 9 + [_F] * 5 + [_I64] + [_I] * 7 + [_P],
        "vaeunet_bn_train_fwd_bf16": [_P] * 9 + [_F] * 5 + [_I64] + [_I] * 7 + [_P],
        # g, y, dy, s, q, weight, bias, partial, tickets, coef, dweight, dbias;
        # 1 / n, eps; rows; C, V, the sums pass's block and grid, dy's, relu
        "vaeunet_bn_train_bwd_f32": [_P] * 12 + [_F, _F, _I64] + [_I] * 11 + [_P],
        "vaeunet_bn_train_bwd_bf16": [_P] * 12 + [_F, _F, _I64] + [_I] * 11 + [_P],
    },
    "resize": {
        "vaeunet_resize_f32": _RESIZE_TILED_ARGS,
        "vaeunet_resize_bf16": _RESIZE_TILED_ARGS,
        "vaeunet_resize_row_f32": _RESIZE_ROW_ARGS,
        "vaeunet_resize_row_bf16": _RESIZE_ROW_ARGS,
        "vaeunet_resize_bwd_f32": _RESIZE_BWD_TILED_ARGS,
        "vaeunet_resize_bwd_bf16": _RESIZE_BWD_TILED_ARGS,
        "vaeunet_resize_row_bwd_f32": _RESIZE_BWD_TILED_ARGS,
        "vaeunet_resize_row_bwd_bf16": _RESIZE_BWD_TILED_ARGS,
        "vaeunet_resize_scalar_f32": _RESIZE_ARGS,
        "vaeunet_resize_scalar_bf16": _RESIZE_ARGS,
        "vaeunet_resize_bwd_scalar_f32": _RESIZE_ARGS,
        "vaeunet_resize_bwd_scalar_bf16": _RESIZE_ARGS,
    },
    "clip_adamw": {
        # table, tensors, partial, ticket, norm, blocks
        "vaeunet_clip_adamw_norm": [_P, _I, _P, _P, _P, _I, _P],
        # table, scalars, tensors, norm; 1 - lr wd, 1 - b1, b2, 1 - b2, eps,
        # max_norm; blocks
        "vaeunet_clip_adamw_update": [_P, _P, _I, _P] + [_F] * 6 + [_I, _P],
    },
    "conv_bn_stats": {
        "vaeunet_conv3x3_stats_f32": _CONV_F32_ARGS,
        "vaeunet_conv3x3_stats_bf16_wgmma": _CONV_ARGS,
        "vaeunet_conv3x3_stats_bf16_ci8": _CONV_ARGS,
    },
}

# counter -> its count since the last reset.  Kernel launches: "resize"
# counts its wrapper's launches on any route, "resize_row" those of them that
# took the row kernel, and "resize_bwd" / "resize_bwd_row" the same of the
# gradient's wrapper; "conv_bn_stats" counts its wrapper's launches of the
# wgmma and the fp32 kernels, "conv_bn_stats_fp32" those of the fp32 one, and
# "conv_bn_stats_ci8" those of the bf16 Ci <= 8 kernel (not in
# "conv_bn_stats").  "bn_train_fwd" and "bn_train_bwd" count the training
# BN kernels' forward launches and backward calls (two launches each).
# "clip_adamw_norm" and "clip_adamw_update" count the optimizer step's two
# launches (``ops/pallas/clip_adamw.py``), "clip_adamw_elems" the elements
# the update launches stepped.
# "ext_calls" and "ext_call_ns": the calls of `call` and their host
# nanoseconds, entry to return, counted only while a profiler session runs.
# "bn_torch" and "bn_torch_bytes": the training-mode BatchNorm forwards that
# run on torch's ops rather than the "bn_train" kernels (``ops/layers.py``:
# the 1x1 and strided sites, the latent and gate BNs, the remat recompute,
# the DP group's moments) and their inputs' bytes, counted only while a
# profiler session runs; a remat recompute counts its BNs again.
# "tiles" and "tile_slots": the tiles of the tiled requests' grids and the
# encoder batch slots they took, padding included.
LAUNCHES: Dict[str, int] = {"normal": 0, "reparam": 0, "bn_relu": 0, "resize": 0,
                            "resize_row": 0, "resize_bwd": 0, "resize_bwd_row": 0,
                            "conv_bn_stats": 0,
                            "conv_bn_stats_fp32": 0, "conv_bn_stats_ci8": 0,
                            "bn_train_fwd": 0, "bn_train_bwd": 0,
                            "clip_adamw_norm": 0, "clip_adamw_update": 0, "clip_adamw_elems": 0,
                            "bn_torch": 0, "bn_torch_bytes": 0,
                            "ext_calls": 0, "ext_call_ns": 0, "tiles": 0, "tile_slots": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
# C function -> the bound ctypes function (the names are unique across libraries)
_FNS: Dict[str, Callable[..., int]] = {}


def count_launch(kernel: str) -> None:
    LAUNCHES[kernel] += 1


def count_torch_bn(x: torch.Tensor) -> None:
    """Count a training-mode BatchNorm of `x` on torch's ops, while a
    profiler session runs."""
    if _torch_profiler._is_profiler_enabled:
        LAUNCHES["bn_torch"] += 1
        LAUNCHES["bn_torch_bytes"] += x.numel() * x.element_size()


def refuse_autograd(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward would run under autograd:
    its output would come back detached and cut the graph without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward; call it under torch.no_grad() "
            f"or with inputs that do not require grad")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile every library in `names` (default: all) that is not built
    yet, one ``nvcc`` process per source, all started together.

    -> {name: {"path", "seconds", "ptxas"}}; "seconds" is None and "ptxas"
    empty for a library that was already built.  Raises if a build fails.
    """
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info: Dict[str, dict] = {}
    procs = {}
    start = time.perf_counter()
    for name in names:
        out = library_path(name)
        info[name] = {"path": str(out), "seconds": None, "ptxas": []}
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        info[name]["seconds"] = time.perf_counter() - start
        info[name]["ptxas"] = [ln for ln in log.splitlines() if "ptxas" in ln]
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``; the first use builds every
    library not built yet (in parallel)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# the card's state, read through these two so a test can stand in for it
def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _raw_stream() -> int:
    """cudaStream_t of the current device's current stream, as an int."""
    return torch._C._cuda_getCurrentRawStream(-1)


def call(name: str, fn: str, device: torch.device, *args) -> None:
    """Launch C entry `fn` of library `name` on `device`'s current stream
    (the stream is appended as the last argument); raise on a CUDA error.
    While a profiler session runs, count the call and its host time."""
    if _torch_profiler._is_profiler_enabled:
        t0 = time.perf_counter_ns()
        try:
            _call(name, fn, device, args)
        finally:
            LAUNCHES["ext_calls"] += 1
            LAUNCHES["ext_call_ns"] += time.perf_counter_ns() - t0
    else:
        _call(name, fn, device, args)


def _call(name: str, fn: str, device: torch.device, args) -> None:
    f = _FNS.get(fn)
    if f is None:
        f = _FNS[fn] = getattr(library(name), fn)
    if device.index is None or device.index == _current_device():
        rc = f(*args, _raw_stream())
    else:
        with torch.cuda.device(device):
            rc = f(*args, _raw_stream())
    if rc != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {rc}")
