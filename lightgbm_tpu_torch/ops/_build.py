"""Build the port's CUDA kernels and bind them through ctypes.

Each library is one `.cu` file of `lightgbm_tpu_torch/csrc/` with a
plain C interface, compiled by `nvcc` for Hopper (`sm_90a`) into
`build/lightgbm_tpu_torch/lib<name>.so` under the checkout's root, and
loaded with `ctypes`. No PyTorch header is compiled, which keeps a build
to seconds. The build runs at first use, is redone when the source or
the flags change (a SHA-256 stamp beside the library), and is serialised
between threads by a lock and between processes by an exclusive file
lock. A failed build raises with `nvcc`'s stderr; nothing falls back.
`build_all` starts one nvcc per library at once.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from ..log import LightGBMError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lightgbm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _f, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint32
# the forest-walk pointer block shared by both entry points: x, n, F,
# the eleven Forest arrays, then T, M, L, C+2, W, K
_WALK_HEAD = [_p, _i, _i] + [_p] * 11 + [_i] * 6

# the training kernels hold bitwise to plain versions that round every
# f32 multiply and add separately: no fused multiply-add
_NO_FMA = ("-fmad=false",)

# library name -> (source file, {C entry point: argtypes}, extra flags)
LIBRARIES = {
    "forest": ("forest_walk.cu", {
        "lgbt_forest_value_walk": _WALK_HEAD + [_i, _f, _f, _f, _p, _p],
        "lgbt_forest_value_walk_f16": _WALK_HEAD
        + [_i, _i, _f, _f, _f, _p, _p],
        "lgbt_forest_leaf_walk": _WALK_HEAD + [_p, _p],
        "lgbt_forest_early_stop_walk": _WALK_HEAD + [_i, _f, _i, _p, _p, _p],
    }, ()),
    "quant": ("forest_quant.cu", {
        "lgbt_quant_codes": [_p, _i, _i, _p, _i, _i, _p, _p, _p],
        "lgbt_forest_quant_walk": _WALK_HEAD + [_p, _p, _p, _i, _i, _f, _f,
                                                _f, _p, _p],
    }, ()),
    "histogram": ("histogram.cu", {
        "lgbt_hist_tiles": [_i],
        "lgbt_leaf_histogram": [_p, _i, _p, _p, _i, _i, _i, _p, _p, _p],
        "lgbt_leaf_histogram_i32": [_p, _i, _p, _p, _p, _i, _i, _p, _p],
    }, _NO_FMA),
    "quantize": ("quantize.cu", {
        "lgbt_bagging_mask": [_u, _u, _f, _i, _p, _p],
        "lgbt_quantize_gradients": [_p, _p, _p, _i, _i] + [_u] * 4
        + [_i] + [_p] * 5,
    }, _NO_FMA),
    "goss": ("goss.cu", {
        "lgbt_goss_threshold": [_p, _p, _i, _i, _p, _p, _p, _p],
        "lgbt_goss_weights": [_p, _p, _i, _u, _u, _f, _f, _p, _p],
    }, _NO_FMA),
    "split": ("split_scan.cu", {
        "lgbt_split_scan": [_p] + [_i] * 5 + [_p] * 10 + [_f] * 3
        + [_i, _f, _i] + [_p] * 4,
    }, _NO_FMA),
    "route": ("route_partition.cu", {
        "lgbt_route_tiles": [_i],
        "lgbt_route_partition": [_p, _i, _p, _i, _i] + [_i] * 11
        + [_p, _p, _p, _p],
        "lgbt_score_update": [_p, _p, _p, _f, _i, _p],
        "lgbt_score_average": [_p, _p, _p, _f, _f, _i, _p],
    }, _NO_FMA),
    "rank": ("lambdarank.cu", {
        "lgbt_lambdarank_grads": [_p, _p, _i, _p, _p, _p, _f] + [_p] * 5,
        "lgbt_lambdarank_stage_cap": [],
    }, _NO_FMA),
    "walk": ("binned_walk.cu", {
        "lgbt_tree_value_walk_binned": [_p, _i, _i, _p, _i, _p, _p, _i, _p,
                                        _p, _p, _p],
    }, _NO_FMA),
    "linear": ("linear.cu", {
        "lgbt_linear_tile_rows": [],
        "lgbt_linear_normal_eq": [_p, _i] + [_p] * 5 + [_i, _p, _p, _i, _p,
                                                        _i] + [_p] * 5,
        "lgbt_linear_solve": [_p] * 5 + [_f, _i, _i] + [_p] * 4,
        "lgbt_linear_addend": [_p, _i, _i] + [_p] * 4 + [_i, _f, _p, _p],
    }, _NO_FMA),
    "moments": ("moments.cu", {
        "lgbt_moment_sort_tiles": [_i, _i],
        "lgbt_moment_tile_rows": [],
        "lgbt_moment_sort": [_p, _i, _p, _p, _i, _i] + [_p] * 5,
        "lgbt_leaf_moments": [_p, _i, _p, _p, _p, _p, _i, _p, _p, _i, _i,
                              _p, _p, _p],
    }, _NO_FMA),
}


@dataclass
class BuildRecord:
    path: Path
    seconds: float        # nvcc wall time, 0.0 when the stamp matched
    compiled: bool
    log: str              # nvcc/ptxas stderr (registers, spills)


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise LightGBMError("nvcc not found: the kernels of "
                            "lightgbm_tpu_torch need the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str) -> BuildRecord:
    """Compile library `name` unless its stamp matches; returns what
    was done. Safe to call from several processes at once."""
    source, _, extra = LIBRARIES[name]
    flags = NVCC_FLAGS + tuple(extra)
    src = CSRC / source
    # the shared headers count too: a source may include any of them
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f"lib{name}.so.sha256"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{name}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if (out.exists() and stamp.exists()
                and stamp.read_text() == digest):
            return BuildRecord(out, 0.0, False, "")
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise LightGBMError("nvcc failed (exit %d) building %s:\n%s"
                                % (proc.returncode, src, proc.stderr))
        os.replace(tmp, out)
        stamp.write_text(digest)
    return BuildRecord(out, seconds, True, proc.stderr)


def build_all() -> Dict[str, BuildRecord]:
    """Build every library, one nvcc process each, all started together."""
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        records = dict(zip(LIBRARIES, pool.map(build, LIBRARIES)))
    return records


def load_library(name: str) -> ctypes.CDLL:
    """The bound library `name`, built on first use in this process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name).path))
            for entry, argtypes in LIBRARIES[name][1].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.lgbt_error_string.argtypes = [ctypes.c_int]
            lib.lgbt_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib
