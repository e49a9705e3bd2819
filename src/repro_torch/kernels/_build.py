"""Build and bind the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled on first use with ``nvcc`` into a
shared library with a plain C interface (``build/repro_torch/`` at the
root of the checkout, named by a hash of the source so an edited kernel
never loads a stale build) and loaded with :mod:`ctypes`. Nothing is
built when a module is imported: the CPU path never needs a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int
F32 = ctypes.c_float

# C entry points of each source: name -> argtypes (restype is int, the
# launch's cudaGetLastError())
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "delta_join": {
        "rt_delta_join": (P, P, P, P, P, P, I64, I64, I32, I32, P),
        "rt_fused_join_digest": (P, P, P, P, P, P, P, P, I64, I64, I32, I32,
                                 P),
        "rt_chunk_digest": (P, P, P, I64, I64, I32, I32, P),
        "rt_scatter_join": (P, P, P, P, P, P, P, P, P, I64, I64, I32, I32,
                            P),
    },
    "flash_attention": {
        # q, k, v, o; B, H, KV, SQ, SK, hd; (batch, head, seq) strides of
        # q, k, v, o; scale, window, softcap, dtype, stream
        "rt_flash_attention": (P, P, P, P) + (I32,) * 6 + (I64,) * 12
        + (F32, I32, F32, I32, P),
        # the same arguments, tensor-core route
        "rt_flash_attention_tc": (P, P, P, P) + (I32,) * 6 + (I64,) * 12
        + (F32, I32, F32, I32, P),
        # q, k, v, q_pos, k_pos, o, partials, counters; B, H, KV, C, hd,
        # splits, slots per split, slots per tile, threads per slot, vec;
        # strides of q (2), k (3), v (3), q_pos (1), k_pos (2), o (2);
        # scale, window, softcap, dtype, stream
        "rt_flash_decode": (P,) * 8 + (I32,) * 10 + (I64,) * 13
        + (F32, I32, F32, I32, P),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def compile_source(name: str) -> subprocess.Popen:
    """Start ``nvcc`` on ``csrc/<name>.cu`` and return the process (its
    output is the ``-Xptxas -v`` register report). Callers building
    several sources start them all before waiting on any."""
    out = lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp
    return proc


def finish(proc: subprocess.Popen) -> str:
    """Wait for a :func:`compile_source` process, move its library into
    place and return the compiler's report; raises on a failed build."""
    report, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
    os.replace(proc.tmp_path, proc.out_path)
    return report


def library(name: str = "delta_join") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = lib_path(name)
        if not path.exists():
            finish(compile_source(name))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib
