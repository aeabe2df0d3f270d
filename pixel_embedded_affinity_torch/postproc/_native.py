"""ctypes loader for the native post-processing library.

Compiles ``csrc/pea_postproc.cpp`` with g++ at first use. The build is named
by the sha256 of the source, so a stale or foreign binary is never loaded.
Binaries are not committed (.gitignore lists ``csrc/*.so``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "pea_postproc.cpp")

_lock = threading.Lock()
_lib: list[ctypes.CDLL] = []


def so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_HERE, "csrc", f"libpea_postproc-{h}.so")


def build() -> str:
    """Compile the library unless its build exists; return the path."""
    so = so_path()
    if not os.path.exists(so):
        tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
               _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    with _lock:
        if _lib:
            return _lib[0]
        lib = ctypes.CDLL(build())
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.mws_segmentation.restype = i64
        lib.mws_segmentation.argtypes = [
            f32p, i32p, i32, i32, i64p, i32, i32p, i32, ctypes.c_uint64,
            ctypes.c_void_p, u32p]
        # the 3D decoders' entry points (watershed, agglomerate, multicut, MALIS)
        lib.seeded_watershed_2d.restype = None
        lib.seeded_watershed_2d.argtypes = [f32p, i32p, i64, i64, i32p]
        lib.agglomerate_scored.restype = i64
        lib.agglomerate_scored.argtypes = [f32p, u64p, i64, i64, i64, ctypes.c_double,
                                           i32, i32, u64p]
        lib.rag_mean_affinity.restype = i64
        lib.rag_mean_affinity.argtypes = [u64p, f32p, i64, i64, i64, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p]
        lib.gaec_multicut.restype = i64
        lib.gaec_multicut.argtypes = [i64, i64, u64p, f64p, i32, u64p]
        lib.lifted_gaec_multicut.restype = i64
        lib.lifted_gaec_multicut.argtypes = [i64, i64, u64p, f64p, i64, u64p, f64p, i32,
                                             u64p]
        lib.malis_weights.restype = i64
        lib.malis_weights.argtypes = [f32p, u32p, i64, i64, i64, ctypes.c_double, f32p]
        _lib.append(lib)
        return lib
