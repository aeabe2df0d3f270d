"""Build the package's CUDA sources into plain-C shared libraries.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/lib<name>-<hash>.so`` beside the package, at first
use, and loaded with ctypes. The file name carries the sha256 of the
source and of every shared header ``csrc/*.cuh`` it may include, so a
stale build is never loaded. ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills) goes to a ``.log`` next to the library.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def library_path(source: str, csrc: str = CSRC) -> str:
    """Where the build of ``<csrc>/<source>`` lives, named by the hash of the
    source and of the shared headers ``<csrc>/*.cuh``."""
    digest = hashlib.sha256()
    for path in [os.path.join(csrc, source)] + sorted(glob.glob(os.path.join(csrc, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    h = digest.hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its build exists; return the path."""
    so = library_path(source)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.splitext(so)[0] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(source: str) -> ctypes.CDLL:
    """Build (once) and load the library of ``csrc/<source>``."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _libs[source] = lib
        return lib
