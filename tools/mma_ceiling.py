#!/usr/bin/env python3
"""The card's mma.sync ceiling, the rate K7/K9 and K8 can reach at most.

    python3 tools/mma_ceiling.py      # one CUDA card

Builds tools/mma_ceiling.cu (nvcc, sm_90a, the flags of the package's
kernels, csrc/mma_tc.cuh's instruction wrappers) into build/tools/ and runs
blocks of 8 warps that issue only independent m16n8k8 TF32 and m16n8k16
bf16 products, at 1, 2 and 4 blocks an SM; prints TFLOP/s against the data
sheet's dense tensor-core peaks (495 TF32, 989 bf16) with the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PEAKS = {"tf32 m16n8k8": (2 * 16 * 8 * 8, 495e12), "bf16 m16n8k16": (2 * 16 * 8 * 16, 989e12)}
ITERS = 4096


def build() -> str:
    from pixel_embedded_affinity_torch import cuda_build

    out = os.path.join(REPO, "build", "tools")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libmma_ceiling.so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC, "-o", so,
           os.path.join(REPO, "tools", "mma_ceiling.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_ceiling: no CUDA device", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(build())
    lib.mma_ceiling.restype = ctypes.c_int
    lib.mma_ceiling.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    out = torch.zeros(256, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for bf16, (name, (flop, peak)) in enumerate(PEAKS.items()):
        for per_sm in (1, 2, 4):
            blocks = per_sm * sms

            def run():
                err = lib.mma_ceiling(bf16, blocks, ITERS, out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            run()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
            rate = blocks * 8 * ITERS * 8 * flop / (ms * 1e-3)
            print(f"[mma ceiling] {name}, {per_sm} block(s) of 8 warps an SM: {ms:.4f} ms, "
                  f"{rate / 1e12:.1f} TFLOP/s, {rate / peak:.3f} of the dense peak; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
