#!/usr/bin/env python3
"""What the card's TMA and tf32 wgmma do with float32, before CWg and CXg
rely on it.

    python3 tools/wgmma_tf32_probe.py      # one CUDA card

Builds tools/wgmma_tf32_probe.cu (the package's nvcc flags, the
instruction wrappers of csrc/wgmma_tma.cuh) into build/tools/ and checks:

* a float32 box of 32 elements x 8 rows under the 128-byte swizzle lands
  in shared memory densely (row r at byte 128 r) with the 16-byte pieces
  of each row permuted by the address bits above them, the layout the
  wgmma descriptors read, and unswizzled densely; at negative coordinates
  and past the tensor's end the box reads 0 (the zero fill CWg and CXg
  take for padding); an innermost coordinate that is not a multiple of 16
  bytes (-5 or 6 floats) stops the kernel, which is why CWg and CXg load a
  shifted tap from its start rounded down. Each box case runs in a
  process of its own (``--tma CASE``), since a fault ends the context;
* what the tensor cores make of a float32 container's low 13 bits in a
  tf32 wgmma: 64 values between 1 and 1 + 63/4096 (and their negatives)
  through m64n8k8 against 1, held against truncation, round-half-away
  (cvt.rna.tf32.f32), round-half-even and full float32;
* the register fragment layout of A in m64nNk8 .tf32 (the header's
  statement) by an exact integer product, m64n16k8.

Prints one line per check and the card's name and power limit; exits 1 if
a check comes out otherwise (a box case faults or lands against its list)
or the low-bit rule matches none of the candidates.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build() -> str:
    from pixel_embedded_affinity_torch import cuda_build

    out = os.path.join(REPO, "build", "tools")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libwgmma_tf32_probe.so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC, "-o", so,
           os.path.join(REPO, "tools", "wgmma_tf32_probe.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return so


def tf32(v: np.ndarray, rule: str) -> np.ndarray:
    """float32 ``v`` as a tf32 value under ``rule``."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    if rule == "truncate":
        r = u & 0xFFFFE000
    elif rule == "round_half_away":
        r = (u + 0x1000) & 0xFFFFE000
    elif rule == "round_half_even":
        r = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    else:
        r = u
    return r.astype(np.uint32).view(np.float32)


def swizzled(rows: np.ndarray) -> np.ndarray:
    """rows (8, 32) float32 as the 128-byte swizzle lays them out: 256
    floats, row r's 16-byte piece c at piece c ^ (r % 8)."""
    out = np.empty(256, np.float32)
    for r in range(8):
        for c in range(8):
            p = c ^ (r % 8)
            out[r * 32 + 4 * p: r * 32 + 4 * p + 4] = rows[r, 4 * c: 4 * c + 4]
    return out


# (inner, rows, outer, c0, c1, c2, rank, swizzle): a box that lands; c0 off
# 16 bytes (FAULTS) stops the kernel
TMA_CASES = [(128, 12, 2, 0, 0, 0, 3, 128), (100, 12, 2, 0, 0, 0, 3, 128),
             (100, 12, 2, 0, 0, 0, 2, 128), (100, 12, 2, 0, 0, 0, 3, 0),
             (100, 12, 2, 80, 9, 1, 3, 128), (100, 12, 2, -4, 2, 0, 3, 128),
             (100, 12, 2, -4, 2, 0, 3, 0), (100, 12, 2, 36, 2, 1, 3, 0)]
FAULTS = [(100, 12, 2, -5, 2, 0, 3, 128), (128, 12, 2, -5, 9, 1, 3, 128),
          (100, 12, 2, 6, 2, 0, 3, 0), (100, 12, 2, 6, 2, 0, 3, 128)]


def tma_case(lib, case) -> bool:
    import torch

    inner, rows, outer, c0, c1, c2, rank, swz = case
    x = np.random.default_rng(1).normal(size=(outer, rows, inner)).astype(np.float32)
    xd = torch.from_numpy(x).cuda()
    out = torch.empty(256, device="cuda")
    rc = lib.tma_probe(xd.data_ptr(), inner, rows, outer, c0, c1, c2, out.data_ptr(), rank, swz)
    if rc:
        print(f"[probe] tma {case}: error {rc} (-1: cuTensorMapEncodeTiled refused the map)")
        return False
    flat = x.reshape(outer * rows, inner) if rank == 2 else None
    want = np.zeros((8, 32), np.float32)
    for r in range(8):
        for k in range(32):
            a, b = c0 + k, c1 + r
            if rank == 2:
                if 0 <= a < inner and 0 <= b < rows * outer:
                    want[r, k] = flat[b, a]
            elif 0 <= a < inner and 0 <= b < rows and 0 <= c2 < outer:
                want[r, k] = x[c2, b, a]
    got = out.cpu().numpy()
    expect = swizzled(want) if swz == 128 else want.reshape(-1)
    good = np.array_equal(got, expect)
    print(f"[probe] tma {case}: dense rows{', 128-byte swizzle' if swz else ''}, zero fill "
          f"{'holds' if good else 'FAILS'}")
    return good


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wgmma_tf32_probe: no CUDA device", file=sys.stderr)
        return 1
    tma_only = len(sys.argv) == 3 and sys.argv[1] == "--tma"
    lib = ctypes.CDLL(os.path.join(REPO, "build", "tools", "libwgmma_tf32_probe.so") if tma_only
                      else build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tma_probe.restype = lib.tf32_probe.restype = i
    lib.tma_probe.argtypes = [p, i, i, i, i, i, i, p, i, i]
    if tma_only:
        return 0 if tma_case(lib, json.loads(sys.argv[2])) else 1
    lib.tf32_probe.argtypes = [p] * 5
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(0)
    j = np.arange(64)
    va = np.where(j < 32, 1 + (j % 32) / 4096, -(1 + (j % 32) / 4096) * 3).astype(np.float32)
    va[60:] = rng.normal(size=4).astype(np.float32)
    fa = rng.integers(-4, 5, size=(64, 8)).astype(np.float32)
    fb = rng.integers(-4, 5, size=(16, 8)).astype(np.float32)
    low = torch.empty(64 * 8, device="cuda")
    frag = torch.empty(64 * 16, device="cuda")
    tens = [torch.from_numpy(a).cuda() for a in (va, fa, fb)]
    rc = lib.tf32_probe(*(t.data_ptr() for t in tens), low.data_ptr(), frag.data_ptr())
    if rc:
        print(f"[probe] tf32 wgmma: cudaError {rc}")
        return 1
    ok = True
    got = low.cpu().numpy().reshape(64, 8)
    same_cols = bool((got == got[:, :1]).all())
    rules = [r for r in ("truncate", "round_half_away", "round_half_even", "float32")
             if np.array_equal(got[:, 0], tf32(va, r))]
    print(f"[probe] tf32 wgmma on a float32 container's low 13 bits: matches {rules or 'NONE'} "
          f"(columns equal {same_cols}); {json.dumps([float(v) for v in got[:8, 0]])}")
    ok &= bool(rules) and same_cols
    want = fa @ fb.T
    got = frag.cpu().numpy().reshape(64, 16)
    lay = np.array_equal(got, want)
    print(f"[probe] wgmma m64n16k8 .tf32 with A from registers (rows g, g + 8, columns t, t + 4): "
          f"{'exact' if lay else 'DIFFERS, max ' + str(float(np.abs(got - want).max()))}")
    ok &= lay
    for case in TMA_CASES + FAULTS:  # each in its own process: a fault ends the context
        proc = subprocess.run([sys.executable, __file__, "--tma", json.dumps(case)],
                              capture_output=True, text=True, timeout=120)
        print(proc.stdout.strip() or f"[probe] tma {case}: rc {proc.returncode} "
                                     f"{proc.stderr.strip()[-300:]}")
        ok &= (proc.returncode == 0) == (case in TMA_CASES)
    print(f"[probe] {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
