#!/usr/bin/env python3
"""K5f and the self-affinity backward in two designs, side by side on one card.

    python3 tools/affinity_zwalk.py      # one CUDA card

Builds ``tools/affinity_zwalk.cu`` (the staged z-walk design: each voxel
normalised once a block, the slice staged in shared memory with its halo,
a walk along z with a four-slice ring) into ``build/tools/`` beside the
package's ``csrc/affinity3d.cu`` and ``csrc/affinity_grad.cu`` (one thread
a voxel, each neighbour gathered through the cache), with the same flags
and C interface. Holds every form against the plain PyTorch versions
(K5f: float32 within 1e-6, bf16 8e-3; the backward: within 1e-5 of the
largest gradient, bf16 8e-3, the zero vector's voxel on its own), then
times both at the shapes the main paths give them: K5f at the 3D serving
tile batch (B=4) and the training batch (B=2), the backward at the
training batch, on the model's NCDHW output permuted without a copy and on
a channels-last embedding, float32 and bf16. Each time is a median of 20
with L2 flushed, by CUDA graph replay and by CUDA events around the eager
ctypes call, in turns (package, z-walk, z-walk, package). Prints each
kernel's registers, shared memory and spills and the card's name and
power limit; ``--json PATH`` also writes every number to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FLUSH = 64 << 20  # beyond the 50 MB L2
F32_ATOL, BF16_ATOL, GRAD_RTOL, BF16_GRAD_RTOL = 1e-6, 8e-3, 1e-5, 8e-3


def zero_at(shape) -> tuple:
    """(b, z, y, x) of the zero vector in a (B, D, H, W, C) embedding."""
    return 0, min(1, shape[1] - 1), min(3, shape[2] - 1), min(5, shape[3] - 1)


def build_zwalk() -> tuple[str, str]:
    """nvcc tools/affinity_zwalk.cu -> (library, ptxas log)."""
    from pixel_embedded_affinity_torch import cuda_build

    out = os.path.join(REPO, "build", "tools")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libaffinity_zwalk.so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC, "-o", so,
           os.path.join(REPO, "tools", "affinity_zwalk.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return so, proc.stdout + proc.stderr


def ptxas(log: str) -> dict:
    """{kernel: registers, shared memory, spills} from an -Xptxas -v log."""
    info, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        elif entry and ("spill" in ln or "Used" in ln):
            info[entry] = (info.get(entry, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    import chip_smoke

    return dict(zip(chip_smoke.demangled(info), info.values()))


class Forms:
    """One design's two entry points on tensors, through ctypes as the
    package's wrappers call them."""

    def __init__(self, fwd_lib: ctypes.CDLL, bwd_lib: ctypes.CDLL):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.f, self.b = fwd_lib.affinity3d_fwd, bwd_lib.affinity_bwd
        self.f.restype = self.b.restype = i
        self.f.argtypes = [p, p, i] + [i] * 5 + [i64] * 5 + [p, i, p]
        self.b.argtypes = [p, p, p, p, i] + [i] * 5 + [p, i, i, p]

    def fwd(self, e, shifts: np.ndarray):
        import torch

        b, d, h, w, c = e.shape
        out = torch.empty((b, len(shifts), d, h, w), dtype=e.dtype, device=e.device)
        err = self.f(
            e.data_ptr(), out.data_ptr(), int(e.dtype == torch.bfloat16), b, d, h, w, c,
            *e.stride(), shifts.ctypes.data, len(shifts), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"affinity3d_fwd: cudaError {err}"
        return out

    def bwd(self, e, g, offs: np.ndarray, raw: bool = False):
        import torch

        b, d, h, w, c = e.shape
        de = torch.empty((b, c, d, h, w), dtype=e.dtype, device=e.device)
        se = np.ascontiguousarray(e.stride(), dtype=np.int64)
        err = self.b(
            e.data_ptr(), se.ctypes.data, g.data_ptr(), de.data_ptr(),
            int(e.dtype == torch.bfloat16), b, d, h, w, c, offs.ctypes.data, len(offs), int(raw),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"affinity_bwd: cudaError {err}"
        return de.permute(0, 2, 3, 4, 1)


def embedding(gen, shape, dtype, as_view: bool):
    """(B, D, H, W, C) with a zero vector at zero_at(shape): the NCDHW tensor
    permuted, or channels-last."""
    import torch

    b, d, h, w, c = shape
    nc = torch.randn((b, c, d, h, w), generator=gen, device="cuda")
    zb, zz, zy, zx = zero_at(shape)
    nc[zb, :, zz, zy, zx] = 0.0
    e = nc.to(dtype).permute(0, 2, 3, 4, 1)
    return e if as_view else e.contiguous()


def check_forms(forms: dict, gen) -> dict:
    import torch

    import chip_smoke
    from pixel_embedded_affinity_torch.ops import (
        SHIFTS_3D, affinity_3d_plain, affinity_bwd_plain, multi_offset, offsets_3d)

    shifts = np.asarray(SHIFTS_3D, dtype=np.int32)
    odd = np.asarray((2, 0, 5, 5, -2, 1, 1, 12, -3), dtype=np.int32)
    offs = np.asarray(offsets_3d(SHIFTS_3D), dtype=np.int32)
    n8 = np.asarray([(0, dy, dx) for dy, dx in multi_offset([1, 3, 5, 9, 27], 8)],
                    dtype=np.int32)
    errs = {name: {"fwd": 0.0, "bwd": 0.0} for name in forms}
    cases = [((4, 18, 160, 160, 16), True, shifts), ((2, 18, 160, 160, 16), False, shifts),
             ((2, 5, 37, 41, 8), False, shifts), ((2, 3, 20, 25, 16), True, shifts),
             ((1, 7, 18, 20, 16), True, odd)]
    for shape, as_view, sh in cases:
        for dtype in (torch.float32, torch.bfloat16):
            e = embedding(gen, shape, dtype, as_view)
            ref = affinity_3d_plain(e, tuple(int(s) for s in sh)).float()
            for name, f in forms.items():
                got = f.fwd(e, sh)
                torch.cuda.synchronize()
                err = (got.float() - ref).abs().max().item()
                zb, zz, zy, zx = zero_at(shape)
                zero_ok = bool((got[zb, :, zz, zy, zx] == 0).all())
                tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
                print(f"[check] {name} K5f {shape} {'view' if as_view else 'ndhwc'} "
                      f"{str(dtype)[6:]} shifts {sh.tolist()}: {err:.3e}")
                chip_smoke.check(err <= tol and zero_ok, f"{name} K5f error {err} {zero_ok}")
                if dtype == torch.float32:
                    errs[name]["fwd"] = max(errs[name]["fwd"], err)
    bwd_cases = [((2, 18, 160, 160, 16), True, offs, False), ((2, 18, 160, 160, 16), False,
                                                               offs, False),
                 ((2, 5, 37, 41, 8), False, offs, False), ((2, 3, 20, 25, 16), True, offs, False),
                 ((2, 5, 37, 41, 8), True, offs, True), ((2, 1, 64, 72, 16), True, n8, False)]
    for shape, as_view, o, raw in bwd_cases:
        for dtype in (torch.float32, torch.bfloat16):
            e = embedding(gen, shape, dtype, as_view)
            g = torch.randn((shape[0], len(o)) + shape[1:4], generator=gen,
                            device="cuda").to(dtype)
            ref = affinity_bwd_plain(e, g, o.tolist(), normalized=raw)
            for name, f in forms.items():
                got = f.bwd(e, g, o, raw)
                torch.cuda.synchronize()
                rest, at_zero, m = chip_smoke._grad_err(got, ref, zero_at(shape))
                tol = GRAD_RTOL if dtype == torch.float32 else BF16_GRAD_RTOL
                if raw:  # the zero vector stays a zero vector: no voxel of its own
                    rest = at_zero = ((got.float() - ref.float()).abs().max()
                                      / ref.float().abs().max()).item()
                print(f"[check] {name} bwd {shape} {'view' if as_view else 'ndhwc'} "
                      f"{str(dtype)[6:]} K={len(o)} raw={raw}: rel ({rest:.3e}, {at_zero:.3e})")
                chip_smoke.check(rest <= tol and at_zero <= tol,
                                 f"{name} bwd error {rest}, {at_zero}")
                if dtype == torch.float32:
                    errs[name]["bwd"] = max(errs[name]["bwd"], m)
    return errs


def time_forms(forms: dict, gen) -> list:
    import torch

    import chip_smoke
    from pixel_embedded_affinity_torch.ops import SHIFTS_3D, offsets_3d

    shifts = np.asarray(SHIFTS_3D, dtype=np.int32)
    offs = np.asarray(offsets_3d(SHIFTS_3D), dtype=np.int32)
    k = len(shifts)
    rows = []
    cases = []
    for b in (4, 2):
        for dtype, as_view in ((torch.float32, True), (torch.bfloat16, True),
                               (torch.float32, False)):
            cases.append(("K5f", (b, 18, 160, 160, 16), dtype, as_view))
    for dtype, as_view in ((torch.float32, True), (torch.bfloat16, True), (torch.float32, False)):
        cases.append(("bwd", (2, 18, 160, 160, 16), dtype, as_view))
    names = list(forms)
    for kind, shape, dtype, as_view in cases:
        e = embedding(gen, shape, dtype, as_view)
        n = int(np.prod(shape[:4]))
        item = 2 if dtype == torch.bfloat16 else 4
        if kind == "K5f":
            fns = {name: (lambda f=f: f.fwd(e, shifts)) for name, f in forms.items()}
            bound = chip_smoke.affinity_bound(shape, k, item)[0]
        else:
            g = torch.randn((shape[0], k) + shape[1:4], generator=gen, device="cuda").to(dtype)
            fns = {name: (lambda f=f: f.bwd(e, g, offs)) for name, f in forms.items()}
            bound = chip_smoke.train3d_bound(n, 16, k, 1, 1, "bwd", itemsize=item)[0]
        t = {name: {"graph_ms": [], "event_ms": []} for name in names}
        for name in names + names[::-1]:  # package, z-walk, z-walk, package
            t[name]["graph_ms"].append(chip_smoke.graph_ms(fns[name], flush_bytes=FLUSH))
            t[name]["event_ms"].append(chip_smoke.timed_ms(fns[name], flush_bytes=FLUSH))
        row = {"kernel": kind, "shape": list(shape), "dtype": str(dtype)[6:],
               "layout": "NCDHW view" if as_view else "channels-last", "bound_ms": bound, **t}
        print(f"[time] {kind} {tuple(shape)} {row['dtype']} {row['layout']} (ms, L2 flushed, "
              f"median of 20, two turns; bound {bound:.4f}): " + "; ".join(
                  f"{name} graph {t[name]['graph_ms']}, events {t[name]['event_ms']}"
                  for name in names))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write every number to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("affinity_zwalk: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pixel_embedded_affinity_torch import cuda_build

    so, log = build_zwalk()
    zwalk = ctypes.CDLL(so)
    forms = {"package": Forms(ctypes.CDLL(cuda_build.build("affinity3d.cu")),
                              ctypes.CDLL(cuda_build.build("affinity_grad.cu"))),
             "zwalk": Forms(zwalk, zwalk)}
    regs = {"zwalk": ptxas(log)}
    for src in ("affinity3d.cu", "affinity_grad.cu"):
        with open(cuda_build.library_path(src)[:-3] + ".log") as f:
            regs[src] = ptxas(f.read())
    for lib, info in regs.items():
        for kern, what in info.items():
            print(f"[ptxas] {lib} {kern}: {what}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_forms(forms, gen)
    rows = time_forms(forms, gen)
    card = chip_smoke.card_line()
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "errors": errs, "times": rows, "ptxas": regs}, f, indent=1)
    print(json.dumps({"card": card, "errors": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
