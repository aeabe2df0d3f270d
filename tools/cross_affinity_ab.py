#!/usr/bin/env python3
"""The cross-view affinity kernels beside another build of them, on one card.

    python3 tools/cross_affinity_ab.py --before DIR [--json PATH]   # one CUDA card

Builds ``csrc/affinity_grad.cu`` as the package ships it ("package") and
the ``affinity_grad.cu`` in DIR ("before"; e.g. an earlier commit's
``pixel_embedded_affinity_torch/csrc`` unpacked by ``git archive``), each
with the package's nvcc flags into ``build/tools/``. Both have one C
interface, ``cross_affinity_fwd`` and ``cross_affinity_bwd``, called
through ctypes as the package's wrappers call them. Holds both builds
against the plain PyTorch versions (affinities float32 within 1e-5, bf16
8e-3; gradients within 1e-5 of the largest, bf16 8e-3, the zero vector's
voxel on its own), then times them at the 3D train step's B=2
18x160x160, C=16, 12 offsets, and at K4f's B=2 256x256, C=16, neighbor 4
(D = 1). The 3D layouts: the model's NCDHW output permuted without a copy
for student and teacher (what the 3D train step hands the kernels); a
channels-last student with the teacher channels-last, H/W-swapped (what
the un-flip made of a channels-last teacher before it kept its input's
strides), an NCDHW view, or an NCDHW view with H and W swapped (the
parent commit's in-step layout, before the step gave its inputs standard
NCDHW strides). No main path hands the kernels a channels-last
embedding; the wrappers take any strides, and those layouts exercise the
16-byte load path. In 2D the student is an NCHW view and the teacher in
its layout or swapped. Forward, backward without db (the train step's
call) and, on two layouts, with db. Each time is a median of 20 with L2
flushed, by CUDA graph replay and by CUDA events around the eager ctypes
call, in turns (the builds in order, then reversed). Prints each
kernel's registers and spills and the card's name and power limit;
``--json PATH`` also writes every number to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from affinity_zwalk import ptxas, zero_at  # noqa: E402  (tools/, the script's directory)

FLUSH = 64 << 20  # beyond the 50 MB L2
F32_ATOL, BF16_ATOL, GRAD_RTOL, BF16_GRAD_RTOL = 1e-5, 8e-3, 1e-5, 8e-3


def build(name: str, source: str) -> tuple[str, str]:
    """nvcc ``source`` (its own directory on the include path) -> (library,
    ptxas log) under build/tools/."""
    from pixel_embedded_affinity_torch import cuda_build

    out = os.path.join(REPO, "build", "tools")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"libcross_{name}.so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", os.path.dirname(os.path.abspath(source)), "-o", so, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return so, proc.stdout + proc.stderr


class Build:
    """One build's two cross entry points on tensors."""

    def __init__(self, lib: ctypes.CDLL):
        p, i = ctypes.c_void_p, ctypes.c_int
        shape = [i] * 5
        self.f, self.b = lib.cross_affinity_fwd, lib.cross_affinity_bwd
        self.f.restype = self.b.restype = i
        self.f.argtypes = [p] * 5 + [i] + shape + [p, i, p]
        self.b.argtypes = [p] * 7 + [i] + shape + [p, i, i, p]

    @staticmethod
    def _strides(x):
        return np.ascontiguousarray(x.stride(), dtype=np.int64)

    def fwd(self, a, b, offs: np.ndarray):
        import torch

        bs, d, h, w, c = a.shape
        out = torch.empty((bs, len(offs), d, h, w), dtype=a.dtype, device=a.device)
        sa, sb = self._strides(a), self._strides(b)
        err = self.f(a.data_ptr(), sa.ctypes.data, b.data_ptr(), sb.ctypes.data, out.data_ptr(),
                     int(a.dtype == torch.bfloat16), bs, d, h, w, c, offs.ctypes.data, len(offs),
                     torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"cross_affinity_fwd: cudaError {err}"
        return out

    def bwd(self, a, b, g, offs: np.ndarray, need_db: bool, raw: bool = False):
        import torch

        bs, d, h, w, c = a.shape
        da = torch.empty((bs, c, d, h, w), dtype=a.dtype, device=a.device)
        db = torch.empty_like(da) if need_db else None
        sa, sb = self._strides(a), self._strides(b)
        err = self.b(a.data_ptr(), sa.ctypes.data, b.data_ptr(), sb.ctypes.data, g.data_ptr(),
                     da.data_ptr(), db.data_ptr() if need_db else None,
                     int(a.dtype == torch.bfloat16), bs, d, h, w, c, offs.ctypes.data, len(offs),
                     int(raw), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"cross_affinity_bwd: cudaError {err}"
        return (da.permute(0, 2, 3, 4, 1), db.permute(0, 2, 3, 4, 1) if need_db else None)


def embedding(gen, shape, dtype, layout: str):
    """(B, D, H, W, C) with a zero vector at zero_at(shape): "view" the
    NCDHW tensor permuted, "cl" channels-last, "-swapped" either stored with
    H and W swapped (the old un-flip's teacher)."""
    import torch

    import chip_smoke

    b, d, h, w, c = shape
    nc = torch.randn((b, c, d, h, w), generator=gen, device="cuda")
    zb, zz, zy, zx = zero_at(shape)
    nc[zb, :, zz, zy, zx] = 0.0
    e = nc.to(dtype).permute(0, 2, 3, 4, 1)
    if layout.startswith("cl"):
        e = e.contiguous()
    return chip_smoke.swapped_view(e) if layout.endswith("swapped") else e


def plain_fwd(a, b, offs):
    from pixel_embedded_affinity_torch.ops.emb2aff import normalize_embedding, offset_affinity_3d

    return offset_affinity_3d(normalize_embedding(a.float()), normalize_embedding(b.float()),
                              offs.tolist()).to(a.dtype)


def tables():
    from pixel_embedded_affinity_torch.ops import SHIFTS_3D, multi_offset, offsets_3d

    t3 = np.asarray(offsets_3d(SHIFTS_3D), dtype=np.int32)
    t2 = np.asarray([(0, dy, dx) for dy, dx in multi_offset([1, 3, 5, 9, 11], 4)],
                    dtype=np.int32)
    return t3, t2


TRAIN3D, K4F = (2, 18, 160, 160, 16), (2, 1, 256, 256, 16)
LAYOUTS_3D = [("view", "view"), ("cl", "cl"), ("cl", "cl-swapped"), ("cl", "view"),
              ("cl", "view-swapped")]
LAYOUTS_2D = [("view", "view"), ("view", "view-swapped")]


def check_builds(builds: dict, gen) -> dict:
    import torch

    import chip_smoke
    from pixel_embedded_affinity_torch.ops import cross_affinity_bwd_plain

    t3, t2 = tables()
    errs = {name: {"fwd": 0.0, "bwd": 0.0} for name in builds}
    cases = [(TRAIN3D, la, lb, t3) for la, lb in LAYOUTS_3D]
    cases += [((2, 3, 20, 20, 8), "cl", "cl-swapped", t3), ((1, 5, 37, 41, 16), "view", "cl", t3)]
    cases += [((2, 1, 64, 64, 16), la, lb, t2) for la, lb in LAYOUTS_2D]
    for shape, la, lb, offs in cases:
        for dtype in (torch.float32, torch.bfloat16):
            a, b = embedding(gen, shape, dtype, la), embedding(gen, shape, dtype, lb)
            g = torch.randn((shape[0], len(offs)) + shape[1:4], generator=gen,
                            device="cuda").to(dtype)
            ref = plain_fwd(a, b, offs).float()
            refs = cross_affinity_bwd_plain(a, b, g, offs.tolist())
            f32 = dtype == torch.float32
            for name, f in builds.items():
                got = f.fwd(a, b, offs)
                grads = f.bwd(a, b, g, offs, need_db=True)
                da_only, _ = f.bwd(a, b, g, offs, need_db=False)
                torch.cuda.synchronize()
                err = (got.float() - ref).abs().max().item()
                zb, zz, zy, zx = zero_at(shape)
                zero_ok = bool((got[zb, :, zz, zy, zx] == 0).all())
                gerrs = [chip_smoke._grad_err(x, r, zero_at(shape)) for x, r in zip(grads, refs)]
                same = bool(torch.equal(da_only, grads[0]))
                print(f"[check] {name} {shape} {str(dtype)[6:]} a {la}, b {lb}: fwd {err:.3e}; "
                      f"da, db rel (rest, zero voxel) " + ", ".join(
                          f"({x:.3e}, {z:.3e})" for x, z, _ in gerrs)
                      + f"; da without db equal: {same}")
                tol, gtol = (F32_ATOL, GRAD_RTOL) if f32 else (BF16_ATOL, BF16_GRAD_RTOL)
                chip_smoke.check(err <= tol and zero_ok, f"{name} fwd error {err}, {zero_ok}")
                for x, z, _ in gerrs:
                    chip_smoke.check(x <= gtol and z <= gtol, f"{name} bwd error {x}, {z}")
                chip_smoke.check(same, f"{name}: da without db differs")
                if f32:
                    errs[name]["fwd"] = max(errs[name]["fwd"], err)
                    errs[name]["bwd"] = max(errs[name]["bwd"], *(m for _, _, m in gerrs))
    return errs


def time_builds(builds: dict, gen) -> list:
    import torch

    import chip_smoke

    t3, t2 = tables()
    cases = []
    for la, lb in LAYOUTS_3D:
        cases.append(("fwd", TRAIN3D, torch.float32, la, lb))
        cases.append(("bwd", TRAIN3D, torch.float32, la, lb))
    for la, lb in LAYOUTS_3D[:2]:
        cases.append(("fwd", TRAIN3D, torch.bfloat16, la, lb))
        cases.append(("bwd", TRAIN3D, torch.bfloat16, la, lb))
        cases.append(("bwd+db", TRAIN3D, torch.float32, la, lb))
    for la, lb in LAYOUTS_2D:
        cases.append(("fwd", K4F, torch.float32, la, lb))
        cases.append(("bwd", K4F, torch.float32, la, lb))
    names = list(builds)
    rows = []
    for kind, shape, dtype, la, lb in cases:
        offs = t2 if shape[1] == 1 else t3
        a, b = embedding(gen, shape, dtype, la), embedding(gen, shape, dtype, lb)
        g = torch.randn((shape[0], len(offs)) + shape[1:4], generator=gen, device="cuda").to(dtype)
        n, item = int(np.prod(shape[:4])), 2 if dtype == torch.bfloat16 else 4
        if kind == "fwd":
            fns = {name: (lambda f=f: f.fwd(a, b, offs)) for name, f in builds.items()}
            bound = chip_smoke.train3d_bound(n, 16, len(offs), 2, 0, "fwd", itemsize=item)[0]
        else:
            db = kind == "bwd+db"
            fns = {name: (lambda f=f: f.bwd(a, b, g, offs, db)) for name, f in builds.items()}
            bound = chip_smoke.train3d_bound(n, 16, len(offs), 2, 1 + db, "bwd",
                                             itemsize=item)[0]
        t = {name: {"graph_ms": [], "event_ms": []} for name in names}
        for name in names + names[::-1]:
            t[name]["graph_ms"].append(chip_smoke.graph_ms(fns[name], flush_bytes=FLUSH))
            t[name]["event_ms"].append(chip_smoke.timed_ms(fns[name], flush_bytes=FLUSH))
        row = {"kernel": kind, "shape": list(shape), "dtype": str(dtype)[6:], "a": la, "b": lb,
               "bound_ms": bound, **t}
        print(f"[time] {kind} {tuple(shape)} {row['dtype']} a {la}, b {lb} (ms, L2 flushed, "
              f"median of 20, two turns; bound {bound:.4f}): " + "; ".join(
                  f"{name} graph {[round(v, 4) for v in t[name]['graph_ms']]}, events "
                  f"{[round(v, 4) for v in t[name]['event_ms']]}" for name in names))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", required=True,
                    help="a directory holding another affinity_grad.cu")
    ap.add_argument("--json", help="also write every number to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cross_affinity_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pixel_embedded_affinity_torch import cuda_build

    forms = {"before": os.path.join(args.before, "affinity_grad.cu"),
             "package": os.path.join(cuda_build.CSRC, "affinity_grad.cu")}
    builds, regs = {}, {}
    for name, path in forms.items():
        so, log = build(name, path)
        builds[name] = Build(ctypes.CDLL(so))
        regs[name] = {k: v for k, v in ptxas(log).items() if "cross" in k}
        for kern, what in regs[name].items():
            print(f"[ptxas] {name} {kern}: {what}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = check_builds(builds, gen)
    rows = time_builds(builds, gen)
    card = chip_smoke.card_line()
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "errors": errs, "times": rows, "ptxas": regs}, f, indent=1)
    print(json.dumps({"card": card, "errors": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
