#!/usr/bin/env python3
"""The loss-fused WMSE kernels and K1f beside another build of them, on one card.

    python3 tools/wmse_ab.py --before DIR [--json PATH]   # one CUDA card

Builds ``csrc/affinity_wmse2d.cu`` and ``csrc/affinity2d.cu`` as the
package ships them ("package") and the two files of the same names in DIR
("before"; e.g. an earlier commit's ``pixel_embedded_affinity_torch/csrc``
unpacked by ``git archive``), each with the package's nvcc flags into
``build/tools/``. Each pair has one C interface, launched by the package's
own launch code (``ops/emb2aff_wmse_cuda.py``, ``ops/emb2aff_cuda.py``).

The WMSE kernels (``wmse2d_fwd``, ``cross_wmse2d_fwd``, ``wmse2d_bwd``,
``cross_wmse2d_bwd``): at the CVPPP step's full scale, B=2 544x544, C=16,
K=10, on the model's NCHW output permuted to (B, H, W, C) with a zero
vector, holds both builds against the plain PyTorch versions (affinities
within 1e-5, the sums S relative 1e-5, gradients within 1e-5 of the
largest and at the zero vector's pixel of its own), then times K2f, K3f,
K2b, K3b with db and, in a build whose cross entry takes a null db (the
package's), K3b without db, the training steps' call.

K1f (``affinity2d_fwd``): on the serving path's NCHW view of B=1 544x544,
C=16, neighbor 4's 10 offsets, with a zero vector, holds both builds
against the plain version (float32 within 1e-5, bfloat16 8e-3, exact zeros
at the zero vector), then times them at B = 1, 4 and 8 in float32 and
bfloat16.

Each time is a median of 20 with L2 flushed, by CUDA graph replay and by
CUDA events around the eager call, in turns (the builds in order, then
reversed). Prints each kernel's registers and spills and the card's name
and power limit; ``--json PATH`` also writes every number to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from affinity_zwalk import ptxas  # noqa: E402  (tools/, the script's directory)
from cross_affinity_ab import build  # noqa: E402

FLUSH = 64 << 20  # beyond the 50 MB L2
F32_ATOL, BF16_ATOL, S_RTOL, GRAD_RTOL = 1e-5, 8e-3, 1e-5, 1e-5
B, SIDE, C, K = 2, 544, 16, 10
ZERO_PX = (0, 3, 5)
K1F_BATCHES = (1, 4, 8)


class Build:
    """One build's WMSE entry points, launched through the package's own
    launch code (``emb2aff_wmse_cuda._fwd``/``_bwd`` with its library)."""

    def __init__(self, lib: ctypes.CDLL, takes_null_db: bool):
        from pixel_embedded_affinity_torch.ops import emb2aff_wmse_cuda as W

        self.W, self.lib, self.takes_null_db = W, W.bind(lib), takes_null_db

    def fwd(self, embs, maps, offs: np.ndarray):
        """(S (K,), affs) of one embedding (K2f) or of a and b (K3f)."""
        entry = "wmse2d_fwd" if len(embs) == 1 else "cross_wmse2d_fwd"
        return self.W._fwd(entry, embs, *maps, offs, lib=self.lib)

    def bwd(self, embs, maps, gs, offs: np.ndarray, n_grads: int):
        """The gradients of the first n_grads embeddings, (B, H, W, C) views."""
        entry = "wmse2d_bwd" if len(embs) == 1 else "cross_wmse2d_bwd"
        return self.W._bwd(entry, embs, *maps, gs, offs, n_grads, lib=self.lib)


def inputs(gen):
    """Student and teacher (NCHW permuted, a zero vector each), t/w/m, gS."""
    import torch

    embs = []
    for _ in range(2):
        e = torch.randn((B, C, SIDE, SIDE), generator=gen, device="cuda")
        e[ZERO_PX[0], :, ZERO_PX[1], ZERO_PX[2]] = 0.0
        embs.append(e.permute(0, 2, 3, 1))
    shape = (B, K, SIDE, SIDE)
    t = (torch.rand(shape, generator=gen, device="cuda") > 0.5).float()
    w = torch.rand(shape, generator=gen, device="cuda") * 2.0 + 0.05
    m = (torch.rand(shape, generator=gen, device="cuda") > 0.2).float()
    gs = torch.rand((K,), generator=gen, device="cuda") / (2 * SIDE) + 1e-4
    return embs, (t, w, m), gs


def check_builds(builds: dict, embs, maps, gs, offs) -> dict:
    import torch

    import chip_smoke
    from pixel_embedded_affinity_torch.ops import emb2aff_wmse_cuda as W

    errs = {}
    for kind, views in (("K2", embs[:1]), ("K3", embs)):
        req = [e.detach().clone().requires_grad_() for e in views]
        plain = W.affinity_wmse_2d_plain if kind == "K2" else W.cross_affinity_wmse_2d_plain
        s_ref, affs_ref = plain(*req, *maps, offs.tolist())
        refs = torch.autograd.grad(s_ref, req, gs)
        for name, f in builds.items():
            s, affs = f.fwd(views, maps, offs)
            grads = f.bwd(views, maps, gs, offs, len(views))
            if kind == "K3" and f.takes_null_db:
                grads += f.bwd(views, maps, gs, offs, 1)
            torch.cuda.synchronize()
            err_a = (affs - affs_ref).abs().max().item()
            err_s = ((s - s_ref).abs() / s_ref.abs()).max().item()
            gerrs = [chip_smoke._grad_err(g, r, ZERO_PX)
                     for g, r in zip(grads, [*refs, refs[0]])]
            print(f"[check] {name} {kind} B={B} {SIDE}x{SIDE}: affs {err_a:.3e}, S rel "
                  f"{err_s:.3e}, grads rel (rest, zero-vector pixel) " + ", ".join(
                      f"({a:.3e}, {z:.3e})" for a, z, _ in gerrs)
                  + (" (de)" if kind == "K2" else " (da, db, da without db)"))
            chip_smoke.check(err_a <= F32_ATOL and err_s <= S_RTOL,
                             f"{name} {kind}f errors {err_a}, {err_s}")
            for a, z, _ in gerrs:
                chip_smoke.check(a <= GRAD_RTOL and z <= GRAD_RTOL,
                                 f"{name} {kind}b error {a}, {z}")
            errs.setdefault(name, {})[kind] = {"affs": err_a, "s_rel": err_s,
                                               "grad_abs": max(x for _, _, x in gerrs)}
    return errs


def time_builds(builds: dict, embs, maps, gs, offs) -> list:
    import chip_smoke

    cases = [("K2f", 1, 0), ("K3f", 2, 0), ("K2b", 1, 1), ("K3b with db", 2, 2),
             ("K3b", 2, 1)]
    rows = []
    for kind, n_in, n_out in cases:
        views = embs[:n_in]
        if n_out == 0:
            fns = {name: (lambda f=f: f.fwd(views, maps, offs)) for name, f in builds.items()}
        else:
            fns = {name: (lambda f=f: f.bwd(views, maps, gs, offs, n_out))
                   for name, f in builds.items() if n_in == 1 or n_out == 2 or f.takes_null_db}
        names = list(fns)
        t = {name: {"graph_ms": [], "event_ms": []} for name in names}
        for name in names + names[::-1]:
            t[name]["graph_ms"].append(chip_smoke.graph_ms(fns[name], flush_bytes=FLUSH))
            t[name]["event_ms"].append(chip_smoke.timed_ms(fns[name], flush_bytes=FLUSH))
        bound = chip_smoke.wmse_bound(B, SIDE, C, K, n_in, n_out)[0]
        print(f"[time] {kind} B={B} {SIDE}x{SIDE} C={C} K={K} (ms, L2 flushed, median of 20, "
              f"two turns; bound {bound:.4f}): " + "; ".join(
                  f"{name} graph {[round(v, 4) for v in t[name]['graph_ms']]}, events "
                  f"{[round(v, 4) for v in t[name]['event_ms']]}" for name in names))
        rows.append({"kernel": kind, "bound_ms": bound, **t})
    return rows


def k1f_view(gen, b: int, dtype):
    """The serving path's K1f input: the (b, C, SIDE, SIDE) model output
    permuted to (b, SIDE, SIDE, C), a zero vector at ZERO_PX."""
    import torch

    e = torch.randn((b, C, SIDE, SIDE), generator=gen, device="cuda")
    e[ZERO_PX[0], :, ZERO_PX[1], ZERO_PX[2]] = 0.0
    return e.to(dtype).permute(0, 2, 3, 1)


def check_k1f(libs: dict, gen, offs) -> dict:
    import torch

    import chip_smoke
    from pixel_embedded_affinity_torch.ops import emb2aff_cuda as A

    errs = {}
    for dtype, tol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
        e = k1f_view(gen, 1, dtype)
        ref = A.affinity_2d_plain(e, offs).float()
        for name, lib in libs.items():
            got = A._affinity_2d_fwd(e, offs, lib=lib)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs().max().item()
            zeros = bool((got[ZERO_PX[0], :, ZERO_PX[1], ZERO_PX[2]] == 0).all())
            print(f"[check] {name} K1f B=1 {SIDE}x{SIDE} {str(dtype)[6:]} NCHW view: {err:.3e}, "
                  f"zeros at the zero vector: {zeros}")
            chip_smoke.check(err <= tol and zeros and got.dtype == dtype,
                             f"{name} K1f error {err}, {zeros}")
            errs.setdefault(name, {})[f"K1f {str(dtype)[6:]}"] = err
    return errs


def time_k1f(libs: dict, gen, offs) -> list:
    import torch

    import chip_smoke
    from pixel_embedded_affinity_torch.ops import emb2aff_cuda as A

    names, rows = list(libs), []
    for dtype in (torch.float32, torch.bfloat16):
        for b in K1F_BATCHES:
            e = k1f_view(gen, b, dtype)
            t = {name: {"graph_ms": [], "event_ms": []} for name in names}
            for name in names + names[::-1]:
                fn = lambda lib=libs[name]: A._affinity_2d_fwd(e, offs, lib=lib)  # noqa: E731
                t[name]["graph_ms"].append(chip_smoke.graph_ms(fn, flush_bytes=FLUSH))
                t[name]["event_ms"].append(chip_smoke.timed_ms(fn, flush_bytes=FLUSH))
            bound = chip_smoke.affinity_bound(e.shape, len(offs), e.element_size())[0]
            dt = str(dtype)[6:]
            print(f"[time] K1f B={b} {SIDE}x{SIDE} C={C} K={len(offs)} {dt} NCHW view (ms, L2 "
                  f"flushed, median of 20, two turns; bound {bound:.4f}): " + "; ".join(
                      f"{name} graph {[round(v, 4) for v in t[name]['graph_ms']]}, events "
                      f"{[round(v, 4) for v in t[name]['event_ms']]}" for name in names))
            rows.append({"kernel": "K1f", "batch": b, "dtype": dt, "bound_ms": bound, **t})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", required=True,
                    help="a directory holding another affinity_wmse2d.cu and affinity2d.cu")
    ap.add_argument("--json", help="also write every number to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("wmse_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pixel_embedded_affinity_torch import cuda_build
    from pixel_embedded_affinity_torch.ops import emb2aff_cuda, multi_offset

    forms = {"before": args.before, "package": cuda_build.CSRC}
    builds, k1f_libs, regs = {}, {}, {}
    for name, csrc in forms.items():
        path = os.path.join(csrc, "affinity_wmse2d.cu")
        so, log = build(f"wmse_{name}", path)
        so_k1f, log_k1f = build(f"affinity2d_{name}", os.path.join(csrc, "affinity2d.cu"))
        with open(path) as f:
            takes_null_db = "db == nullptr" in f.read()
        builds[name] = Build(ctypes.CDLL(so), takes_null_db)
        k1f_libs[name] = emb2aff_cuda.bind(ctypes.CDLL(so_k1f))
        regs[name] = {k: v for k, v in {**ptxas(log), **ptxas(log_k1f)}.items()
                      if "wmse" in k or "affinity2d" in k}
        for kern, what in regs[name].items():
            print(f"[ptxas] {name} {kern}: {what}")
    offs = np.ascontiguousarray(multi_offset([1, 3, 5, 9, 27], 4), dtype=np.int32)
    embs, maps, gs = inputs(torch.Generator(device="cuda").manual_seed(0))
    errs = check_builds(builds, embs, maps, gs, offs)
    rows = time_builds(builds, embs, maps, gs, offs)
    del embs, maps
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, e in check_k1f(k1f_libs, gen, offs.tolist()).items():
        errs[name].update(e)
    rows += time_k1f(k1f_libs, gen, offs.tolist())
    card = chip_smoke.card_line()
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "errors": errs, "times": rows, "ptxas": regs}, f, indent=1)
    print(json.dumps({"card": card, "errors": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
