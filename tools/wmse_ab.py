#!/usr/bin/env python3
"""The loss-fused WMSE kernels beside another build of them, on one card.

    python3 tools/wmse_ab.py --before DIR [--json PATH]   # one CUDA card

Builds ``csrc/affinity_wmse2d.cu`` as the package ships it ("package") and
the ``affinity_wmse2d.cu`` in DIR ("before"; e.g. an earlier commit's
``pixel_embedded_affinity_torch/csrc`` unpacked by ``git archive``), each
with the package's nvcc flags into ``build/tools/``. Both have one C
interface (``wmse2d_fwd``, ``cross_wmse2d_fwd``, ``wmse2d_bwd``,
``cross_wmse2d_bwd``), launched by the package's own launch code in
``ops/emb2aff_wmse_cuda.py``. At the CVPPP step's full scale, B=2 544x544, C=16, K=10, on the
model's NCHW output permuted to (B, H, W, C) with a zero vector, holds
both builds against the plain PyTorch versions (affinities within 1e-5,
the sums S relative 1e-5, gradients within 1e-5 of the largest and at the
zero vector's pixel of its own), then times K2f, K3f, K2b, K3b with db
and, in a build whose cross entry takes a null db (the package's), K3b
without db, the training steps' call. Each time is a median of 20 with L2
flushed, by CUDA graph replay and by CUDA events around the eager call,
in turns (the builds in order, then reversed). Prints each
kernel's registers and spills and the card's name and power limit;
``--json PATH`` also writes every number to PATH.
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
F32_ATOL, S_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-5
B, SIDE, C, K = 2, 544, 16, 10
ZERO_PX = (0, 3, 5)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", required=True,
                    help="a directory holding another affinity_wmse2d.cu")
    ap.add_argument("--json", help="also write every number to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("wmse_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from pixel_embedded_affinity_torch import cuda_build
    from pixel_embedded_affinity_torch.ops import multi_offset

    forms = {"before": os.path.join(args.before, "affinity_wmse2d.cu"),
             "package": os.path.join(cuda_build.CSRC, "affinity_wmse2d.cu")}
    builds, regs = {}, {}
    for name, path in forms.items():
        so, log = build(f"wmse_{name}", path)
        with open(path) as f:
            takes_null_db = "db == nullptr" in f.read()
        builds[name] = Build(ctypes.CDLL(so), takes_null_db)
        regs[name] = {k: v for k, v in ptxas(log).items() if "wmse" in k}
        for kern, what in regs[name].items():
            print(f"[ptxas] {name} {kern}: {what}")
    offs = np.ascontiguousarray(multi_offset([1, 3, 5, 9, 27], 4), dtype=np.int32)
    embs, maps, gs = inputs(torch.Generator(device="cuda").manual_seed(0))
    errs = check_builds(builds, embs, maps, gs, offs)
    rows = time_builds(builds, embs, maps, gs, offs)
    card = chip_smoke.card_line()
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "errors": errs, "times": rows, "ptxas": regs}, f, indent=1)
    print(json.dumps({"card": card, "errors": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
