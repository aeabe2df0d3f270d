#!/usr/bin/env python3
"""CWg and CXg (the 2D float32 conv backward) beside another build of them, on one card.

    python3 tools/conv_grad_ab.py --before DIR [DIR ...] [--json PATH]   # one CUDA card

Builds ``csrc/conv_grad.cu`` as the package ships it ("package") and the
``conv_grad.cu`` in each DIR (named by DIR; e.g. an earlier commit's
``pixel_embedded_affinity_torch/csrc`` unpacked by ``git archive``: ``git
archive <commit> pixel_embedded_affinity_torch/csrc | tar -x -C
build/before``), each with the package's nvcc flags into ``build/tools/``.
Every build is called through ctypes by its own C interface (an earlier
``conv_dgrad`` takes no workspace, its ``conv_wgrad`` the partial tiles
only). Records the convs that CWg and CXg
serve in one full-width float32 training step of each of
``chip_smoke.CG_PRESETS`` (``chip_smoke.recorded_convs``: the step's own
inputs and output gradients, as phase 27 takes them), holds every build's
weight and input gradients at every conv within ``GRAD_RTOL`` of the
float64 plain version and equal to the bit over two runs, then times each
conv shape with every build by CUDA graph replay (median of 20, L2
flushed) in turns: the builds in order, then reversed, the lesser of a
build's two readings kept; cuDNN's default backward (TF32 off) is timed
once a shape beside them. Prints each kernel's registers and spills, its
tensor-core and TMA instructions in the SASS (``cuobjdump``), each shape's
times beside its bound, each preset's sums (each conv counted, a shape's
time for every conv of that shape), and the card's name and power limit;
``--json PATH`` writes every number to PATH. Exits 1 where a build is off
the float64 version or differs from run to run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as smoke  # noqa: E402  (the repo's root, for its inputs and timers)
from conv_i8_ab import build, ptxas_lines, sass_counts  # noqa: E402

FLUSH = 2 * 50 * 2 ** 20  # phase 27's flush


class Lib:
    """One build of ``conv_grad.cu`` with the package's C interface
    (``ops/conv_grad_cuda.load`` declares it), whatever its own: an earlier
    build has no workspace functions, its ``conv_wgrad`` takes the splits'
    partial tiles only and its ``conv_dgrad`` no workspace.
    ``ops/conv_grad_cuda.py``'s wrappers can run on it
    (``use_library``; ``tools/step_determinism.py --before``)."""

    def __init__(self, so: str):
        from pixel_embedded_affinity_torch.ops import conv_grad_cuda as cg

        lib = self.lib = cg.load(so)
        self.conv_wgrad_splits, self.conv_wgrad = lib.conv_wgrad_splits, lib.conv_wgrad
        self._earlier = not hasattr(lib, "conv_dgrad_workspace")
        if self._earlier:
            args = lib.conv_dgrad.argtypes
            lib.conv_dgrad.argtypes = args[:3] + args[4:]

    def conv_wgrad_workspace(self, b, cin, cout, h, w, k, splits):
        if self._earlier:
            return splits * cout * cin * k * k
        return self.lib.conv_wgrad_workspace(b, cin, cout, h, w, k, splits)

    def conv_dgrad_workspace(self, *shape):
        return 0 if self._earlier else self.lib.conv_dgrad_workspace(*shape)

    def conv_dgrad(self, dy, w, dx, work, *rest):
        if self._earlier:
            return self.lib.conv_dgrad(dy, w, dx, *rest)
        return self.lib.conv_dgrad(dy, w, dx, work, *rest)


class Build(Lib):
    """One build's CWg and CXg on tensors, with buffers made once a shape."""

    def wgrad_fn(self, x, dy, wshape):
        """A call of CWg on fixed buffers, and its split count."""
        import torch

        cout, cin, k, _ = wshape
        b, _, h, w = x.shape
        splits = self.conv_wgrad_splits(b, cin, cout, h, w, k)
        out = torch.empty(tuple(wshape), device="cuda")
        work = torch.empty(self.conv_wgrad_workspace(b, cin, cout, h, w, k, splits),
                           device="cuda")

        def call():
            err = self.conv_wgrad(x.data_ptr(), dy.data_ptr(), out.data_ptr(), work.data_ptr(),
                                  b, cin, cout, h, w, k, splits,
                                  torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"conv_wgrad: cudaError {err}")
            return out

        return call, splits

    def dgrad_fn(self, dy, wt):
        """A call of CXg on fixed buffers."""
        import torch

        cout, cin, k, _ = wt.shape
        b, _, h, w = dy.shape
        out = torch.empty((b, cin, h, w), device="cuda")
        work = torch.empty(max(self.conv_dgrad_workspace(b, cin, cout, h, w, k), 1),
                           device="cuda")

        def call():
            err = self.conv_dgrad(dy.data_ptr(), wt.data_ptr(), out.data_ptr(), work.data_ptr(),
                                  b, cin, cout, h, w, k, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"conv_dgrad: cudaError {err}")
            return out

        return call


def cudnn_fns(x, dy, wt):
    """cuDNN's default weight and input gradients (TF32 off by the caller)."""
    import torch

    k = wt.shape[-1]

    def bwd(mask):
        return torch.ops.aten.convolution_backward(
            dy, x, wt, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], 1, mask)

    return (lambda: bwd([False, True, False])[1]), (lambda: bwd([True, False, False])[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", required=True, nargs="+",
                    help="directories holding other conv_grad.cu builds")
    ap.add_argument("--presets", nargs="+", default=list(smoke.CG_PRESETS))
    ap.add_argument("--json", help="write every number to this path")
    args = ap.parse_args(argv)
    import torch

    from pixel_embedded_affinity_torch import cuda_build
    from pixel_embedded_affinity_torch.data.device_data import pack_cvppp_arrays
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops import conv_grad_cuda as cg

    if not torch.cuda.is_available():
        print("conv_grad_ab: no CUDA card", file=sys.stderr)
        return 1
    card = smoke.card_line()
    builds, report = {}, {"card": card, "sass": {}, "ptxas": {}}
    sources = {os.path.relpath(os.path.abspath(d), REPO).replace(os.sep, "_"): d
               for d in args.before}
    sources["package"] = cuda_build.CSRC
    for name, d in sources.items():
        so, log = build(name, os.path.join(d, cg.SOURCE), stem="conv_grad")
        builds[name] = Build(so)
        report["ptxas"][name] = ptxas_lines(log)
        report["sass"][name] = sass_counts(so)
        for k, v in report["ptxas"][name].items():
            print(f"[ab] {name} ptxas {k}: {v}")
        for k, v in report["sass"][name].items():
            print(f"[ab] {name} sass {k}: {json.dumps(v)}")
    cvppp = pack_cvppp_arrays(smoke.leaf_pairs(4, 530, 500, smoke.SEED))
    data = {"cvppp": cvppp, "cvppp_resnet50": cvppp, "cvppp_resnet101": cvppp}
    if "bbbc039v1" in args.presets:
        data["bbbc039v1"] = smoke.bbbc_setup()[0]
    order = list(builds) + list(builds)[::-1]
    times: dict = {}  # a conv shape's times, taken at its first conv
    bad, rows, sums = [], [], {}
    with float32_convs():
        for preset in args.presets:
            convs, _ = smoke.recorded_convs(preset, data[preset])
            tot = {f"{n}_{g}": 0.0 for n in builds for g in ("w", "x")}
            tot.update({"w_bound": 0.0, "x_bound": 0.0, "w_cudnn": 0.0, "x_cudnn": 0.0})
            err = {n: {"w": 0.0, "x": 0.0} for n in builds}
            for name, conv, x, dy, need_x in convs:
                wt = conv.weight.detach().contiguous()
                x, dy = cg._aligned(x), cg._aligned(dy)  # as the wrapper hands them over
                b, cin, h, w = x.shape
                cout, k = wt.shape[0], wt.shape[-1]
                ref_w = cg.conv_wgrad_plain(x.double(), dy.double(), wt.shape)
                ref_x = cg.conv_dgrad_plain(dy.double(), wt.double()) if need_x else None
                fns, conv_err = {}, {}
                for bn, bld in builds.items():
                    wf, splits = bld.wgrad_fn(x, dy, wt.shape)
                    xf = bld.dgrad_fn(dy, wt) if need_x else None
                    fns[bn] = (wf, xf, splits)
                    outs = [wf().clone() for _ in range(2)]
                    e = conv_err[f"{bn}_w_err"] = smoke.rel_err64(outs[0], ref_w)
                    err[bn]["w"] = max(err[bn]["w"], e)
                    if not torch.equal(*outs) or e > smoke.GRAD_RTOL:
                        bad.append(f"{bn} CWg {preset} {name}: {e:.3e}")
                    if need_x:
                        outs = [xf().clone() for _ in range(2)]
                        e = conv_err[f"{bn}_x_err"] = smoke.rel_err64(outs[0], ref_x)
                        err[bn]["x"] = max(err[bn]["x"], e)
                        if not torch.equal(*outs) or e > smoke.GRAD_RTOL:
                            bad.append(f"{bn} CXg {preset} {name}: {e:.3e}")
                torch.cuda.synchronize()
                shape = (tuple(x.shape), tuple(wt.shape), need_x)
                if shape not in times:
                    t = {f"{n}_{g}": [] for n in builds for g in ("w", "x")}
                    for bn in order:
                        wf, xf, _ = fns[bn]
                        t[f"{bn}_w"].append(smoke.graph_ms(wf, flush_bytes=FLUSH))
                        if need_x:
                            t[f"{bn}_x"].append(smoke.graph_ms(xf, flush_bytes=FLUSH))
                    lib_w, lib_x = cudnn_fns(x, dy, wt)
                    bound = smoke.conv_grad_bound(b, cin, cout, h, w, k)
                    times[shape] = {
                        **{key: min(v) if v else 0.0 for key, v in t.items()},
                        "readings": t, "bound_ms": bound[0], "bound_by": bound[1],
                        "w_cudnn": smoke.graph_ms(lib_w, flush_bytes=FLUSH),
                        "x_cudnn": smoke.graph_ms(lib_x, flush_bytes=FLUSH) if need_x else 0.0,
                        "splits": {bn: f[2] for bn, f in fns.items()}}
                    r = times[shape]
                    print(f"[ab] {tuple(x.shape)} {cout}x{cin}x{k}x{k}: CWg "
                          + ", ".join(f"{n} {r[f'{n}_w']:.4f}" for n in builds)
                          + f", cuDNN {r['w_cudnn']:.4f}; CXg "
                          + (", ".join(f"{n} {r[f'{n}_x']:.4f}" for n in builds)
                             + f", cuDNN {r['x_cudnn']:.4f}" if need_x else "none")
                          + f" ms; bound {r['bound_ms']:.4f} ({r['bound_by']}); splits "
                          + json.dumps(r["splits"]))
                r = times[shape]
                for key in tot:
                    if key.endswith("_bound"):
                        tot[key] += r["bound_ms"] if key[0] == "w" or need_x else 0.0
                    else:
                        tot[key] += r[key]
                rows.append({"preset": preset, "conv": name, "x": list(x.shape),
                             "weight": list(wt.shape), "need_x": need_x, **conv_err,
                             **{key: v for key, v in r.items() if key != "readings"}})
            del convs
            torch.cuda.empty_cache()
            tot["errors"] = err
            sums[preset] = tot
            share = {key: tot["w_bound" if key.endswith("_w") else "x_bound"] / tot[key]
                     for key in tot if key.endswith(("_w", "_x")) and tot[key]}
            print(f"[ab] {preset} step, ms summed over its convs (graph replay, L2 flushed): "
                  f"{json.dumps({k: v for k, v in tot.items() if k != 'errors'})}; share of the "
                  f"bound {json.dumps(share)}; errors {json.dumps(err)}; {card}")
    print(f"[ab] every conv of {args.presets} held to float64 within {smoke.GRAD_RTOL} and "
          "repeated: " + ("all builds pass" if not bad else "FAIL: " + "; ".join(bad)))
    report.update(rows=rows, sums=sums)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
