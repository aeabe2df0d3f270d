#!/usr/bin/env python3
"""The int8 serving kernels (I8c, I8q) beside another build of them, on one card.

    python3 tools/conv_i8_ab.py --before DIR [DIR ...] [--json PATH]   # one CUDA card

Builds ``csrc/conv_i8.cu`` as the package ships it ("package") and the
``conv_i8.cu`` in each DIR (named by DIR; e.g. an earlier commit's
``pixel_embedded_affinity_torch/csrc`` unpacked by ``git archive``, or a
trial copy of the package's, whose headers it includes), each with the
package's nvcc flags into ``build/tools/``. Both have one C interface, ``conv_i8_fwd`` and
``quantize_i8``, called through ctypes as the package's wrapper calls
them. Records every ``conv_i8`` and ``quantize_act`` call of one B=1
float32 int8 fast forward of the full-width cvppp model (``chip_smoke.py``
phase 25's inputs: 23 and 18 calls), holds every build's int32
accumulators, float32 outputs and int8 codes equal to the plain versions
at each call, then times each call with every build by CUDA graph replay
(median of 20, L2 flushed) in turns: the builds in order, then reversed.
Each call is also timed with L2 flushed by reading a buffer (I8c: the
sums): ``graph_ms``'s flush, as in every kernel row of ``chip_smoke.py``,
writes a buffer and leaves L2 full of dirty lines that the call's misses
must write back; a read leaves it clean.
Prints each kernel's registers and spills, its tensor-core and TMA
instructions in the SASS (``cuobjdump``), each call's pair of times beside
its bound, the sums, and the card's name and power limit; ``--json PATH``
writes every number to PATH. Exits 1 where a build disagrees with the
plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402  (the repo's root, for its inputs and timers)

FLUSH = 64 << 20  # beyond the 50 MB L2


def build(name: str, source: str, stem: str = "conv_i8") -> tuple[str, str]:
    """nvcc ``source`` (its own directory on the include path) -> (library,
    ptxas log) under build/tools/ as lib<stem>_<name>.so."""
    from pixel_embedded_affinity_torch import cuda_build

    out = os.path.join(REPO, "build", "tools")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"lib{stem}_{name}.so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
           os.path.dirname(os.path.abspath(source)), "-o", so, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return so, proc.stdout + proc.stderr


def sass_counts(so: str) -> dict:
    """{kernel: {opcode: count}} of the tensor-core and bulk-copy opcodes
    in ``cuobjdump -sass``."""
    from pixel_embedded_affinity_torch import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(cuda_build._nvcc()),
                                                     "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=300)
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.search(r"\b(IGMMA|HGMMA|IMMA|HMMA|UTMALDG|UBLKCP|LDGSTS|SYNCS)\S*", ln)
        if fn and m:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    return counts


def ptxas_lines(log: str) -> dict:
    info, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        elif entry and ("spill" in ln or "Used" in ln):
            info[entry] = (info.get(entry, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return info


class Build:
    """One build's two entry points on tensors."""

    def __init__(self, so: str):
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        self.conv, self.quant = lib.conv_i8_fwd, lib.quantize_i8
        self.conv.restype = self.quant.restype = i
        self.conv.argtypes = [p] * 5 + [i] * 11 + [p]
        self.quant.argtypes = [p, p, i, ctypes.c_float, ctypes.c_int64, p]

    def conv_call(self, x, w, scale, shift, pad, out):
        import torch

        b, h, wd, cin = x.shape
        err = self.conv(x.data_ptr(), w.packed.data_ptr(),
                        None if scale is None else scale.data_ptr(),
                        None if shift is None else shift.data_ptr(), out.data_ptr(), b, h, wd,
                        cin, w.cout, w.kh, w.kw, *pad, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"conv_i8_fwd: cudaError {err}")
        return out

    def quant_call(self, x, inv, out):
        import torch

        err = self.quant(x.data_ptr(), out.data_ptr(), 0 if x.dtype == torch.float32 else 1, inv,
                         x.numel(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"quantize_i8: cudaError {err}")
        return out


def record_calls():
    """The conv_i8 and quantize_act calls of one B=1 float32 int8 fast
    forward of the full-width cvppp model, as phase 25 makes them."""
    import numpy as np
    import torch

    from pixel_embedded_affinity_torch.infer import build_model
    from pixel_embedded_affinity_torch.models import (INT8_DEFAULT_SITES,
                                                      build_fast_resunet_forward,
                                                      calibrate_int8_ranges, pack_image_s2d)
    from pixel_embedded_affinity_torch.ops import conv_i8_cuda as c8

    cfg, sd, samples = smoke.serving_setup()
    sd = smoke.bn_stats_sd(sd, smoke.SEED + 25)
    packed = torch.from_numpy(pack_image_s2d(np.stack([s["image"] for s in samples]))).cuda()
    model = build_model(cfg, sd, device="cuda")
    kw = dict(dtype=model.compute_dtype, input_format="s2d")
    ranges = calibrate_int8_ranges(model, [packed], **kw)
    fwd = build_fast_resunet_forward(model, head_at_fullres=True, int8_sites=INT8_DEFAULT_SITES,
                                     act_ranges=ranges, **kw)
    rec = smoke._Recorder()  # the plain versions make the recorded calls' inputs
    rec.real = (lambda x_q, w, out_scale, shift=None, padding=(1, 1, 1, 1):
                c8.conv_i8_plain(x_q, w, out_scale, shift, padding), c8.quantize_act_plain)
    with rec, torch.no_grad():
        fwd(packed[:1])
    torch.cuda.synchronize()
    return rec.convs, rec.quants


def read_flushed_ms(fn, buf, n: int = 20) -> float:
    """graph_ms with L2 flushed by reading ``buf`` (beyond L2) before each
    replay: the call starts with a clean L2, nothing to write back."""
    import numpy as np
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(n + 3):
        buf.sum()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[3:]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", required=True, nargs="+",
                    help="directories holding other conv_i8.cu builds")
    ap.add_argument("--json", help="write every number to this path")
    args = ap.parse_args(argv)
    import torch

    from pixel_embedded_affinity_torch import cuda_build
    from pixel_embedded_affinity_torch.ops import conv_i8_cuda as c8

    if not torch.cuda.is_available():
        print("conv_i8_ab: no CUDA card", file=sys.stderr)
        return 1
    card = smoke.card_line()
    builds, report = {}, {"card": card, "sass": {}, "ptxas": {}}
    sources = {os.path.relpath(os.path.abspath(d), REPO).replace(os.sep, "_"): d
               for d in args.before}
    sources["package"] = cuda_build.CSRC
    for name, d in sources.items():
        src = os.path.join(d, c8.SOURCE)
        so, log = build(name, src)
        builds[name] = Build(so)
        report["ptxas"][name] = ptxas_lines(log)
        report["sass"][name] = sass_counts(so)
        for k, v in report["ptxas"][name].items():
            print(f"[ab] {name} ptxas {k}: {v}")
        for k, v in report["sass"][name].items():
            print(f"[ab] {name} sass {k}: {json.dumps(v)}")
    convs, quants = record_calls()
    bad = []
    for x, w, sc, sh, pad, _ in convs:
        acc_ref = c8.conv_i8_acc_plain(x, w, pad)
        ref = c8.conv_i8_plain(x, w, sc, sh, pad)
        for name, bld in builds.items():
            acc = bld.conv_call(x, w, None, None, pad, torch.empty_like(acc_ref))
            out = bld.conv_call(x, w, sc, sh, pad, torch.empty_like(ref))
            torch.cuda.synchronize()
            if not (torch.equal(acc, acc_ref) and torch.equal(out, ref)):
                bad.append(f"{name} I8c {tuple(x.shape)} -> {w.cout} {pad}")
    for x, scale, _ in quants:
        ref = c8.quantize_act_plain(x, scale)
        for name, bld in builds.items():
            got = bld.quant_call(x.contiguous(), c8._inv(scale), torch.empty_like(ref))
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad.append(f"{name} I8q {tuple(x.shape)} {x.dtype}")
    print(f"[ab] {len(convs)} I8c and {len(quants)} I8q calls held to the plain versions: "
          + ("all equal to the bit" if not bad else "DIFFER: " + "; ".join(bad)))
    if bad:
        return 1
    order = list(builds) + list(builds)[::-1]
    rows, sums = [], {**{f"{n}{f}": 0.0 for n in builds for f in ("", "_read_flush")},
                      "bound": 0.0}
    clean = torch.empty(FLUSH // 4, dtype=torch.float32, device="cuda")
    for x, w, sc, sh, pad, y in convs:
        out = torch.empty_like(y)
        t = {n: [] for n in builds}
        for name in order:
            fn = lambda b=builds[name]: b.conv_call(x, w, sc, sh, pad, out)  # noqa: E731
            t[name].append(smoke.graph_ms(fn, flush_bytes=FLUSH))
            sums[f"{name}_read_flush"] += read_flushed_ms(fn, clean) / 2
        t_bytes, t_ops = smoke.i8c_bound(x, w, pad)
        plan = c8.conv_plan(x.shape, w, pad)
        row = {"shape": list(x.shape), "taps": [w.kh, w.kw], "cout": w.cout, "padding": list(pad),
               **{f"{n}_ms": min(v) for n, v in t.items()},
               "readings": t, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "plan": plan}
        rows.append(row)
        for n in builds:
            sums[n] += row[f"{n}_ms"]
        sums["bound"] += row["bound_ms"]
        print(f"[ab] I8c {tuple(x.shape)} {w.kh}x{w.kw} -> {w.cout} pad {pad}: "
              + ", ".join(f"{n} {row[f'{n}_ms']:.4f}" for n in builds)
              + f" ms, bound {row['bound_ms']:.4f} ({row['bound_by']}); plan {json.dumps(plan)}")
    qsums = {**{f"{n}{f}": 0.0 for n in builds for f in ("", "_read_flush")}, "bound": 0.0}
    for x, scale, q in quants:
        xc, out, inv = x.contiguous(), torch.empty_like(q), c8._inv(scale)
        for name in order:
            b = builds[name]
            qsums[name] += smoke.graph_ms(lambda: b.quant_call(xc, inv, out),
                                          flush_bytes=FLUSH) / 2
            qsums[f"{name}_read_flush"] += read_flushed_ms(lambda: b.quant_call(xc, inv, out),
                                                           clean) / 2
        qsums["bound"] += xc.numel() * (xc.element_size() + 1) / smoke.HBM_BYTES_PER_S * 1e3
    first = next(iter(builds))
    slower = [r for r in rows if r["package_ms"] > r[f"{first}_ms"]]
    print(f"[ab] one B=1 float32 int8 forward, ms by CUDA graph replay, L2 flushed, the lesser "
          f"of two readings a build: I8c's {len(rows)} calls {json.dumps(sums)}; I8q's "
          f"{len(quants)} calls (the mean of two readings a build) {json.dumps(qsums)}; I8c "
          f"calls slower in the package than in {first}: {len(slower)}; {card}")
    report.update(rows=rows, i8c=sums, i8q=qsums)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
