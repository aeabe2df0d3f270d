#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each of which exits nonzero when it fails:
  1. device: a CUDA card must be present; print its name and power limit;
  2. build: compile every kernel source (nvcc, sm_90a) and the native
     post-processing library, all in parallel, from the sources here;
  3. kernels: each kernel against its plain PyTorch version on the card:
     K1f at the serving shapes, in float32 and bfloat16 and on a permuted
     NCHW view (and it must refuse an input that requires grad: its
     backward is not ported); K2f/K2b at the five training scales and
     K3f/K3b at full scale, on the NCHW view, with a zero vector;
  4. fixture: the port's model on the reference golden
     (tests/fixtures/resunet2d_deep.npz) with TF32 off, and the kernel's
     affinities against the golden's circular ones outside the wrap band;
  5. serving: CVPPP serving at full width (filters 16..256, emd 16,
     seeded random weights) on synthetic 530x500 leaf images padded to
     544x544, through run_inference_2d at batch 1 and batch 4, with each
     kernel's launch count read around each run; the served affinities of
     one image against the same model run in float64 on the card;
  6. training: train() on the full-width cvppp preset, B=2, 8 steps on
     synthetic 544x544 leaves, validation on 2 images and a checkpoint,
     with every kernel's launch count read around the run; the reloaded
     checkpoint's next-step loss; the unfused kernel path must refuse to
     run; the device time of one step by kernel; one step's parameter
     gradients against the same step in float64 through the plain path;
  7. one JSON line listing each kernel: launches, error, times, bound;
  8. the last line: {"ok": true, "device": {...}}.
It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, float32 outside the tensor cores
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
F32_ATOL = 1e-5
BF16_ATOL = 8e-3  # bf16 output rounding is ~2^-8 at |a| <= 1
FIXTURE_TOL = dict(atol=2e-4, rtol=1e-3)
AFF_ATOL = 1e-4  # served f32 affinities vs a float64 run, as the CPU parity tests hold them
K1_REPLACES = "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:120"
K1_SOURCE = "pixel_embedded_affinity_torch/csrc/affinity2d.cu"
WMSE_SOURCE = "pixel_embedded_affinity_torch/csrc/affinity_wmse2d.cu"
WMSE_REPLACES = {
    "K2f": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:822",
    "K2b": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:907",
    "K3f": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:1009",
    "K3b": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:1096",
}
WMSE_NAMES = {"K2f": "affinity_wmse2d_fwd", "K2b": "affinity_wmse2d_bwd",
              "K3f": "cross_affinity_wmse2d_fwd", "K3b": "cross_affinity_wmse2d_bwd"}
# K2/K3 against their plain versions: affinities at F32_ATOL; the sums S
# relative (each adds ~B*H*W f32 terms in another order); gradients
# relative to the largest one, the zero vector's pixel (whose gradient is
# the others' times 1e12, as the normalisation's VJP gives it) apart
S_RTOL = 1e-5
GRAD_RTOL = 1e-5
# the training shapes at B=2, C=16: (side, offsets) of the five scales
TRAIN_SCALES = [(544, 10), (272, 8), (136, 6), (68, 4), (34, 2)]
TRAIN_STEPS = 8
# one full-width step's parameter gradients against the plain path in
# float64, relative to each tensor's largest gradient. The plain float32
# path is itself up to ~2e-2 off at this size: float32 decides a few
# hundred ReLU signs and max-pool argmaxes otherwise than float64 (values
# within rounding of 0 or of each other), and each routes one element's
# gradient elsewhere; with float64's choices replayed, float32 is within
# 1e-4 (tools/grad_precision.py, PERF.md). So the kernel path is held to
# 0.1 overall and, tensor by tensor, to KERNEL_EXCESS times the plain
# float32 path's error + 1e-4: the kernels add no error of their own. The
# conv biases in front of train-mode BatchNorm have a true gradient of 0
# and are held apart.
F64_GRAD_RTOL = 0.1
KERNEL_EXCESS = 1.5
BIAS_BEFORE_BN = re.compile(r"(conv\.[03]|project\.0)\.bias$")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def timed_ms(fn, n: int = 20, flush_bytes: int = 0) -> float:
    """Median device time of fn() in ms, by CUDA events around each call.
    With ``flush_bytes``, a buffer that size is rewritten before each call
    so the call starts with its inputs out of L2."""
    import torch

    flush = (torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
             if flush_bytes else None)
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def k1_bound(shape, k: int, itemsize: int):
    """Least time for K1 on these inputs: each input read and each output
    written once over HBM, vs normalising every pixel once (3C flops) and
    one C-dot per offset (2C flops) at the float32 rate."""
    b, h, w, c = shape
    nbytes = b * h * w * (c + k) * itemsize
    flops = b * h * w * (3 * c + 2 * c * k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_leaves(n: int, h: int, w: int, seed: int):
    """CVPPP-like samples: ellipse leaves around the image centre, RGB in
    [0, 1], reflect-padded and ImageNet-normalised as the data pipeline
    does; labels zero-padded."""
    from pixel_embedded_affinity_torch.data.cvppp import PAD, normalize_imagenet

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    samples = []
    for i in range(n):
        label = np.zeros((h, w), np.int32)
        m = min(h, w)
        for leaf in range(1, int(rng.integers(6, 14)) + 1):
            ang, dist = rng.uniform(0, 2 * np.pi), rng.uniform(m / 12, m / 2.6)
            cy, cx = h / 2 + dist * np.sin(ang), w / 2 + dist * np.cos(ang)
            ay, ax = rng.uniform(m / 20, m / 7), rng.uniform(m / 40, m / 12)
            rot = rng.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            u = dy * np.cos(rot) + dx * np.sin(rot)
            v = -dy * np.sin(rot) + dx * np.cos(rot)
            label[(u / ay) ** 2 + (v / ax) ** 2 <= 1] = leaf
        img = rng.normal(0.1, 0.03, (h, w, 3)).astype(np.float32)
        img[label > 0] = (0.15, rng.uniform(0.4, 0.8), 0.1)
        img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(np.float32)
        img = np.pad(img, PAD + ((0, 0),), mode="reflect")
        samples.append({"image": np.ascontiguousarray(normalize_imagenet(img)),
                        "seg": np.pad(label, PAD, mode="constant"),
                        "name": f"plant{i:03d}"})
    return samples


def phase_build() -> float:
    from pixel_embedded_affinity_torch import cuda_build
    from pixel_embedded_affinity_torch.ops import emb2aff_cuda, emb2aff_wmse_cuda
    from pixel_embedded_affinity_torch.postproc import _native

    sources = [emb2aff_cuda.SOURCE, emb2aff_wmse_cuda.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        jobs = [pool.submit(cuda_build.build, src) for src in sources]
        jobs.append(pool.submit(_native.build))
        paths = [j.result() for j in jobs]
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.2f} s: {paths}")
    for so in paths[:len(sources)]:
        with open(so[:-3] + ".log") as f:
            for ln in f:
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                    print(f"[build] ptxas {os.path.basename(so)}: {ln.strip()}")
    return secs


def phase_kernels(main_embedding) -> dict:
    """K1 against its plain version on the card; returns its errors/times."""
    import torch

    from pixel_embedded_affinity_torch.ops import (
        affinity_2d_plain, fused_affinity_2d, multi_offset)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [((1, 544, 544, 16), 4), ((8, 544, 544, 16), 4),
             ((1, 530, 500, 16), 4), ((2, 96, 80, 16), 8)]
    max_err = 0.0
    for shape, neighbor in cases:
        offsets = multi_offset([1, 3, 5, 9, 27], neighbor)
        e = torch.randn(shape, generator=gen, device="cuda")
        e[0, 3, 5] = 0.0  # a zero vector must give zero affinities
        got = fused_affinity_2d(e, offsets)
        ref = affinity_2d_plain(e, offsets)
        nchw = e.permute(0, 3, 1, 2).contiguous()
        got_view = fused_affinity_2d(nchw.permute(0, 2, 3, 1), offsets)
        eb = e.to(torch.bfloat16)
        got_b = fused_affinity_2d(eb, offsets)
        ref_b = affinity_2d_plain(eb, offsets)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        err_view = (got_view - ref).abs().max().item()
        err_b = (got_b.float() - ref_b.float()).abs().max().item()
        print(f"[kernels] K1 {shape} neighbor {neighbor}: f32 {err:.3e}, "
              f"NCHW view {err_view:.3e}, bf16 {err_b:.3e}")
        check(got.shape == (shape[0], len(offsets)) + shape[1:3], "K1 shape")
        check(got_b.dtype == torch.bfloat16, "K1 bf16 output dtype")
        check(bool((got[0, :, 3, 5] == 0).all()), "K1 nonzero affinity at a zero vector")
        check(err <= F32_ATOL and err_view <= F32_ATOL, f"K1 f32 error {err}, {err_view}")
        check(err_b <= BF16_ATOL, f"K1 bf16 error {err_b}")
        max_err = max(max_err, err, err_view)

    # the serving path's own input: the full-width model's embedding, as
    # the NCHW view the server passes
    offsets = multi_offset([1, 3, 5, 9, 27], 4)
    view = main_embedding.permute(0, 2, 3, 1)
    err = (fused_affinity_2d(view, offsets)
           - affinity_2d_plain(view, offsets)).abs().max().item()
    print(f"[kernels] K1 on the main path's embedding {tuple(view.shape)}: {err:.3e}")
    check(err <= F32_ATOL, f"K1 error on the main path's embedding {err}")
    max_err = max(max_err, err)

    # times with L2 flushed before each call; "view" is the main path's
    # layout (the model's NCHW output permuted to (B, H, W, C), no copy),
    # "nhwc" a contiguous channels-last tensor
    times = {}
    flush = 64 << 20  # beyond the 50 MB L2
    for b in (1, 4, 8):
        view = torch.randn((b, 16, 544, 544), generator=gen,
                           device="cuda").permute(0, 2, 3, 1)
        nhwc = view.contiguous()
        t = {name: timed_ms(lambda: fn(x, offsets), flush_bytes=flush)
             for name, fn, x in [
                 ("view", fused_affinity_2d, view),
                 ("plain_view", affinity_2d_plain, view),
                 ("nhwc", fused_affinity_2d, nhwc),
                 ("bf16_view", fused_affinity_2d, view.to(torch.bfloat16)),
                 ("bf16_nhwc", fused_affinity_2d, nhwc.to(torch.bfloat16))]}
        t["bound_ms"], t["bound_by"] = k1_bound(view.shape, len(offsets), 4)
        t["bf16_bound_ms"] = k1_bound(view.shape, len(offsets), 2)[0]
        times[b] = t
        print(f"[kernels] K1 time B={b} 544x544 C=16 K=10 (ms, L2 flushed): "
              f"{json.dumps(t)}")
    return {"max_abs_err": max_err, "times": times}


def phase_fixture():
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d

    data = np.load(os.path.join(REPO, "tests", "fixtures", "resunet2d_deep.npz"))
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    model = ResidualUNet2DDeep(3, 2, (8, 12, 16, 24, 32), 8)
    model.load_state_dict(sd)
    model = model.cuda().eval()
    with torch.no_grad(), float32_convs():
        outs = model(torch.from_numpy(data["input"]).cuda())
    for i, o in enumerate(outs):
        ref = data[f"out/{i}"]
        got = o.cpu().numpy()
        err = float(np.abs(got - ref).max())
        check(got.shape == ref.shape and np.isfinite(got).all(), f"fixture out/{i} shape")
        check(np.allclose(got, ref, **FIXTURE_TOL), f"fixture out/{i} max error {err}")
        print(f"[fixture] out/{i} {got.shape}: max error {err:.3e}")
    offsets = data["offsets"].tolist()
    affs = fused_affinity_2d(outs[4].permute(0, 2, 3, 1), offsets).cpu().numpy()
    golden = data["affs"]
    h, w = affs.shape[-2:]
    for k, (oy, ox) in enumerate(offsets):
        inside = np.ones((h, w), bool)
        inside[:max(-oy, 0)] = False
        inside[:, :max(-ox, 0)] = False
        ok = np.allclose(affs[0, k][inside], golden[0, k][inside], **FIXTURE_TOL)
        check(ok and np.all(affs[0, k][~inside] == 0), f"fixture affs channel {k}")
    err = max(float(np.abs(affs[0, k] - golden[0, k])[
        max(-oy, 0):, max(-ox, 0):].max()) for k, (oy, ox) in enumerate(offsets))
    print(f"[fixture] K1 affinities vs the reference's circular ones, outside "
          f"the wrap band: max error {err:.3e}")


def serving_setup():
    """The cvppp config, seeded full-width weights and 4 synthetic images."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.infer import build_model

    cfg = load_config("cvppp")
    torch.manual_seed(SEED)
    sd = build_model(cfg, device="cpu").state_dict()
    samples = synthetic_leaves(4, 530, 500, SEED)
    check(samples[0]["image"].shape == (544, 544, 3), "padded image shape")
    return cfg, sd, samples


def main_path_embedding(cfg, sd, samples):
    """The full-width model's embedding of the first image, (1, 16, H, W)."""
    import torch

    from pixel_embedded_affinity_torch.infer import build_model

    model = build_model(cfg, sd, device="cuda")
    x = torch.from_numpy(samples[0]["image"][None]).cuda().permute(0, 3, 1, 2)
    with torch.no_grad():
        return model(x.contiguous())[4]


def phase_main_path(cfg, sd, samples) -> dict:
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.infer import (
        build_model, forward_affinities, run_inference_2d)
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d, multi_offset

    print(f"[main] cvppp ResidualUNet2DDeep filters {cfg.model.filters} emd "
          f"{cfg.model.emd}, {len(samples)} images 530x500 -> 544x544, convs "
          f"in float32 (TF32 off)")
    launches = {}
    for bs in (1, 4):
        # warm-up pass (cuDNN picks its algorithms at the first call of a
        # shape), so the timed pass below gives the steady-state split
        run_inference_2d(cfg, sd, samples, batch_size=bs, device="cuda")
        timing = {}
        fused_affinity_2d.launches = 0
        per, agg = run_inference_2d(cfg, sd, samples, timing=timing,
                                    batch_size=bs, device="cuda")
        launches[bs] = fused_affinity_2d.launches
        expected = -(-len(samples) // bs)
        print(f"[main] B={bs}: K1 launches {launches[bs]} (expected {expected}); "
              f"timing {json.dumps(timing)}; metrics {json.dumps(agg)}")
        parts = {k: timing[k] for k in ("setup_s", "forward_s", "decode_s", "metrics_s")}
        parts["rest_s"] = timing["total_s"] - sum(parts.values())
        per_img = {k: v / len(samples) * 1e3 for k, v in parts.items()}
        print(f"[main] B={bs} ms/img: wall {timing['total_s'] / len(samples) * 1e3:.4f} = "
              + " + ".join(f"{k[:-2]} {v:.4f}" for k, v in per_img.items()))
        check(launches[bs] == expected, f"K1 launched {launches[bs]} times at B={bs}")
        check(len(per) == len(samples), "one result per image")
        for m in per:
            check(all(np.isfinite(v) for v in m.values()), f"non-finite metric {m}")
            check(m["SBD"] > 0, f"empty segmentation {m}")

    model = build_model(cfg, sd, device="cuda")
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    x_all = torch.from_numpy(np.stack([s["image"] for s in samples])).cuda()
    x_all = x_all.permute(0, 3, 1, 2).contiguous()
    for bs in (1, 4):
        x = x_all[:bs]
        ms = timed_ms(lambda: forward_affinities(model, x, offsets), n=20)
        with torch.no_grad(), float32_convs():
            fwd_ms = timed_ms(lambda: model(x), n=20)
        with torch.no_grad():
            tf32_ms = timed_ms(tf32_convs(lambda: model(x)), n=20)
        print(f"[main] forward+affinity B={bs}: {ms / bs:.4f} ms/img "
              f"(forward alone {fwd_ms / bs:.4f} ms/img; with TF32 convs "
              f"{tf32_ms / bs:.4f}), warm median of 20, {card_line()}")
        affs = forward_affinities(model, x, offsets)
        check(affs.shape == (bs, 10, 544, 544) and bool(torch.isfinite(affs).all()),
              "main-path affinities")
        device_breakdown(lambda: forward_affinities(model, x, offsets), bs)
    served_precision(cfg, sd, model, x_all[:1], offsets)
    return launches


def tf32_convs(fn):
    """fn run with cuDNN's TF32 allowed, the PyTorch default the server
    turns off."""
    import torch

    def run():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    return run


def served_precision(cfg, sd, model, x, offsets):
    """The served affinities of one full-width image against the same
    weights run in float64 on the card; a TF32 run's gap is printed beside."""
    import torch

    from pixel_embedded_affinity_torch.infer import build_model, forward_affinities
    from pixel_embedded_affinity_torch.ops import (
        embedding_to_affinity_2d, fused_affinity_2d)

    served = forward_affinities(model, x, offsets)
    with torch.no_grad():
        emb64 = build_model(cfg, sd, device="cuda").double()(x.double())[4]
        ref = embedding_to_affinity_2d(emb64.permute(0, 2, 3, 1), offsets,
                                       padding="valid").relu()
        emb_tf32 = tf32_convs(lambda: model(x)[4])()
        tf32 = fused_affinity_2d(emb_tf32.permute(0, 2, 3, 1), offsets).relu()
    err = (served.double() - ref).abs().max().item()
    err_tf32 = (tf32.double() - ref).abs().max().item()
    print(f"[main] served affinities vs float64, full width, one image: max "
          f"error {err:.3e} (a TF32 run: {err_tf32:.3e})")
    check(err <= AFF_ATOL, f"served affinities off the float64 run by {err}")


def device_breakdown(fn, images: int, iters: int = 5, label: str | None = None,
                     unit: str = "img"):
    """Device time of fn() by kernel (torch.profiler), per image (or per
    ``unit``, ``images`` of them per call), and the device's idle share of
    the host-clock wall time of the same calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        t_us = getattr(ev, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(ev, "self_cuda_time_total", 0)
        if t_us > 0:
            rows.append((t_us / 1e3 / iters / images, ev.count // iters, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    label = label or f"B={images}"
    if busy == 0:
        print(f"[profile] {label}: the profiler recorded no device time")
        return
    per_img_wall = wall_ms / iters / images
    print(f"[profile] {label}: device busy {busy:.4f} ms/{unit} of "
          f"{per_img_wall:.4f} ms/{unit} wall (idle share "
          f"{max(0.0, 1 - busy / per_img_wall):.3f}); top kernels:")
    for ms, calls, name in rows[:12]:
        print(f"[profile]   {ms:.4f} ms/{unit}  {ms / busy:6.1%}  x{calls}  {name[:110]}")

def phase_k1_grad_guard():
    """K1 has no backward on the card: an input that requires grad raises."""
    import torch

    from pixel_embedded_affinity_torch.ops import fused_affinity_2d, multi_offset

    e = torch.randn((1, 16, 16, 16), device="cuda", requires_grad=True)
    try:
        fused_affinity_2d(e, multi_offset([1, 3], 4))
    except NotImplementedError as err:
        print(f"[kernels] K1 refuses an input that requires grad: {str(err)[:80]}...")
    else:
        raise SmokeFailure("K1 returned a result for an input that requires grad")
    with torch.no_grad():
        fused_affinity_2d(e, multi_offset([1, 3], 4))


def wmse_bound(b: int, side: int, c: int, k: int, n_in: int, n_out: int):
    """Least time for K2/K3 on these inputs. Bytes: each embedding read
    once, t/w/m read once, and the affinities (forward, n_out = 0) or the
    gradients (backward, n_out embeddings) written once. Operations:
    normalising each input vector once (3C), per offset a dot (2C) and the
    loss term (6) forward, or the dot, the cotangent (7) and two C-wide
    multiply-adds (4C) backward, and the normalisation's VJP (5C) per
    gradient; at the float32 rate."""
    px = b * side * side
    if n_out == 0:
        nbytes = 4 * px * (c * n_in + 4 * k)
        ops = px * (3 * c * n_in + k * (2 * c + 6))
    else:
        nbytes = 4 * px * (c * n_in + 3 * k + c * n_out)
        ops = px * (3 * c * n_in + k * (6 * c + 7) + 5 * c * n_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grad_err(got, ref, zero_px):
    """max |got - ref| / max |ref| over all pixels but the zero vector's,
    and the same at that pixel alone; tensors (B, H, W, C)."""
    b, y, x = zero_px
    keep = ref.new_ones(ref.shape[:3], dtype=bool)
    keep[b, y, x] = False
    d = (got - ref).abs()
    rest = (d[keep].max() / ref[keep].abs().max()).item()
    at_zero = (d[b, y, x].max() / ref[b, y, x].abs().max().clamp(min=1e-30)).item()
    return rest, at_zero, d[keep].max().item()


def phase_wmse_kernels() -> dict:
    """K2f/K2b at the five training scales and K3f/K3b at full scale
    against their plain versions, on the model's NCHW layout permuted to
    (B, H, W, C); times at full scale with L2 flushed."""
    import torch

    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.ops import emb2aff_wmse_cuda as W

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    offsets_all = multi_offset([1, 3, 5, 9, 27], 4)
    zero_px = (0, 3, 5)
    res = {name: {"max_abs_err": 0.0} for name in WMSE_NAMES}

    def inputs(side, k, views):
        es = []
        for _ in range(views):
            e = torch.randn((2, 16, side, side), generator=gen, device="cuda")
            e[zero_px[0], :, zero_px[1], zero_px[2]] = 0.0
            es.append(e.permute(0, 2, 3, 1))
        shape = (2, k, side, side)
        t = (torch.rand(shape, generator=gen, device="cuda") > 0.5).float()
        w = torch.rand(shape, generator=gen, device="cuda") * 2.0 + 0.05
        m = (torch.rand(shape, generator=gen, device="cuda") > 0.2).float()
        gs = torch.rand((k,), generator=gen, device="cuda") / (2 * side) + 1e-4
        return es, (t, w, m), gs

    cases = [("K2", side, k) for side, k in TRAIN_SCALES] + [("K3", 544, 10)]
    for kind, side, k in cases:
        offsets = offsets_all[:k]
        es, maps, gs = inputs(side, k, 1 if kind == "K2" else 2)
        req = [e.detach().clone().requires_grad_() for e in es]
        if kind == "K2":
            s, affs = W.wmse2d_fwd(es[0], *maps, offsets)
            grads = [W.wmse2d_bwd(es[0], *maps, gs, offsets)]
            s_ref, affs_ref = W.affinity_wmse_2d_plain(req[0], *maps, offsets)
        else:
            s, affs = W.cross_wmse2d_fwd(es[0], es[1], *maps, offsets)
            grads = list(W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets))
            s_ref, affs_ref = W.cross_affinity_wmse_2d_plain(req[0], req[1], *maps, offsets)
        refs = torch.autograd.grad(s_ref, req, gs)
        torch.cuda.synchronize()
        err_a = (affs - affs_ref).abs().max().item()
        err_s = ((s - s_ref).abs() / s_ref.abs()).max().item()
        gerrs = [_grad_err(g, r, zero_px) for g, r in zip(grads, refs)]
        print(f"[kernels] {kind} B=2 {side}x{side} C=16 K={k}: affs {err_a:.3e}, "
              f"S rel {err_s:.3e}, grads rel (rest, zero-vector pixel, abs) "
              + ", ".join(f"({a:.3e}, {z:.3e}, {x:.3e})" for a, z, x in gerrs))
        check(bool((affs[zero_px[0], :, zero_px[1], zero_px[2]] == 0).all()),
              f"{kind} nonzero affinity at a zero vector")
        check(err_a <= F32_ATOL, f"{kind} affinity error {err_a}")
        check(err_s <= S_RTOL, f"{kind} S relative error {err_s}")
        for a, z, _ in gerrs:
            check(a <= GRAD_RTOL and z <= GRAD_RTOL, f"{kind} gradient error {a}, {z}")
        fwd, bwd = f"{kind}f", f"{kind}b"
        res[fwd]["max_abs_err"] = max(res[fwd]["max_abs_err"], err_a)
        res[bwd]["max_abs_err"] = max(res[bwd]["max_abs_err"], *(x for _, _, x in gerrs))

        if side != 544:
            continue
        flush = 64 << 20
        n_in = len(es)
        if kind == "K2":
            t_f = timed_ms(lambda: W.wmse2d_fwd(es[0], *maps, offsets), flush_bytes=flush)
            t_b = timed_ms(lambda: W.wmse2d_bwd(es[0], *maps, gs, offsets), flush_bytes=flush)
            p_f = timed_ms(lambda: W.affinity_wmse_2d_plain(es[0], *maps, offsets),
                           flush_bytes=flush)
        else:
            t_f = timed_ms(lambda: W.cross_wmse2d_fwd(es[0], es[1], *maps, offsets),
                           flush_bytes=flush)
            t_b = timed_ms(lambda: W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets),
                           flush_bytes=flush)
            p_f = timed_ms(lambda: W.cross_affinity_wmse_2d_plain(es[0], es[1], *maps,
                                                                  offsets),
                           flush_bytes=flush)
        s_g = (W.affinity_wmse_2d_plain(*req, *maps, offsets) if kind == "K2"
               else W.cross_affinity_wmse_2d_plain(*req, *maps, offsets))[0]
        p_b = timed_ms(lambda: torch.autograd.grad(s_g, req, gs, retain_graph=True),
                       flush_bytes=flush)
        for name, t, p, n_out in [(fwd, t_f, p_f, 0), (bwd, t_b, p_b, n_in)]:
            bound, by = wmse_bound(2, 544, 16, k, n_in, n_out)
            res[name].update(ms=t, plain_ms=p, bound_ms=bound, bound_by=by)
            print(f"[kernels] {name} time B=2 544x544 C=16 K=10 (ms, L2 flushed): "
                  f"kernel {t:.4f}, plain {p:.4f}, bound {bound:.4f} ({by}), {card_line()}")
    return res


class LeafSet:
    """The smoke run's training set: synthetic leaf samples, each drawn
    flipped along x and y at random."""

    def __init__(self, samples):
        self.samples = samples

    def sample(self, rng):
        s = self.samples[int(rng.integers(len(self.samples)))]
        img, seg = s["image"], s["seg"]
        if rng.random() < 0.5:
            img, seg = img[:, ::-1], seg[:, ::-1]
        if rng.random() < 0.5:
            img, seg = img[::-1], seg[::-1]
        return {"image": np.ascontiguousarray(img), "seg": np.ascontiguousarray(seg)}


def _wmse_launchers():
    from pixel_embedded_affinity_torch.ops import emb2aff_wmse_cuda as W

    return {"K2f": W.wmse2d_fwd, "K2b": W.wmse2d_bwd,
            "K3f": W.cross_wmse2d_fwd, "K3b": W.cross_wmse2d_bwd}


def phase_train(samples) -> dict:
    """The training main path; returns each kernel's launches in it."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data.provider import collate, to_device
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d, multi_offset
    from pixel_embedded_affinity_torch.train import (
        TrainStep2D, init_state, latest_checkpoint, load_checkpoint, restore, train)

    out = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config("cvppp", {
        "train": {"display_freq": 1, "valid_freq": TRAIN_STEPS, "save_freq": 10 ** 6},
        "save_path": os.path.join(out, "models")})
    train_ds = LeafSet([{"image": s["image"], "seg": s["seg"]} for s in samples])
    valid = synthetic_leaves(2, 530, 500, SEED + 1)
    print(f"[train] cvppp ResidualUNet2DDeep filters {cfg.model.filters} emd "
          f"{cfg.model.emd}, B={cfg.train.batch_size}, 544x544, {TRAIN_STEPS} steps, "
          f"validation on {len(valid)} images, convs in float32 (TF32 off)")

    launchers = _wmse_launchers()
    timing: dict = {}
    for fn in launchers.values():
        fn.launches = 0
    fused_affinity_2d.launches = 0
    t0 = time.perf_counter()
    state, history = train(cfg, max_iters=TRAIN_STEPS, data_override=(train_ds, valid),
                           device="cuda", log_dir=os.path.join(out, "log"), timing=timing)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launchers.items()}
    launches["K1f"] = fused_affinity_2d.launches
    print(f"[train] {wall:.2f} s for {TRAIN_STEPS} steps + validation + checkpoint; "
          f"launches {json.dumps(launches)}")
    for k, per_step in [("K2f", 5), ("K2b", 5), ("K3f", 1), ("K3b", 1)]:
        check(launches[k] == per_step * TRAIN_STEPS,
              f"{k} launched {launches[k]} times in {TRAIN_STEPS} steps")
    check(launches["K1f"] == len(valid), f"K1f launched {launches['K1f']} times")
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    print(f"[train] loss per step: {losses}")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), "a non-finite loss")
    check(len(history) == 1 and all(np.isfinite(v) for v in history[0].values()),
          f"validation {history}")
    print(f"[train] validation: {json.dumps(history[0])}")
    data_ms = [1e3 * t for t in timing["data_s"][1:]]
    step_ms = [1e3 * t for t in timing["step_s"][1:]]
    print(f"[train] warm ms/step (steps 2..{TRAIN_STEPS}, median): data "
          f"{np.median(data_ms):.4f} + step {np.median(step_ms):.4f} = "
          f"{np.median(np.add(data_ms, step_ms)):.4f}; first step "
          f"{1e3 * (timing['data_s'][0] + timing['step_s'][0]):.4f}; {card_line()}")

    # the checkpoint gives the trained state's next-step loss, bit for bit
    ck = latest_checkpoint(os.path.join(cfg.save_path, cfg.name))
    check(ck is not None and ck.endswith(f"model-{TRAIN_STEPS:06d}.ckpt"), f"checkpoint {ck}")
    loaded = restore(init_state(cfg, "cuda"), load_checkpoint(ck))
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    step = TrainStep2D(offsets, ema_seed=cfg.train.random_seed)
    rng = np.random.default_rng(SEED)
    batch = step.ema_batch(to_device(collate([train_ds.sample(rng) for _ in range(2)]),
                                     "cuda"), loaded.step)

    def next_loss(model):
        model = copy.deepcopy(model).train()
        with torch.no_grad(), float32_convs():
            return step.loss(model, batch)[0].item()

    la, lb = next_loss(state.model), next_loss(loaded.model)
    print(f"[train] next-step loss: trained state {la!r}, reloaded checkpoint {lb!r}")
    check(la == lb and loaded.step == state.step == TRAIN_STEPS, "checkpoint reload differs")

    try:
        TrainStep2D(offsets, fuse_loss=False).loss(loaded.model, batch)
    except NotImplementedError as err:
        print(f"[train] fuse_loss=False refuses to run on the card: {str(err)[:90]}...")
    else:
        raise SmokeFailure("the unfused kernel path ran on the card")

    device_breakdown(lambda: step(loaded, batch), 1, iters=3,
                     label="train step B=2 544x544", unit="step")
    train_precision(state.model, batch, offsets)
    return launches


def train_precision(model, batch, offsets):
    """One step's parameter gradients through the kernels in float32, and
    through the plain path in float32, each against the plain path in
    float64, on the same batch and EMA view."""
    from pixel_embedded_affinity_torch.train import TrainStep2D

    runs = {}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    for name, use_pallas, f64 in [("kernels", True, False), ("plain", False, False),
                                  ("f64", False, True)]:
        m = copy.deepcopy(model).double() if f64 else copy.deepcopy(model)
        TrainStep2D(offsets, use_pallas=use_pallas, device_ema=False).grads(
            m, b64 if f64 else batch)
        runs[name] = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
    # the mask head is off the cvppp loss: no gradient in any run
    check(len({frozenset(r) for r in runs.values()}) == 1,
          "the runs reach different parameters")
    top = max(g.abs().max().item() for g in runs["f64"].values())
    errs, zero = [], []
    for name, g64 in runs["f64"].items():
        gk, gp = runs["kernels"][name].double(), runs["plain"][name].double()
        if BIAS_BEFORE_BN.search(name):
            zero.append((g64.abs().max().item() / top, gk.abs().max().item() / top))
            continue
        scale = g64.abs().max().item()
        errs.append((name, (gk - g64).abs().max().item() / scale,
                     (gp - g64).abs().max().item() / scale))
    print(f"[train] parameter gradients against float64, max error relative to each "
          f"tensor's largest, float32 kernels / float32 plain ({len(errs)} tensors):")
    for i in range(0, len(errs), 3):
        print("[train]   " + "  ".join(f"{n} {e:.2e}/{p:.2e}" for n, e, p in errs[i:i + 3]))
    worst = max(errs, key=lambda t: t[1])
    excess = max(errs, key=lambda t: t[1] - KERNEL_EXCESS * t[2])
    z64, z32 = max(z[0] for z in zero), max(z[1] for z in zero)
    print(f"[train] worst {worst[0]} {worst[1]:.3e} with the kernels, {worst[2]:.3e} plain "
          f"(bound {F64_GRAD_RTOL}); the kernels' largest excess over the plain path: "
          f"{excess[0]} {excess[1]:.3e} vs {excess[2]:.3e} (bound {KERNEL_EXCESS}x + 1e-4); "
          f"the {len(zero)} conv biases in front of BatchNorm (true gradient 0): largest "
          f"|grad| / {top:.3e} is {z64:.3e} in float64, {z32:.3e} in float32")
    check(worst[1] <= F64_GRAD_RTOL, f"gradient of {worst[0]} off float64 by {worst[1]}")
    for name, e, p in errs:
        check(e <= KERNEL_EXCESS * p + 1e-4, f"the kernels add error to {name}: {e} vs {p}")
    check(z64 <= 1e-9 and z32 <= 1e-4, "bias-before-BatchNorm gradient not ~0")


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # 2. build
    phase_build()
    cfg, sd, samples = serving_setup()
    # 3. kernels vs plain, 4. fixture, 5. serving, 6. training
    k1 = phase_kernels(main_path_embedding(cfg, sd, samples))
    phase_k1_grad_guard()
    wmse = phase_wmse_kernels()
    phase_fixture()
    launches = phase_main_path(cfg, sd, samples)
    train_launches = phase_train(samples)
    # 7. kernels line, card, 8. last line
    t1 = k1["times"][1]
    kernels = [{
        "name": "affinity2d_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": sum(launches.values()) + train_launches["K1f"],
        "max_abs_err": k1["max_abs_err"], "ms": t1["view"],
        "plain_ms": t1["plain_view"], "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"], "library_ms": None}]
    for k, name in WMSE_NAMES.items():
        r = wmse[k]
        kernels.append({
            "name": name, "route": "cuda", "source": WMSE_SOURCE,
            "replaces": WMSE_REPLACES[k], "launches": train_launches[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
