#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each of which exits nonzero when it fails:
  1. device: a CUDA card must be present; print its name and power limit;
  2. build: compile every kernel of the serving path (nvcc, sm_90a) and the
     native post-processing library, in parallel, from the sources here;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the serving shapes, in float32 and bfloat16 and on a permuted NCHW view;
  4. fixture: the port's model on the reference golden
     (tests/fixtures/resunet2d_deep.npz) with TF32 off, and the kernel's
     affinities against the golden's circular ones outside the wrap band;
  5. main path: CVPPP serving at full width (filters 16..256, emd 16,
     seeded random weights) on synthetic 530x500 leaf images padded to
     544x544, through run_inference_2d at batch 1 and batch 4, with each
     kernel's launch count read around each run; the served affinities of
     one image against the same model run in float64 on the card;
  6. one JSON line listing each kernel: launches, error, times, bound;
  7. the last line: {"ok": true, "device": {...}}.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
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
    from pixel_embedded_affinity_torch.ops import emb2aff_cuda
    from pixel_embedded_affinity_torch.postproc import _native

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        jobs = [pool.submit(cuda_build.build, emb2aff_cuda.SOURCE),
                pool.submit(_native.build)]
        paths = [j.result() for j in jobs]
    secs = time.perf_counter() - t0
    with open(paths[0][:-3] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"[build] {secs:.2f} s: {paths}")
    for ln in ptxas:
        print(f"[build] ptxas: {ln}")
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


def device_breakdown(fn, images: int, iters: int = 5):
    """Device time of fn() by kernel (torch.profiler), per image, and the
    device's idle share of the host-clock wall time of the same calls."""
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
    if busy == 0:
        print(f"[profile] B={images}: the profiler recorded no device time")
        return
    per_img_wall = wall_ms / iters / images
    print(f"[profile] B={images}: device busy {busy:.4f} ms/img of "
          f"{per_img_wall:.4f} ms/img wall (idle share "
          f"{max(0.0, 1 - busy / per_img_wall):.3f}); top kernels:")
    for ms, calls, name in rows[:10]:
        print(f"[profile]   {ms:.4f} ms/img  {ms / busy:6.1%}  x{calls}  {name[:110]}")


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
    # 3. kernels vs plain, 4. fixture, 5. main path
    k1 = phase_kernels(main_path_embedding(cfg, sd, samples))
    phase_fixture()
    launches = phase_main_path(cfg, sd, samples)
    # 6. kernels line, card, 7. last line
    t1 = k1["times"][1]
    print(json.dumps({"kernels": [{
        "name": "affinity2d_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": sum(launches.values()),
        "max_abs_err": k1["max_abs_err"], "ms": t1["view"],
        "plain_ms": t1["plain_view"], "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"], "library_ms": None}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
