"""The 3D tiled serving driver: one client in a closed loop.

Set-up builds the program's dense predictor once, as a server holds its
model (``infer/inference3d.py``: ``build_model``, ``build_tiled_predictor``),
with the benchmark's weights drawn from the seed, and the tiled engine
(``parallel/tiling.py``: ``TiledInference3D``) at the traffic's geometry; it
makes the traffic's distinct volumes on the card from the seed (float32 in
[0, 1] on the host, as the loader hands them over) and warms the predictor
at the tile-batch sizes the grid gives. Each request hands the next volume,
in turn, to ``TiledInference3D.run`` and ends when its (12, D, H, W) float32
affinity canvas is in host memory. The window counts the input voxels of the
requests started within ``--seconds`` over the time from the first start to
the last canvas's arrival. A traced run profiles ``trace_requests`` requests
in place of the window.

Correctness: ``check_requests`` of the requests served, drawn from the seed
by reservoir sampling as they complete, are compared with the plain
reference's canvas of the same volume, once the window has closed and the
program's model is freed: the largest absolute gap over the canvas.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from .. import flops as yardstick
from ..trace import capture
from ..reference import precision, tiled
from ..synth import em_volume


def make_volumes(ctx) -> list:
    t = ctx.cell.traffic
    synth = ctx.cell.config["synth"]
    vols = []
    for i in range(int(t["distinct_volumes"])):
        raw, _ = em_volume(tuple(t["volume_shape"]), tuple(synth["cell"]), ctx.seed, 10 + i,
                           ctx.device)
        vols.append((raw.float() / 255.0).cpu().numpy())
    return vols


def reference_canvas(ctx, weights, volume, tf32: bool) -> torch.Tensor:
    t = ctx.cell.traffic
    with precision(tf32):
        model = ctx.reference_module().build(ctx.cell.config["model"]).to(ctx.device)
        model.load_state_dict(weights)
        model.eval()
        return tiled.predict_volume(model, volume, tuple(t["crop"]), tuple(t["stride"]),
                                    tuple(t["padding"]), int(t["tile_batch"]), ctx.device)


def canvas_gap(program: np.ndarray, reference: torch.Tensor) -> float:
    """max |program - reference| over the canvas, on the reference's device."""
    gap = 0.0
    for c in range(program.shape[0]):
        p = torch.from_numpy(program[c]).to(reference.device)
        gap = max(gap, float((p - reference[c]).abs().max()))
    return gap


def run(ctx) -> dict:
    from pixel_embedded_affinity_torch.infer.inference3d import (build_tiled_predictor,
                                                                 serves_fast, serving_dtype)
    from pixel_embedded_affinity_torch.infer.inference2d import build_model
    from pixel_embedded_affinity_torch.parallel.tiling import TiledInference3D

    t = ctx.cell.traffic
    cfg = ctx.program_config()
    dev = torch.device(ctx.device)
    crop, stride, padding = tuple(t["crop"]), tuple(t["stride"]), tuple(t["padding"])
    bs = int(t["tile_batch"])
    ref_mod = ctx.reference_module()
    weights = ctx.weights(ref_mod.build(ctx.cell.config["model"]))
    model = build_model(cfg, weights, dev, dtype=serving_dtype(cfg))
    predict = build_tiled_predictor(model, fast=serves_fast(cfg))
    engine = TiledInference3D(crop_size=crop, stride=stride, padding=padding, batch_size=bs)
    ctx.note(f"model {time.perf_counter() - ctx.t_start:.2f} s")
    volumes = make_volumes(ctx)
    ctx.note(f"volumes {time.perf_counter() - ctx.t_start:.2f} s")
    padded = [n + 2 * p for n, p in zip(t["volume_shape"], padding)]
    n_tiles = len(tiled.grid(padded, crop, stride))
    gen = torch.Generator(device=dev).manual_seed(int(ctx.seed) % (2 ** 63))
    for b in sorted({bs, n_tiles % bs} - {0}):  # the batch sizes a volume's grid gives
        predict(torch.rand((b, 1) + crop, generator=gen, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    ctx.note(f"setup {setup_s:.2f} s, {n_tiles} tiles a volume")

    pick = random.Random(int(ctx.seed))
    times: list = []
    keep = int(t["check_requests"])
    sample: list = []  # (request, volume index, canvas), a uniform sample of the served
    served = 0

    def request():
        nonlocal served
        i = served % len(volumes)
        t = time.perf_counter()
        canvas = engine.run(volumes[i], predict, n_channels=12, device=dev)
        times.append(time.perf_counter() - t)
        served += 1
        if len(sample) < keep:
            sample.append((served, i, canvas))
        else:
            j = pick.randrange(served)
            if j < keep:
                sample[j] = (served, i, canvas)

    out = {"setup_s": setup_s, "end_to_end": {}, "failed": 0}
    voxels = int(np.prod(t["volume_shape"]))
    if not ctx.trace:
        while time.perf_counter() - t0 < ctx.seconds:
            request()
        wall = time.perf_counter() - t0
        out["end_to_end"]["serve_mvoxels_per_s"] = served * voxels / wall / 1e6
        ctx.note(f"window {wall:.3f} s, {served} volumes: " + " ".join(f"{x:.3f}" for x in times))
    else:
        n = int(t["trace_requests"])
        record = capture(request, n)
        record.update(tiles=n * n_tiles, peaks=yardstick.chip_peaks(
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
            tile_flops=ref_mod.forward_flops(ctx.cell.config["model"], 1, crop))
        out["record"] = record
    out["attempted"] = served
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del model, predict, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gap = 0.0
    for _, i, canvas in sample:
        ref = reference_canvas(ctx, weights, volumes[i], tf32=False)
        gap = max(gap, canvas_gap(canvas, ref))
        del ref
    out["checks"] = {"canvas_gap": gap}
    out["sample"] = sample
    out["volumes"] = volumes
    out["weights"] = weights
    return out
