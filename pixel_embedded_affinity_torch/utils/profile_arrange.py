"""Which arrangement of the served embedding costs least to hand to a
kernel after the forward: the port of ``docs/profile_b1_arrange.py``.

    python -m pixel_embedded_affinity_torch.utils.profile_arrange [B] [--device cpu]

The full-width ``ResidualUNet2DDeep`` (filters 16..256, emd 16) with seeded
random weights runs through the folded-BatchNorm fast forward in bfloat16
with the s2d input at 544x544, and four variants are timed: the forward
alone; the forward and a copy by the tile-copy kernel (P,
:func:`..ops.tile_copy_cuda.tile_copy`, 32-row tiles) of its NHWC
embedding tiled on H; of the embedding permuted to NCHW, tiled on H; and
of the embedding as (B, H, C, W), tiled on H. Each prints the median of 30
timed iterations after a warm-up, by CUDA events on a card (the host clock
on the CPU, where the copy is its plain version), in ms. The variants are
timed in turns, one call of each a round, so that a drift of the card's
clocks or of the host's load over the run falls on all four alike.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import ResidualUNet2DDeep, build_fast_resunet_forward, pack_image_s2d
from ..ops.tile_copy_cuda import tile_copy

FILTERS = (16, 32, 64, 128, 256)
SIDE = 544
SEED = 0


def variants(fwd) -> dict:
    """name -> fn(x) of the four variants over the forward ``fwd``."""
    def emb(x):
        return fwd(x)[0]

    return {
        "forward only": emb,
        "copy of emb NHWC": lambda x: tile_copy(emb(x), 1),
        "copy of emb NCHW": lambda x: tile_copy(emb(x).permute(0, 3, 1, 2).contiguous(), 2),
        "copy of (B,H,C,W)": lambda x: tile_copy(emb(x).permute(0, 1, 3, 2).contiguous(), 1),
    }


def _call_ms(fn, x) -> float:
    """One call of fn(x), in ms: CUDA events on a card, the host clock on
    the CPU."""
    if x.device.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)
    t0 = time.perf_counter()
    fn(x)
    return 1e3 * (time.perf_counter() - t0)


def run(batch: int = 1, device=None, filters=FILTERS, side: int = SIDE, iters: int = 30,
        warmup: int = 3) -> dict:
    """{variant: median ms} at batch ``batch``; the weights and the image
    drawn from ``SEED``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = ResidualUNet2DDeep(3, 2, tuple(filters), 16)
    model = model.to(dev).eval()
    fwd = build_fast_resunet_forward(model, dtype=torch.bfloat16, input_format="s2d")
    img = np.random.default_rng(SEED).normal(size=(batch, side, side, 3)).astype(np.float32)
    x = torch.from_numpy(pack_image_s2d(img)).to(dev).to(torch.bfloat16)
    fns = variants(fwd)
    times: dict = {name: [] for name in fns}
    with torch.no_grad():
        for name, fn in fns.items():
            for _ in range(warmup):
                fn(x)
        for _ in range(iters):
            for name, fn in fns.items():
                times[name].append(_call_ms(fn, x))
    return {name: float(np.median(t)) for name, t in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"
    print(f"arrangement probe: ResidualUNet2DDeep {FILTERS} emd 16, fast forward bfloat16 "
          f"s2d input, B={args.batch} {SIDE}x{SIDE}, median of 30, {where}")
    for name, ms in run(args.batch, dev).items():
        print(f"{name:24s} {ms:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
