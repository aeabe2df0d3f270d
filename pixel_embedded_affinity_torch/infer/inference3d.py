"""3D serving (AC3/AC4): tiled forward and three decoders.

The volume goes through the tiled engine (:mod:`..parallel.tiling`): each
batch of tiles runs the predictor, the fused 3D affinity kernel
(:func:`..ops.fused_affinity_3d`) and a ReLU on the device. The predictor
follows the JAX package's rule: with ``model.fast_tiled_infer`` and the
``unet_pni_deep`` arch, the folded-BatchNorm z-concat graph
(:func:`..models.fast_forward3d.build_fast_pni_forward`), else the dense
module; either computes in :func:`serving_dtype` (float32 in full, TF32
off, or bfloat16 with ``model.bf16_tiled_infer`` or a bfloat16
``model.dtype``) and hands K5f its embedding cast to float32. The port's
default is the dense module: on the H100 it is the faster of the two
(PERF.md). The engine's per-batch loop (``run``) stitches the
Gaussian-blended (12, D, H, W) float32 canvas on the device and fetches it
once. The host then decodes it with mutex watershed (the 12-offset table,
strides [1, 10, 10]), waterz-style mean-affinity agglomeration at 0.5 on
the first 3 channels, and multicut (lmc), and scores VOI/ARAND per decoder.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config, resolve_compute_dtype
from ..device import float32_convs, resolve_device
from ..metrics import adapted_rand_error, voi
from ..models.fast_forward3d import build_fast_pni_forward
from ..ops import SHIFTS_3D, fused_affinity_3d, offsets_3d, relabel
from ..parallel import TiledInference3D
from ..postproc import agglomerate, mc_baseline, seg_mutex, watershed_from_affs
from .inference2d import build_model

# why the tiled engine does not serve MALA, in either package
MALA_NOT_TILED = (
    "unet3d_mala is not served tiled: its valid convolutions shrink a (53, 268, 268) "
    "tile to a (25, 56, 56) prediction, and the tiled engine, as the JAX package's, adds "
    "a prediction the size of its tile into the canvas")


def build_tiled_predictor(model: torch.nn.Module, fast: bool = False):
    """The tiled-serving predictor of an eval-mode UNetPNIEmbeddingDeep:
    (B, 1, d, h, w) float32 tiles -> (B, 12, d, h, w) ReLU'd affinities, on
    the tiles' device. It computes in the model's dtype, through the dense
    module, or with ``fast`` through the folded-BatchNorm graph built from
    the model's weights now; the embedding goes to K5f in float32."""
    if fast:
        fwd = build_fast_pni_forward(model, dtype=model.compute_dtype)

        def embed(tiles):
            return fwd(tiles.permute(0, 2, 3, 4, 1))
    else:
        def embed(tiles):
            with float32_convs():
                return model(tiles)[4].float().permute(0, 2, 3, 4, 1)

    @torch.no_grad()
    def predict(tiles: torch.Tensor) -> torch.Tensor:
        return fused_affinity_3d(embed(tiles), SHIFTS_3D).relu_()

    return predict


def serves_fast(cfg: Config) -> bool:
    """The JAX package's rule: the folded-BatchNorm graph serves when
    ``model.fast_tiled_infer`` is set and the arch is ``unet_pni_deep``."""
    return bool(cfg.model.fast_tiled_infer) and cfg.model.arch == "unet_pni_deep"


def serving_dtype(cfg: Config) -> str:
    """The tiled predictor's compute dtype: bfloat16 when
    ``model.bf16_tiled_infer`` is set or ``model.dtype`` resolves to
    bfloat16, else float32."""
    if cfg.model.bf16_tiled_infer or resolve_compute_dtype(cfg.model) == "bfloat16":
        return "bfloat16"
    return "float32"


def decode(affs: np.ndarray, decoder: str) -> np.ndarray:
    """One decoder on a (12, D, H, W) canvas -> relabelled int64 segmentation."""
    if decoder == "mutex":
        seg = seg_mutex(affs, offsets=offsets_3d(), strides=[1, 10, 10]).astype(np.uint64)
    elif decoder == "waterz":
        seg = agglomerate(affs[:3], watershed_from_affs(affs[:3]), threshold=0.5)
    elif decoder == "lmc":
        seg = mc_baseline(affs[:3])
    else:
        raise ValueError(f"unknown decoder {decoder!r}")
    return relabel(seg.astype(np.int64))


def run_inference_3d(cfg: Config, state_dict: dict | None, volume: np.ndarray,
                     gt: np.ndarray | None = None,
                     decoders=("mutex", "waterz", "lmc"),
                     crop_size=None, stride=(10, 80, 80), padding=(4, 48, 48),
                     batch_size: int = 4, timing: dict | None = None, device=None):
    """Returns (affinity canvas (12, D, H, W), {decoder: (seg, metrics)}).

    ``crop_size`` defaults to ``cfg.data.crop_size``. ``timing``, when
    given, receives the run's split in seconds: total (everything after the
    model build), setup (the model build), forward (upload, tiled forward
    and stitch, fetch), decode and metrics (dicts by decoder). ``device``:
    CUDA unless "cpu" is asked for. The predictor and its dtype follow the
    module docstring's rule.
    """
    if cfg.model.arch == "unet3d_mala":
        raise NotImplementedError(MALA_NOT_TILED)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    model = build_model(cfg, state_dict, dev, dtype=serving_dtype(cfg))
    predict = build_tiled_predictor(model, fast=serves_fast(cfg))
    engine = TiledInference3D(crop_size=crop_size or cfg.data.crop_size,
                              stride=stride, padding=padding, batch_size=batch_size)
    t_start = time.perf_counter()
    affs = engine.run(volume, predict, n_channels=len(SHIFTS_3D), device=dev)
    t_fwd = time.perf_counter() - t_start

    out, dec_s, met_s = {}, {}, {}
    for dec in decoders:
        t1 = time.perf_counter()
        seg = decode(affs, dec)
        dec_s[dec] = time.perf_counter() - t1
        t1 = time.perf_counter()
        metrics = {}
        if gt is not None:
            vs, vm = voi(gt, seg)
            metrics = {"voi_split": vs, "voi_merge": vm, "voi": vs + vm,
                       "arand": adapted_rand_error(gt, seg)[0]}
        met_s[dec] = time.perf_counter() - t1
        out[dec] = (seg, metrics)
    if timing is not None:
        timing.update(total_s=time.perf_counter() - t_start, setup_s=t_start - t0,
                      forward_s=t_fwd, decode_s=dec_s, metrics_s=met_s)
    return affs, out
