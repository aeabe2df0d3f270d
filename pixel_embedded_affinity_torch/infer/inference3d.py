"""3D serving (AC3/AC4): tiled forward and three decoders.

The volume goes through the tiled engine (:mod:`..parallel.tiling`): each
batch of tiles runs the model, the fused 3D affinity kernel
(:func:`..ops.fused_affinity_3d`) and a ReLU on the device, the convolutions
in full float32 (TF32 off), or in bfloat16 with ``model.bf16_tiled_infer``
or a bfloat16 ``model.dtype`` (the JAX package's rule), the embedding then
cast to float32 before the affinity; the Gaussian-blended (12, D, H, W)
float32 canvas is fetched once. The host then decodes it with mutex watershed (the 12-offset
table, strides [1, 10, 10]), waterz-style mean-affinity agglomeration at 0.5
on the first 3 channels, and multicut (lmc), and scores VOI/ARAND per
decoder.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config, resolve_compute_dtype
from ..device import float32_convs, resolve_device
from ..metrics import adapted_rand_error, voi
from ..ops import SHIFTS_3D, fused_affinity_3d, offsets_3d, relabel
from ..parallel import TiledInference3D
from ..postproc import agglomerate, mc_baseline, seg_mutex, watershed_from_affs
from .inference2d import build_model


def build_tiled_predictor(model: torch.nn.Module, float32_affinity: bool = True):
    """The tiled-serving predictor of an eval-mode 3D model: (B, 1, d, h, w)
    float32 tiles -> (B, 12, d, h, w) ReLU'd affinities, on the tiles'
    device. The model computes in its dtype; with ``float32_affinity`` its
    embedding is cast to float32 before K5f (JAX's dense serving graph),
    else K5f takes it as it is and returns its dtype."""

    @torch.no_grad()
    def predict(tiles: torch.Tensor) -> torch.Tensor:
        with float32_convs():
            embedding = model(tiles)[4]
        if float32_affinity:
            embedding = embedding.float()
        return fused_affinity_3d(embedding.permute(0, 2, 3, 4, 1), SHIFTS_3D).relu_()

    return predict


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
                     batch_size: int = 4, timing: dict | None = None, device=None,
                     float32_affinity: bool = True):
    """Returns (affinity canvas (12, D, H, W), {decoder: (seg, metrics)}).

    ``crop_size`` defaults to ``cfg.data.crop_size``. ``timing``, when
    given, receives the run's split in seconds: total (everything after the
    model build), setup (the model build), forward (upload, tiled forward
    and stitch, fetch), decode and metrics (dicts by decoder). ``device``:
    CUDA unless "cpu" is asked for. The model computes in
    :func:`serving_dtype`; ``float32_affinity``: as
    :func:`build_tiled_predictor`'s (the training loop's validation passes
    False).
    """
    if cfg.model.fast_tiled_infer:
        raise NotImplementedError(
            "model.fast_tiled_infer is the JAX package's folded-BN TPU serving "
            "graph and is not ported (ROADMAP.md, Modules still to port, 3D "
            "extras): the port serves the dense model")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    model = build_model(cfg, state_dict, dev, dtype=serving_dtype(cfg))
    predict = build_tiled_predictor(model, float32_affinity)
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
