"""2D serving (CVPPP, BBBC039).

Batches of images go through the model, the fused embedding->affinity
kernel and a ReLU on the device, the convolutions in the compute dtype
(``model.dtype``; float32 in full, TF32 off). A bfloat16 model's embedding
is cast to float32 before the affinity kernel and its mask logits before
the decode, as the JAX package serves, so the host sees float32. The host
then runs mutex watershed, small-object merging and
relabelling, and scores SBD/|DiC|/VOI/ARAND. With ``use_fast`` the model
runs as the folded-BatchNorm fast forward
(:func:`..models.fast_forward.build_fast_resunet_forward`, as the JAX
package serves on its TPU: the image packed to s2d on the host, the
embedding head at full resolution) wherever H and W divide by 16, and as
the dense module elsewhere; with ``model.int8_infer`` that fast forward
runs its :data:`..models.fast_forward.INT8_DEFAULT_SITES` convs in int8,
calibrated once on the first ``model.int8_calib_k`` images in one batch
(the JAX package's one-dispatch serving). The watershed is seeded by
the labels' (or the given) foreground, or, with ``train.mask_weight``
(BBBC), by the mask head's: argmax of its logits > 0, components under 25
pixels dropped; BBBC also scores DQ/SQ/PQ, AJI and pixel F1. Samples are
dicts of HWC numpy arrays as :mod:`..data.cvppp` and :mod:`..data.bbbc`
produce them (``image``, and ``seg`` or ``fg``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Config, resolve_compute_dtype
from ..device import float32_convs, resolve_device
from ..metrics import (abs_diff_fg_labels, adapted_rand_error, agg_jc_index, get_fast_pq,
                       pixel_f1, remap_label, symmetric_best_dice, voi)
from ..models import model_from_config
from ..models.fast_forward import (INT8_DEFAULT_SITES, build_fast_resunet_forward,
                                   calibrate_int8_ranges, pack_image_s2d)
from ..ops import fused_affinity_2d, multi_offset, relabel
from ..postproc import merge_func, remove_small_object, seg_mutex

# images per device call when the caller does not choose, by image (H, W),
# as measured on an H100 (PERF.md): at 544x544 batch 4 costs less device
# time per image than batch 1; at 520x696 batch 4 costs 16x more per image,
# cuDNN choosing an FFT-tiled convolution there. Shapes not measured are
# served one at a time.
SERVE_BATCHES = {(544, 544): 4}


def serve_batch(image_shape) -> int:
    """The batch for images of this (H, W, ...) shape."""
    return SERVE_BATCHES.get(tuple(image_shape[:2]), 1)



def build_model(cfg: Config, state_dict: dict | None = None,
                device=None, dtype: str | None = None) -> torch.nn.Module:
    """The model of ``cfg.model.arch`` (:func:`..models.model_from_config`:
    ``resunet2d_deep``, ``resnet50_embedding``, ``resnet101_embedding``,
    ``unet_pni_deep``, ``unet3d_mala``) in eval mode on ``device``,
    computing in ``dtype`` ("float32" or "bfloat16"; by default
    ``model.dtype`` resolved), its float32 weights from ``state_dict`` when
    given. The ResNet archs serve 2D through the dense module and K1f."""
    dt = dtype or resolve_compute_dtype(cfg.model)
    dev = resolve_device(device)
    with dev:
        model = model_from_config(cfg.model, dt)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.eval()


@torch.no_grad()
def forward_affinities(model: torch.nn.Module, x_nchw: torch.Tensor, offsets,
                       with_mask: bool = False):
    """(B, 3, H, W) images -> (B, K, H, W) ReLU'd float32 affinities, on
    x's device, the embedding cast to float32 before K1f; ``with_mask``:
    and the mask head's logits in float32, a (B, H, W, 2) view."""
    with float32_convs():
        outs = model(x_nchw)
    affs = fused_affinity_2d(outs[4].float().permute(0, 2, 3, 1), offsets).relu_()
    return (affs, outs[5].float().permute(0, 2, 3, 1)) if with_mask else affs


def fast_affinities(fast, packed: torch.Tensor, offsets, with_mask: bool = False):
    """forward_affinities through a fast forward built with
    ``input_format="s2d"``, from the (B, H/2, W/2, 12) packed images."""
    emb, mask = fast(packed)
    affs = fused_affinity_2d(emb.float(), offsets).relu_()
    return (affs, mask) if with_mask else affs


def _batches(dataset, batch_size: int | None):
    """The dataset in order, as runs of one image shape of at most
    ``batch_size`` samples (:func:`serve_batch` of the run's shape when None)."""
    batch, limit = [], 0
    for i in range(len(dataset)):
        s = dataset[i]
        if batch and (len(batch) == limit or s["image"].shape != batch[0]["image"].shape):
            yield batch
            batch = []
        if not batch:
            limit = batch_size or serve_batch(s["image"].shape)
        batch.append(s)
    if batch:
        yield batch


def _fast_forward(cfg: Config, model, dataset, dev, with_mask: bool):
    """The fast forward of ``model`` on host-packed images; with
    ``model.int8_infer``, int8 at :data:`INT8_DEFAULT_SITES` with the ranges
    calibrated on the first ``model.int8_calib_k`` images of the dataset
    (those of its first image's shape), in one batch, at the
    ``model.int8_calib_pct`` quantile when set. The JAX package serves int8
    only where H and W divide by 16; so does this (the dense module serves
    the rest)."""
    kw = dict(dtype=model.compute_dtype, input_format="s2d", head_at_fullres=True)
    if cfg.model.int8_infer and len(dataset):
        first = dataset[0]["image"]
        k = max(1, min(int(cfg.model.int8_calib_k), len(dataset)))
        imgs = [im for im in (dataset[i]["image"] for i in range(k)) if im.shape == first.shape]
        if first.shape[0] % 16 == 0 and first.shape[1] % 16 == 0:
            packed = torch.from_numpy(pack_image_s2d(np.stack(imgs))).to(dev)
            ranges = calibrate_int8_ranges(model, [packed], dtype=model.compute_dtype,
                                           input_format="s2d",
                                           quantile=cfg.model.int8_calib_pct)
            kw.update(int8_sites=INT8_DEFAULT_SITES, act_ranges=ranges)
    return build_fast_resunet_forward(model, with_mask=with_mask, **kw)


def _served(cfg: Config, state_dict: dict, dataset, batch_size: int | None, device,
            clock: dict, with_mask: bool = False, use_fast: bool = False):
    """Yield (sample, (K, H, W) affinities, (H, W, 2) mask logits or None)
    in dataset order, the logits only ``with_mask``. A batch is a run of
    images of one shape, of ``batch_size`` at most, or when None of
    :func:`serve_batch` of that shape. ``use_fast`` serves
    ``resunet2d_deep`` through the fast forward where H and W divide by 16,
    in int8 with ``model.int8_infer``. Adds the wall time of the model
    build (and the int8 calibration) to clock['setup_s'], and that of
    upload, forward, affinity and fetch to clock['forward_s']."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    model = build_model(cfg, state_dict, dev)
    fast = (_fast_forward(cfg, model, dataset, dev, with_mask)
            if use_fast and cfg.model.arch == "resunet2d_deep" else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    clock["setup_s"] += time.perf_counter() - t0
    offsets = multi_offset(cfg.data.shifts, neighbor=cfg.data.neighbor)
    for samples in _batches(dataset, batch_size):
        t0 = time.perf_counter()
        imgs = np.stack([s["image"] for s in samples])
        if fast is not None and imgs.shape[1] % 16 == 0 and imgs.shape[2] % 16 == 0:
            out = fast_affinities(fast, torch.from_numpy(pack_image_s2d(imgs)).to(dev),
                                  offsets, with_mask)
        else:
            x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2).contiguous()
            out = forward_affinities(model, x, offsets, with_mask)
        affs, masks = ((o.cpu().numpy() for o in out) if with_mask
                       else (out.cpu().numpy(), [None] * len(samples)))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        clock["forward_s"] += time.perf_counter() - t0
        yield from zip(samples, affs, masks)


def run_inference_2d(cfg: Config, state_dict: dict, dataset,
                     out_dir: str | None = None, timing: dict | None = None,
                     batch_size: int | None = None, device=None,
                     use_fast: bool = False):
    """Serve and score a labelled set. Returns (per-image metric dicts,
    their means). With ``out_dir``, the segmentations and affinities are
    written there as seg.hdf / affs.hdf.

    ``timing``, when given, receives the run's split in seconds
    (total / setup / forward / decode / metrics; setup is the model build)
    and n_images. ``batch_size``: images per device call, by default
    :func:`serve_batch` of the images' shape; a change of image shape ends a
    batch. ``device``: CUDA unless "cpu" is asked for. ``use_fast``: serve
    through the fast forward (the JAX package's ``use_pallas`` for the
    forward; see the module's docstring). It is off by default: measured on
    an NVIDIA H100 80GB HBM3 at 700 W, 544x544, float32 with TF32 off,
    forward + affinity take 11.46 ms/img dense against 18.88 with the JAX
    default stage forms at batch 1, 8.09 against 13.94 at batch 4, the
    served batch (chip_smoke.py phase 16, PERF.md §5): the forms do 1.7x
    the dense model's multiply-adds, more than the folded BatchNorm saves.
    With ``train.mask_weight`` (BBBC) the predicted mask seeds the decode,
    as in the module's docstring; the mask threshold is part of decode_s.
    """
    bbbc = bool(cfg.train.mask_weight)
    offsets = multi_offset(cfg.data.shifts, neighbor=cfg.data.neighbor)
    t_start = time.perf_counter()
    clock = {"setup_s": 0.0, "forward_s": 0.0}
    t_dec = t_met = 0.0
    results, segs, all_affs = [], [], []
    for s, affs, mask in _served(cfg, state_dict, dataset, batch_size, device, clock,
                                 with_mask=bbbc, use_fast=use_fast):
        gt = s["seg"].astype(np.uint16)
        t0 = time.perf_counter()
        if bbbc:
            fg = remove_small_object((np.argmax(mask, axis=-1) > 0).astype(np.uint8),
                                     min_size=25)
        else:
            fg = (gt > 0).astype(np.uint8)
        seg = seg_mutex(affs, offsets=offsets, strides=list(cfg.data.strides),
                        mask=fg)
        seg = merge_func(seg.astype(np.uint16), variant="bbbc" if bbbc else "cvppp")
        seg = relabel(seg).astype(np.uint16)
        segs.append(seg)
        if out_dir:
            all_affs.append(affs)
        t_dec += time.perf_counter() - t0

        t0 = time.perf_counter()
        m = {"SBD": symmetric_best_dice(seg, gt),
             "DiC": abs_diff_fg_labels(seg, gt)}
        vs, vm = voi(gt, seg)
        m["VOI"] = vs + vm
        m["ARAND"] = adapted_rand_error(gt, seg)[0]
        if bbbc:
            gtr, pr = remap_label(gt.astype(np.int64)), remap_label(seg.astype(np.int64))
            m["AJI"] = agg_jc_index(gtr, pr)
            m["F1"] = pixel_f1(gtr, pr)
            (m["DQ"], m["SQ"], m["PQ"]), _ = get_fast_pq(gtr, pr)
        t_met += time.perf_counter() - t0
        results.append(m)

    agg = ({k: float(np.mean([r[k] for r in results])) for k in results[0]}
           if results else {})
    if timing is not None:
        timing.update(total_s=time.perf_counter() - t_start, **clock,
                      decode_s=t_dec, metrics_s=t_met, n_images=len(dataset))
    if out_dir:
        import h5py

        os.makedirs(out_dir, exist_ok=True)
        with h5py.File(os.path.join(out_dir, "seg.hdf"), "w") as f:
            f.create_dataset("main", data=np.stack(segs), compression="gzip")
        with h5py.File(os.path.join(out_dir, "affs.hdf"), "w") as f:
            f.create_dataset("main", data=np.stack(all_affs), compression="gzip")
    return results, agg


def run_cvppp_test(cfg: Config, state_dict: dict, dataset, out_path: str,
                   timing: dict | None = None, batch_size: int | None = None,
                   device=None, use_fast: bool = False):
    """CVPPP test protocol: FG mask given, no labels; decode and write the
    CodaLab submission.h5. Returns (segmentations, names). The arguments
    are those of :func:`run_inference_2d`."""
    offsets = multi_offset(cfg.data.shifts, neighbor=cfg.data.neighbor)
    t_start = time.perf_counter()
    clock = {"setup_s": 0.0, "forward_s": 0.0}
    t_dec = 0.0
    segs, names = [], []
    for s, affs, _ in _served(cfg, state_dict, dataset, batch_size, device, clock,
                              use_fast=use_fast):
        t0 = time.perf_counter()
        seg = seg_mutex(affs, offsets=offsets, strides=list(cfg.data.strides),
                        mask=s["fg"]).astype(np.uint16)
        seg = merge_func(seg)
        seg = relabel(seg).astype(np.uint16)
        t_dec += time.perf_counter() - t0
        segs.append(seg)
        names.append(s["name"])
    write_cvppp_submission(segs, names, out_path,
                           pad=(7, 22) if cfg.data.padding else (0, 0))
    if timing is not None:
        timing.update(total_s=time.perf_counter() - t_start, **clock,
                      decode_s=t_dec, n_images=len(dataset))
    return segs, names


def write_cvppp_submission(segs: list[np.ndarray], names: list[str],
                           out_path: str, pad=(7, 22)):
    """CodaLab submission.h5: A1/plantXXX/label datasets, padding stripped."""
    import h5py

    with h5py.File(out_path, "w") as f:
        for seg, name in zip(segs, names):
            s = seg[pad[0]:-pad[0], pad[1]:-pad[1]] if pad[0] else seg
            f.create_dataset(f"A1/{name}/label", data=s.astype(np.uint8))
