"""Frozen serving artifacts through ``torch.export``, the port of the JAX
package's ``infer/export.py`` (there ``jax.export`` to StableHLO).

An artifact holds the checkpoint's weights, the model's forward and the
embedding -> affinity step as one ``ExportedProgram`` saved with
``torch.export.save`` (``.pt2``). A consumer needs ``torch.export.load``
only: no model code, no config, no state dict. As in the JAX package:

* the artifact embeds the plain affinity (:mod:`..ops.emb2aff`'s
  oracle) and the plain upsampling (``F.interpolate``), not the kernels:
  the serving function is built on those ops explicitly, and a ctypes
  launch could not be traced anyway. The decoders stay outside, on the
  host, as at serving time;
* the batch dimension is symbolic by default (``torch.export.Dim("b")``,
  1 to 65535, on every argument's leading dimension), the spatial ones
  static: CVPPP
  544x544, BBBC039 336x688, the 3D tile (18, 160, 160). The example batch
  is 2, since export fixes a dimension whose example size is 1;
* the weights are the export device's; :func:`load_artifact` moves a
  loaded program to another device.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..device import resolve_device
from ..ops import multi_offset
from ..ops.emb2aff import embedding_to_affinity_2d, embedding_to_affinity_3d
from ..ops.offsets import SHIFTS_3D
from .inference2d import build_model

class _Serving2D(torch.nn.Module):
    def __init__(self, model, offsets, need_mask: bool):
        super().__init__()
        self.model, self.offsets, self.need_mask = model, offsets, need_mask

    def forward(self, image):
        outs = self.model(image.permute(0, 3, 1, 2))
        emb = outs[4].float().permute(0, 2, 3, 1)
        affs = embedding_to_affinity_2d(emb, self.offsets).relu()
        if self.need_mask:
            return affs, outs[5].float().permute(0, 2, 3, 1)
        return (affs,)


class _Serving3D(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tiles):
        outs = self.model(tiles.permute(0, 4, 1, 2, 3))
        emb = outs[-1] if isinstance(outs, (tuple, list)) else outs
        return (embedding_to_affinity_3d(emb.float().permute(0, 2, 3, 4, 1),
                                         tuple(SHIFTS_3D)).relu(),)


def make_serving_fn_2d(cfg: Config, state_dict: dict, device=None) -> torch.nn.Module:
    """``fn(image (B, H, W, 3) float32) -> (affs (B, K, H, W),
    mask_logits (B, H, W, 2))``, the mask only where the preset trains the
    mask head (``train.mask_weight``, BBBC): the dense module in eval mode
    (the direct graph), the embedding in
    float32, the ReLU'd multi-offset affinities of :mod:`..ops.emb2aff`.
    On ``device`` (CUDA unless the CPU is asked for)."""
    model = build_model(cfg, state_dict, resolve_device(device))
    offsets = [tuple(o) for o in multi_offset(cfg.data.shifts, neighbor=cfg.data.neighbor)]
    return _Serving2D(model, offsets, bool(cfg.train.mask_weight)).eval()


def make_serving_fn_3d(cfg: Config, state_dict: dict, device=None) -> torch.nn.Module:
    """``fn(tiles (B, d, h, w, 1) float32) -> (affs (B, 12, d, h, w),)``:
    the tiled engine's predictor, the model and the ReLU'd shift-table
    affinities; the blending of tiles stays outside."""
    return _Serving3D(build_model(cfg, state_dict, resolve_device(device))).eval()


def export_serving(fn: torch.nn.Module, arg_shapes, arg_dtype=torch.float32,
                   symbolic_batch: bool = True) -> torch.export.ExportedProgram:
    """``torch.export.export`` of ``fn`` over one example argument a shape
    (batch first), on ``fn``'s device. ``symbolic_batch``: one symbolic
    size ``b`` for every leading dimension, so one artifact serves any
    batch."""
    dev = next(fn.parameters()).device
    if symbolic_batch:
        arg_shapes = [(2,) + tuple(s[1:]) for s in arg_shapes]
        # at most 65535: CUDA kernels of the graph launch a grid dimension
        # per image, and export on the card adds that guard
        b = torch.export.Dim("b", max=65535)
        dynamic = tuple({0: b} for _ in arg_shapes)
    else:
        dynamic = None
    args = tuple(torch.zeros(tuple(s), dtype=arg_dtype, device=dev) for s in arg_shapes)
    with torch.no_grad():
        return torch.export.export(fn, args, dynamic_shapes=dynamic)


def save_artifact(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write an exported program to ``path`` (``torch.export.save``)."""
    torch.export.save(exported, path)


def load_artifact(path: str, device=None) -> torch.export.ExportedProgram:
    """Read a saved artifact; with ``device``, its weights and constants
    moved there. Call it as ``load_artifact(path).module()(*args)``."""
    exported = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, torch.device(device))
    return exported


def input_avals(exported: torch.export.ExportedProgram) -> list:
    """Each user input as "dtype[d0,d1,...]", a symbolic size as its name
    ("b"), the form of the JAX CLI's ``in_avals``."""
    names = set(exported.graph_signature.user_inputs)
    out = []
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name in names:
            val = node.meta["val"]
            dims = ["b" if not isinstance(d, int) else str(d) for d in val.shape]
            out.append(f"{str(val.dtype).replace('torch.', '')}[{','.join(dims)}]")
    return out


def export_checkpoint(cfg: Config, state_dict: dict, path: str, hw=None, tile=(18, 160, 160),
                      symbolic_batch: bool = True, device=None) -> torch.export.ExportedProgram:
    """Freeze ``state_dict`` under ``cfg`` to ``path`` and return the
    exported program: 2D presets ``image (b, H, W, 3) -> (affs[,
    mask_logits])`` at ``hw`` (by default the preset's padded serving shape),
    3D presets the tile predictor at ``tile``."""
    if cfg.model.arch in ("unet_pni_deep", "unet3d_mala"):
        fn = make_serving_fn_3d(cfg, state_dict, device)
        shapes = [(1,) + tuple(tile) + (1,)]
    else:
        if hw is None:
            hw = (336, 688) if cfg.name == "bbbc039v1" else (544, 544)
        fn = make_serving_fn_2d(cfg, state_dict, device)
        shapes = [(1, hw[0], hw[1], cfg.model.input_nc)]
    exported = export_serving(fn, shapes, symbolic_batch=symbolic_batch)
    save_artifact(exported, path)
    return exported
