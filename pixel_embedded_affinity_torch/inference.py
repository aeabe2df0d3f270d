"""Serving CLI, 2D (CVPPP, BBBC039) and 3D (AC3/AC4):

    python -m pixel_embedded_affinity_torch.inference -c cvppp -ck <ckpt> \
        [--torch-ckpt] [-m validation|test] [--out PATH] [--device cuda|cpu] \
        [--fast] [-o data.data_folder=...]
    python -m pixel_embedded_affinity_torch.inference -c bbbc039v1 -ck <ckpt> \
        [--torch-ckpt] [-m validation|test] [--out PATH] [--device cuda|cpu] \
        [-o data.data_folder=...]
    python -m pixel_embedded_affinity_torch.inference -c ac3ac4 -ck <ckpt> \
        [--torch-ckpt] [-m validation|valid|test] [--decoders mutex,waterz,lmc] \
        [--device cuda|cpu] [-o data.data_folder=...]
    python -m pixel_embedded_affinity_torch.inference -c <preset> -ck <ckpt> \
        --export model.pt2 [--export-hw H,W] [--device cuda|cpu]

The checkpoint is the JAX package's msgpack file, or with ``--torch-ckpt``
a reference torch ``.ckpt``. CVPPP validation mode prints SBD/DiC/VOI/ARAND;
test mode writes the CodaLab submission.h5. BBBC039 serves the validation
split (``-m test``: the test split) at 520x696, seeded by the predicted
mask, and prints SBD/DiC/VOI/ARAND with AJI/F1/DQ/SQ/PQ. 3D runs the tiled engine on one
volume (as the JAX CLI selects it: ``-m test`` the first 100 slices of AC3,
``-m valid`` the last 20 of AC4, any other mode all of AC4) and prints
VOI/ARAND per decoder and the timing split. ``--fast`` serves 2D through
the folded-BatchNorm fast forward instead of the dense module.
``-o model.dtype=bfloat16`` serves in bfloat16 compute (the affinities and
the decode in float32), and for 3D ``-o model.bf16_tiled_infer=True`` does
so for the tiled predictor alone. ``-o model.int8_infer=true`` with
``--fast`` serves 2D in int8 (calibrated on the first
``model.int8_calib_k`` images). ``--export PATH`` serves nothing: it
freezes the checkpoint, the forward and the plain affinity into a
``torch.export`` artifact with a symbolic batch (:mod:`.infer.export`;
2D at ``--export-hw`` or the preset's padded shape, 3D the (18, 160, 160)
tile) on ``--device`` and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json


def load_state_dict(path: str, torch_ckpt: bool, arch: str = "resunet2d_deep") -> dict:
    """State dict of the ``arch`` model from either checkpoint format."""
    from .convert import (load_torch_state_dict, resunet2d_deep_from_flax,
                          unet_pni_deep_from_flax)

    if torch_ckpt:
        return load_torch_state_dict(path)
    from .checkpoint import load_jax_checkpoint

    restored = load_jax_checkpoint(path)
    convert = unet_pni_deep_from_flax if arch == "unet_pni_deep" else resunet2d_deep_from_flax
    return convert({"params": restored["params"],
                    "batch_stats": restored.get("batch_stats", {})})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, default="cvppp")
    parser.add_argument("-ck", "--checkpoint", type=str, required=True)
    parser.add_argument("-m", "--mode", choices=("validation", "valid", "test"),
                        default="validation")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--torch-ckpt", action="store_true",
                        help="checkpoint is a reference torch .ckpt file")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("-o", "--override", nargs="*", default=None,
                        help="dotted key=value overrides")
    parser.add_argument("--decoders", type=str, default="mutex,waterz,lmc",
                        help="3D decoders to run (comma-separated)")
    parser.add_argument("--fast", action="store_true",
                        help="2D: serve through the folded-BatchNorm fast forward")
    parser.add_argument("--export", type=str, default=None, metavar="PATH",
                        help="instead of serving, freeze the checkpoint + forward + affinity "
                             "graph to a torch.export artifact (symbolic batch)")
    parser.add_argument("--export-hw", type=str, default=None,
                        help="2D export spatial shape as H,W (default: the preset's padded "
                             "serving shape)")
    args = parser.parse_args(argv)

    from .config import load_config, parse_overrides
    from .data.bbbc import BBBCValidation
    from .data.cvppp import CVPPPTest, CVPPPValidation
    from .infer import run_cvppp_test, run_inference_2d

    cfg = load_config(args.cfg, overrides=parse_overrides(args.override))
    sd = load_state_dict(args.checkpoint, args.torch_ckpt, cfg.model.arch)
    if args.export:
        from .infer.export import export_checkpoint, input_avals

        hw = tuple(int(v) for v in args.export_hw.split(",")) if args.export_hw else None
        exported = export_checkpoint(cfg, sd, args.export, hw=hw, device=args.device)
        print(json.dumps({"artifact": args.export, "platforms": [args.device],
                          "in_avals": input_avals(exported)}))
        return
    timing: dict = {}
    if cfg.model.arch == "unet_pni_deep":
        from .data.ac3ac4 import AC3AC4ValidVolume
        from .infer import run_inference_3d

        vol = AC3AC4ValidVolume(
            cfg.data.data_folder,
            dataset_name="ac3" if args.mode == "test" else cfg.data.dataset_name,
            mode=args.mode)
        _, results = run_inference_3d(cfg, sd, vol.raw, gt=vol.label,
                                      decoders=tuple(args.decoders.split(",")),
                                      timing=timing, device=args.device)
        for dec, (_, m) in results.items():
            print(dec, json.dumps(m))
        print("COST TIME:", json.dumps(timing))
    elif args.mode == "test" and cfg.data.dataset == "cvppp":
        ds = CVPPPTest(cfg.data.data_folder, padding=cfg.data.padding)
        out = args.out or "submission.h5"
        _, names = run_cvppp_test(cfg, sd, ds, out, timing=timing,
                                  device=args.device, use_fast=args.fast)
        print("COST TIME:", json.dumps(timing))
        print(json.dumps({"submission": out, "images": len(names)}))
    else:
        if cfg.data.dataset == "bbbc039v1":
            ds = BBBCValidation(cfg.data.data_folder, shifts=tuple(cfg.data.shifts),
                                neighbor=cfg.data.neighbor,
                                mode="test" if args.mode == "test" else "validation")
        else:
            ds = CVPPPValidation(cfg.data.data_folder, shifts=tuple(cfg.data.shifts),
                                 neighbor=cfg.data.neighbor, valid_set=cfg.data.valid_set,
                                 padding=cfg.data.padding)
        _, agg = run_inference_2d(cfg, sd, ds, out_dir=args.out, timing=timing,
                                  device=args.device, use_fast=args.fast)
        print("COST TIME:", json.dumps(timing))
        print(json.dumps(agg))


if __name__ == "__main__":
    main()
