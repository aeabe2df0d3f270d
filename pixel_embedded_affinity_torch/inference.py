"""Serving CLI (2D, CVPPP):

    python -m pixel_embedded_affinity_torch.inference -c cvppp -ck <ckpt> \
        [--torch-ckpt] [-m validation|test] [--out PATH] [--device cuda|cpu] \
        [-o data.data_folder=...]

The checkpoint is the JAX package's msgpack file, or with ``--torch-ckpt``
a reference torch ``.ckpt``. Validation mode prints SBD/DiC/VOI/ARAND;
test mode writes the CodaLab submission.h5.
"""

from __future__ import annotations

import argparse
import json


def load_state_dict(path: str, torch_ckpt: bool) -> dict:
    """State dict for :class:`models.ResidualUNet2DDeep` from either
    checkpoint format."""
    from .convert import load_torch_state_dict, resunet2d_deep_from_flax

    if torch_ckpt:
        return load_torch_state_dict(path)
    from .checkpoint import load_jax_checkpoint

    restored = load_jax_checkpoint(path)
    return resunet2d_deep_from_flax({"params": restored["params"],
                                     "batch_stats": restored.get("batch_stats", {})})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg", type=str, default="cvppp")
    parser.add_argument("-ck", "--checkpoint", type=str, required=True)
    parser.add_argument("-m", "--mode", choices=("validation", "test"),
                        default="validation")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--torch-ckpt", action="store_true",
                        help="checkpoint is a reference torch .ckpt file")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("-o", "--override", nargs="*", default=None,
                        help="dotted key=value overrides")
    args = parser.parse_args(argv)

    from .config import load_config, parse_overrides
    from .data.cvppp import CVPPPTest, CVPPPValidation
    from .infer import run_cvppp_test, run_inference_2d

    cfg = load_config(args.cfg, overrides=parse_overrides(args.override))
    sd = load_state_dict(args.checkpoint, args.torch_ckpt)
    timing: dict = {}
    if args.mode == "test":
        ds = CVPPPTest(cfg.data.data_folder, padding=cfg.data.padding)
        out = args.out or "submission.h5"
        _, names = run_cvppp_test(cfg, sd, ds, out, timing=timing,
                                  device=args.device)
        print("COST TIME:", json.dumps(timing))
        print(json.dumps({"submission": out, "images": len(names)}))
    else:
        ds = CVPPPValidation(cfg.data.data_folder, valid_set=cfg.data.valid_set,
                             padding=cfg.data.padding)
        _, agg = run_inference_2d(cfg, sd, ds, out_dir=args.out, timing=timing,
                                  device=args.device)
        print("COST TIME:", json.dumps(timing))
        print(json.dumps(agg))


if __name__ == "__main__":
    main()
