"""Training CLI, the port of the JAX package's root ``train.py``:

    python -m pixel_embedded_affinity_torch.train -c <preset | file.yaml> [-i ITERS] \
        [-o key=value ...] [--device cuda|cpu] [--distributed]

    torchrun --nproc_per_node=N -m pixel_embedded_affinity_torch.train \
        -c <preset> ... --distributed

``-c`` names a preset (cvppp, bbbc039v1, ac3ac4) or, when it is none, a
YAML file applied over the defaults, as the JAX CLI reads it; ``-o``
applies dotted overrides after either. The run trains on ``--device``
(CUDA unless ``cpu`` is asked for; without a card it raises), reads
``data.data_folder`` (or the arrays passed to :func:`main` as
``data_override``), writes the JAX package's msgpack checkpoints under
``<save_path>/<name>/`` and, with ``-o train.resume=True``, resumes from
the latest one there, whichever package wrote it. ``--distributed``
trains data-parallel, one process per card: it joins the process group
that ``torchrun``'s environment describes (NCCL on ``cuda:LOCAL_RANK``,
gloo with ``--device cpu``), or one the caller has initialised
(:func:`..parallel.multihost.initialize`), and ``train.batch_size`` is
the global batch (:func:`.loop.train`).
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None, data_override=None):
    """Parse ``argv`` and train; returns ``(state, history)`` of
    :func:`.loop.train`. ``data_override=(train, valid)`` stands in for
    ``data.data_folder``'s files, as :func:`.loop.train` takes it."""
    parser = argparse.ArgumentParser(prog="python -m pixel_embedded_affinity_torch.train")
    parser.add_argument("-c", "--cfg", type=str, default="cvppp",
                        help="preset name or path to a YAML file")
    parser.add_argument("-i", "--iters", type=int, default=None)
    parser.add_argument("-o", "--override", nargs="*", default=None,
                        help="dotted key=value overrides")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--distributed", action="store_true",
                        help="data parallelism over torch.distributed, one process per "
                             "card (torchrun)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    from ..config import PRESETS, load_config, parse_overrides
    from .loop import train

    overrides = parse_overrides(args.override)
    if args.cfg in PRESETS:
        cfg = load_config(args.cfg, overrides=overrides)
    else:
        cfg = load_config(yaml_path=args.cfg, overrides=overrides)
    if not args.distributed:
        return train(cfg, max_iters=args.iters, data_override=data_override,
                     device=args.device)
    import torch.distributed as dist

    from ..parallel.multihost import initialize

    joined = dist.is_initialized()
    mesh = initialize(args.device)
    try:
        return train(cfg, max_iters=args.iters, data_override=data_override, mesh=mesh)
    finally:
        if not joined:  # the group this call made ends with it
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
