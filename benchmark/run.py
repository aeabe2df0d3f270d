"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is the result's
JSON object; the numbers compared for ``correct``, each beside its limit, are
the last lines of standard error and the result's last key. Without a CUDA
card, or with fewer than the cell asks for, it prints no result and exits 2;
if the process holds a forbidden module (JAX or the JAX package) once the
window has closed, it names it and exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs():
    """Keep the program's build and kernel caches at fixed paths inside the
    checkout (the program builds its kernels into ``build/torch_kernels``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.resolve(args.workload)
    import torch

    print(f"[bench] torch imported {time.perf_counter() - T_START:.2f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    print(f"[bench] CUDA ready {time.perf_counter() - T_START:.2f} s", file=sys.stderr)
    limit = harness.power_limit()
    print(f"[bench] card: {limit}", file=sys.stderr, flush=True)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                              T_START)
    if limit is not None:
        result["device"]["power_limit"] = limit
    leaked = harness.forbidden_loaded()
    if leaked:
        print(f"[bench] forbidden modules loaded: {leaked}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
