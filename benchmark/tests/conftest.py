"""Shared pieces of the benchmark's tests: the repository on the path, a
fixture that skips where there is no CUDA card, and shrunken cells for the
CPU."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels and the control's TF32 run there")
    return torch.device("cuda:0")


def tiny_cell(name: str, size: int = 64):
    """The manifest's cell ``name`` at sizes a CPU test can hold: few small
    plants or a small volume, 32x32 tiles; every width as configured. The 2D
    teacher's view keeps no filled squares: up to 20 squares of up to 20
    pixels cover a 64x64 plant, where they cover 2% of a 544x544 one."""
    from benchmark import harness

    cell = harness.resolve(name)
    c = copy.deepcopy(cell.config)
    if c["synth"]["kind"] == "leaves":
        c["synth"].update(images=6, height=size - 11, width=size - 14)
        c["data"].update(size=size, if_ema_mask=False)
    else:
        c["synth"].update(shape=[24, 96, 96], cell=[8, 32, 32])
        c["data"].update(crop_size=[18, 32, 32], padding_3d=8)
    cell.config = c
    t = dict(cell.traffic)
    if t["driver"] == "serve_tiled3d":
        t.update(volume_shape=[20, 64, 64], crop=[18, 32, 32], stride=[10, 16, 16],
                 padding=[4, 8, 8], distinct_volumes=2)
    cell.traffic = t
    return cell
