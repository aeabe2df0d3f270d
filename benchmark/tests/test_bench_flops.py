"""The benchmark's frozen FLOP and byte counts equal the program's today."""

import pytest

from benchmark import flops as frozen

SHAPES_2D = [(2, 544, 544), (1, 256, 256), (4, 64, 96)]
SHAPES_3D = [(2, 18, 160, 160), (1, 18, 160, 160), (4, 10, 64, 64)]


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_resunet2d_counts_match_the_program(shape):
    from pixel_embedded_affinity_torch.utils import flops as program

    for kw in ({}, {"act_bytes": 4}, {"nfeatures": (8, 16, 32, 64, 128), "emd": 8}):
        assert frozen.resunet2d_flops(*shape, **kw) == program.resunet2d_flops(*shape, **kw)


@pytest.mark.parametrize("shape", SHAPES_3D)
def test_unet3d_pni_counts_match_the_program(shape):
    from pixel_embedded_affinity_torch.utils import flops as program

    for kw in ({}, {"act_bytes": 4}):
        assert frozen.unet3d_pni_flops(*shape, **kw) == program.unet3d_pni_flops(*shape, **kw)


def test_affinity_counts_and_peaks_match_the_program():
    from pixel_embedded_affinity_torch.utils import flops as program

    assert frozen.emb2aff2d_flops(2, 544, 544) == program.emb2aff2d_flops(2, 544, 544)
    assert frozen.chip_peaks("NVIDIA H100 80GB HBM3") == program.chip_peaks(
        "NVIDIA H100 80GB HBM3")
    assert frozen.chip_peaks("unknown card") is None
