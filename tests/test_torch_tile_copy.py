"""The tile copy (P) and the arrangement probe, on the CPU.

The TPU kernel, ``pallas_copy`` in ``docs/profile_b1_arrange.py``, is a
closure inside that script's ``main()`` and cannot be imported, so the
port's function is held to what it does: over the tiles it covers the
output equals the input, for float32 and bfloat16 and the probe's three
arrangements of the embedding; an axis that the tile does not divide, and
a tensor that is not contiguous, raise. On the CPU the wrapper runs its
plain version; the CUDA kernel is held against it bit for bit on the card
by ``chip_smoke.py``. The probe's four variants run at a tiny width and
return finite times.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a test worker: tier 1 runs six xdist workers on the
# host's cores, and oversubscribed OpenMP threads slow a step 50-fold
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

from pixel_embedded_affinity_torch.ops import tile_copy, tile_copy_plain
from pixel_embedded_affinity_torch.utils import profile_arrange

EMB = (1, 64, 96, 16)  # (B, H, W, C), the probe's NHWC embedding at a small size
# the probe's arrangements: (permutation of the NHWC embedding, tile axis = H)
ARRANGEMENTS = {"NHWC": ((0, 1, 2, 3), 1), "NCHW": ((0, 3, 1, 2), 2),
                "BHCW": ((0, 1, 3, 2), 1)}


@pytest.mark.parametrize("arrangement", list(ARRANGEMENTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_copy_equals_input(arrangement, dtype):
    perm, axis = ARRANGEMENTS[arrangement]
    g = torch.Generator().manual_seed(0)
    t = torch.randn(EMB, generator=g).to(dtype).permute(*perm).contiguous()
    tile_copy.launches = 0
    out = tile_copy(t, tile_axis=axis)
    assert out.dtype == dtype and out.shape == t.shape and out.is_contiguous()
    assert out.data_ptr() != t.data_ptr()
    assert torch.equal(out, t) and torch.equal(tile_copy_plain(t, axis), t)
    assert tile_copy.launches == 0  # the CPU runs the plain version


def test_misaligned_view_and_odd_size():
    """A view one element into its storage, of a size that is no multiple
    of 16 bytes."""
    buf = torch.arange(1 + 3 * 33 * 5 * 7, dtype=torch.bfloat16)
    t = buf[1:].view(3, 33, 5, 7)
    assert t.storage_offset() == 1 and (t.numel() * t.element_size()) % 16
    assert torch.equal(tile_copy(t, 1, 11), t)


def test_indivisible_axis_raises():
    t = torch.zeros(1, 65, 32, 16)
    with pytest.raises(ValueError, match="multiple of the tile"):
        tile_copy(t, tile_axis=1, tile=32)
    with pytest.raises(ValueError, match="multiple of the tile"):
        tile_copy_plain(t, tile_axis=1, tile=32)
    with pytest.raises(ValueError, match="out of range"):
        tile_copy(t, tile_axis=4)


def test_non_contiguous_raises():
    t = torch.zeros(1, 64, 32, 16).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tile_copy(t, tile_axis=2)


def test_probe_variants_run_and_give_finite_times():
    ms = profile_arrange.run(1, "cpu", filters=(4, 6, 8, 12, 16), side=32, iters=1, warmup=0)
    assert list(ms) == ["forward only", "copy of emb NHWC", "copy of emb NCHW",
                        "copy of (B,H,C,W)"]
    assert all(np.isfinite(v) and v > 0 for v in ms.values())


def test_probe_variants_return_the_embedding_arranged():
    """Each variant's output is the forward's embedding, as NHWC, NCHW and
    (B, H, C, W)."""
    from pixel_embedded_affinity_torch.models import (
        ResidualUNet2DDeep, build_fast_resunet_forward, pack_image_s2d)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ResidualUNet2DDeep(3, 2, (4, 6, 8, 12, 16), 16).eval()
    fwd = build_fast_resunet_forward(model, dtype=torch.bfloat16, input_format="s2d")
    img = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(pack_image_s2d(img)).to(torch.bfloat16)
    with torch.no_grad():
        out = {k: f(x) for k, f in profile_arrange.variants(fwd).items()}
    emb = out["forward only"]
    assert emb.shape == (2, 32, 32, 16) and emb.dtype == torch.bfloat16
    assert torch.equal(out["copy of emb NHWC"], emb)
    assert torch.equal(out["copy of emb NCHW"], emb.permute(0, 3, 1, 2))
    assert torch.equal(out["copy of (B,H,C,W)"], emb.permute(0, 1, 3, 2))
