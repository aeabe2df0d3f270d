"""The deterministic conv backward (``csrc/conv_grad.cu``) on a card.

CWg and CXg against their plain versions in float64 at 1e-5 of the largest
gradient, 1x1 and 3x3, at small and ragged shapes, each run twice bit for
bit; the Function through ``models/common.py``'s ``Conv2d`` against
cuDNN's backward in float64; a strided and a 7x7 ``Conv2d`` through
cuDNN's deterministic algorithms, twice bit for bit; and two 3-step float32 runs of the bbbc039v1
preset at filters (4, 6, 8, 12, 16) on 64x64 crops equal in every loss and
parameter, with the kernels launched by the step. Without a card it skips;
``chip_smoke.py`` runs the full-width shapes. On the card's machine, which
has no JAX, run this file without the tests' conftest: ``python -m pytest
--noconftest tests/test_torch_conv_grad_cuda.py``.
"""

import copy

import pytest

torch = pytest.importorskip("torch")

from pixel_embedded_affinity_torch.config import load_config
from pixel_embedded_affinity_torch.data import device_data as dd
from pixel_embedded_affinity_torch.data import synthesize_nuclei
from pixel_embedded_affinity_torch.device import float32_convs
from pixel_embedded_affinity_torch.models.common import Conv2d
from pixel_embedded_affinity_torch.ops.conv_grad_cuda import (
    conv_dgrad, conv_dgrad_plain, conv_wgrad, conv_wgrad_plain)
from pixel_embedded_affinity_torch.train import train

GATE = 1e-5


def _needs_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,h,w,k", [
    (2, 3, 16, 37, 41, 3), (2, 16, 40, 34, 34, 3), (1, 96, 32, 68, 68, 3),
    (2, 32, 2, 30, 50, 1), (2, 256, 16, 34, 34, 1)])
def test_kernels_match_float64_and_repeat(b, cin, cout, h, w, k):
    _needs_a_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, cin, h, w, device="cuda", generator=g)
    dy = torch.randn(b, cout, h, w, device="cuda", generator=g)
    wt = torch.randn(cout, cin, k, k, device="cuda", generator=g)
    dw = [conv_wgrad(x, dy, wt.shape) for _ in range(2)]
    dx = [conv_dgrad(dy, wt) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*dw) and torch.equal(*dx)
    assert _rel(dw[0], conv_wgrad_plain(x.double(), dy.double(), wt.shape)) <= GATE
    assert _rel(dx[0], conv_dgrad_plain(dy.double(), wt.double())) <= GATE


@pytest.mark.cuda
def test_conv2d_backward_goes_through_the_kernels():
    _needs_a_card()
    conv = Conv2d(16, 24, 3, padding=1).cuda()
    x = torch.randn(2, 16, 40, 40, device="cuda", requires_grad=True)
    dy = torch.randn(2, 24, 40, 40, device="cuda")
    w0, d0 = conv_wgrad.launches, conv_dgrad.launches
    conv(x).backward(dy)
    assert (conv_wgrad.launches - w0, conv_dgrad.launches - d0) == (1, 1)
    ref = copy.deepcopy(conv).double()
    x64 = x.detach().double().requires_grad_()
    torch.nn.functional.conv2d(x64, ref.weight, ref.bias, 1, 1).backward(dy.double())
    assert _rel(x.grad, x64.grad) <= GATE
    assert _rel(conv.weight.grad, ref.weight.grad) <= GATE
    assert _rel(conv.bias.grad, ref.bias.grad) <= GATE


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride", [(3, 2), (7, 2), (1, 2)])
def test_other_convs_backward_repeats_bit_for_bit(k, stride):
    _needs_a_card()
    conv = Conv2d(64, 128, k, stride=stride, padding=k // 2, bias=False).cuda()
    x = torch.randn(2, 64, 68, 68, device="cuda", requires_grad=True)
    y = conv(x)
    assert "Conv2dCudnnDeterministicGrad" in type(y.grad_fn).__name__
    dy = torch.randn_like(y)
    grads = []
    with float32_convs():  # TF32 off, as the training steps run
        for _ in range(2):
            x.grad = conv.weight.grad = None
            conv(x).backward(dy)
            grads.append((x.grad.clone(), conv.weight.grad.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    ref = copy.deepcopy(conv).double()
    x64 = x.detach().double().requires_grad_()
    ref(x64).backward(dy.double())
    assert _rel(x.grad, x64.grad) <= GATE
    assert _rel(conv.weight.grad, ref.weight.grad) <= GATE


@pytest.mark.cuda
def test_float32_bbbc_steps_are_bit_reproducible(tmp_path):
    _needs_a_card()
    arrays = dd.pad_bbbc_arrays(synthesize_nuclei(2, 96, 112, seed=5), padding=30)
    runs = []
    for i in range(2):
        cfg = load_config("bbbc039v1", {
            "model": {"filters": (4, 6, 8, 12, 16)}, "data": {"size": 64, "bbbc_padding": 30},
            "train": {"display_freq": 1, "if_valid": False},
            "save_path": str(tmp_path / f"run{i}")})
        w0 = conv_wgrad.launches
        timing = {}
        state, _ = train(cfg, max_iters=3, data_override=(arrays, []), device="cuda",
                         timing=timing)
        assert conv_wgrad.launches > w0
        runs.append((timing["loss"], state.model.state_dict()))
    (la, a), (lb, b) = runs
    assert la == lb
    for k in a:
        assert torch.equal(a[k], b[k]), k
