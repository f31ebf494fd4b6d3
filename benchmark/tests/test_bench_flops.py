"""The operation counts the metrics divide by, against hand counts."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import flops
from benchmark.reference.train import loss_of
from benchmark.reference.unet import UNet
from benchmark.reference.vae_unet import VAEUNet


def conv(n, h, w, ci, co, k):
    return 2 * n * h * w * ci * co * k * k


def unet_forward_by_hand(n, s):
    total = conv(n, s, s, 3, 64, 3) + conv(n, s, s, 64, 64, 3)
    chans = [64, 128, 256, 512, 1024]
    for i in range(1, 5):                                   # Down: max pool, DoubleConv
        hw = s >> i
        total += conv(n, hw, hw, chans[i - 1], chans[i], 3) + conv(n, hw, hw, chans[i], chans[i], 3)
    for i in range(4, 0, -1):                               # Up from level i to i - 1
        ci, half, hw = chans[i], chans[i] // 2, s >> (i - 1)
        total += conv(n, hw // 2, hw // 2, ci, half, 2)    # transposed: input pixels x window
        total += 2 * conv(n, hw, hw, half, ci // 4, 1) + conv(n, hw, hw, ci // 4, 1, 1)
        total += conv(n, hw, hw, ci, chans[i - 1], 3) + conv(n, hw, hw, chans[i - 1],
                                                             chans[i - 1], 3)
    return total + conv(n, s, s, 64, 1, 1)


def test_unet_forward_count_equals_the_hand_count():
    with torch.device("meta"):
        model, x = UNet(), torch.empty((2, 3, 32, 32))
    assert flops.count(lambda: model(x)) == unet_forward_by_hand(2, 32)


def test_training_step_counts_backward_without_the_input_gradient():
    with torch.device("meta"):
        model = UNet().train()
        x, m = torch.empty((2, 32, 32, 3)), torch.empty((2, 32, 32, 1))
    step = flops.count(lambda: loss_of(model, x, m, None, 0.0, 0.0).backward())
    first = conv(2, 32, 32, 3, 64, 3)                       # no gradient for the images
    assert step == 3 * unet_forward_by_hand(2, 32) - first


@pytest.mark.parametrize("model,sites", [(lambda: VAEUNet(), 37), (lambda: UNet(), 18)])
def test_conv3x3_sites_are_the_fused_kernel_sites(model, sites):
    with torch.device("meta"):
        m = model()
        x = torch.empty((2, 3, 64, 64))
        eps = torch.empty((2, 32))
    run = (lambda: m(x, eps)) if isinstance(m, VAEUNet) else (lambda: m(x))
    found = flops.conv3x3_sites(m, run)
    assert len(found) == sites
    assert all(ci >= 3 and co >= 64 for _, ci, _, _, co in found)


def test_conv3x3_roofline_bound_of_one_site():
    site = (16, 224, 256, 256, 64)                          # the kernel table's bf16 shape
    ops, nbytes = flops.conv3x3_ops_bytes(site, "bf16")
    assert ops == 2 * 16 * 256 * 256 * 64 * 224 * 9
    assert nbytes == 2 * (16 * 256 * 256 * 224 + 9 * 224 * 64 + 16 * 256 * 256 * 64) + 8 * 64
    assert flops.conv3x3_bound_s([site], "bf16") == pytest.approx(ops / 989e12)
