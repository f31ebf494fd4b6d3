"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test asks the ``cuda`` fixture for the card and skips
without one.  This file imports neither jax nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F

from vaeunet_tpu_torch import build_model, segmentation_distribution, use_fp32_numerics
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import bn_relu, reparam, resize_mm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_fp32_numerics()
    return torch.device("cuda")


def cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("shape", [(8, 64, 32, 32), (2, 6, 5, 7), (3, 512, 4, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    c = shape[1]
    x = cl(torch.randn(shape, device=cuda, generator=g).to(dtype))
    stats = [torch.rand(c, device=cuda, generator=g) + 0.5 for _ in range(4)]
    before = _ext.launch_counts()["bn_relu"]
    y = bn_relu.fused_bn_relu(x, *stats)
    assert _ext.launch_counts()["bn_relu"] == before + 1
    ref = bn_relu.fused_bn_relu_plain(x, *bn_relu.fold(*stats))
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    # products and sums rounded as torch rounds them: the same bits
    assert torch.equal(y, ref)


@pytest.mark.parametrize("shape,out_hw", [((8, 64, 16, 16), (32, 32)), ((2, 1, 32, 32), (64, 64)),
                                          ((1, 5, 7, 9), (19, 4))])
@pytest.mark.parametrize("ac", [True, False])
def test_resize_kernel_matches_plain(cuda, shape, out_hw, ac):
    x = cl(torch.randn(shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1)))
    y = resize_mm.resize(x, out_hw, ac)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, resize_mm.resize_plain(x, out_hw, ac), atol=1e-6, rtol=0)
    lib = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=ac)
    torch.testing.assert_close(y, lib, atol=1e-5, rtol=0)


def test_noise_kernels_match_plain(cuda):
    z = reparam.normal((8192, 64), 11, cuda)
    torch.testing.assert_close(z, reparam.normal_plain((8192, 64), 11, cuda), atol=1e-5, rtol=0)
    assert abs(z.mean().item()) < 0.01 and abs(z.std().item() - 1) < 0.01
    mu = torch.randn(10, 32, device=cuda)
    logvar = torch.randn(10, 32, device=cuda)
    torch.testing.assert_close(reparam.reparameterize(mu, logvar, 5, 1.5),
                               reparam.reparameterize_plain(mu, logvar, 5, 1.5),
                               atol=5e-5, rtol=0)


def test_slice_on_the_card_matches_the_cpu(cuda):
    model = build_model(backbone="resnet18", seed=0, device=cuda)
    img = torch.rand((96, 80, 3), generator=torch.Generator().manual_seed(2))
    eps = torch.randn((2, 1, 32), generator=torch.Generator().manual_seed(3))
    gpu = segmentation_distribution(model, img, num_samples=2, patch_size=64, eps=eps,
                                    device=cuda)
    cpu = segmentation_distribution(model.to("cpu"), img, num_samples=2, patch_size=64,
                                    eps=eps, device="cpu")
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], atol=2e-4, rtol=0)
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], atol=1e-4, rtol=0)
