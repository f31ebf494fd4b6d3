"""The data path on the card against the CPU: the device cache's gathers,
the augmentation at fixed parameters, and the indexed augmented step.

Marked ``cuda``; each test asks the ``cuda`` fixture for the card and skips
without one.  Imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_cuda_data.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from vaeunet_tpu_torch import use_fp32_numerics
from vaeunet_tpu_torch.data import augment
from vaeunet_tpu_torch.data.device_cache import gather_batch_device, gather_patch_records_device
from vaeunet_tpu_torch.device import true_div
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_fp32_numerics()
    return torch.device("cuda")


def test_true_div_rounds_once_on_the_card(cuda):
    x = torch.arange(256, dtype=torch.float32)
    assert torch.equal(true_div(x.to(cuda), 255.0).cpu(), x / 255.0)


def test_gathers_equal_the_cpu(cuda):
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (3, 40, 48, 3)).astype(np.uint8))
    masks = torch.from_numpy(rng.randint(0, 2, (3, 40, 48, 5)).astype(np.uint8))
    rec = torch.tensor([[0, 0, 0], [2, 8, 16], [1, 3, 5]])
    for m in (masks, masks[..., 0]):
        a = gather_patch_records_device(images.to(cuda), m.to(cuda), rec.to(cuda), 32)
        b = gather_patch_records_device(images, m, rec, 32)
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)
    flat = images[:, :32, :32]
    a = gather_batch_device(flat.to(cuda), masks[:, :32, :32].to(cuda), rec[:, 0].to(cuda))
    b = gather_batch_device(flat, masks[:, :32, :32], rec[:, 0])
    assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))


def test_policy_on_the_card_equals_the_cpu(cuda):
    """The whole policy at one set of parameters and noise: masks exact;
    images within CLAHE's one bf16 LUT step (2^-8 x image / luma)."""
    g = torch.Generator().manual_seed(1)
    images = torch.rand((8, 64, 64, 3), generator=g)
    masks = (torch.rand((8, 64, 64, 1), generator=g) > 0.8).float()
    raw = augment.draw_params(torch.Generator().manual_seed(2), 8)
    eps = torch.randn((8, 64, 64, 3), generator=g)
    a = augment.apply_policy(augment.params_to(raw, cuda), images.to(cuda), masks.to(cuda),
                             eps.to(cuda))
    b = augment.apply_policy(augment.params_to(raw, "cpu"), images, masks, eps)
    assert torch.equal(a[1].cpu(), b[1])
    assert (a[0].cpu() - b[0]).abs().max().item() <= 2.0 ** -7


def test_indexed_augmented_step_counts_its_launches(cuda):
    """One indexed, augmented resnet18 step at 64^2: 2 noise draws (the
    augmentation's and the latent's), every parameter finite."""
    config = TrainConfig(model_type="resnet", backbone="resnet18", batch_size=2,
                         gradient_accumulation_steps=1, amp=True, patch_size=64)
    state = create_train_state(config, seed=0, device=cuda)
    images = torch.randint(0, 256, (3, 80, 80, 3), dtype=torch.uint8, device=cuda)
    masks = torch.randint(0, 2, (3, 80, 80), dtype=torch.uint8, device=cuda)

    def gather(di, dm, rec):
        return gather_patch_records_device(di, dm, rec, 64)

    step = make_train_step(config, state.model, augment=True, indexed=True, gather=gather)
    _ext.reset_launch_counts()
    state, aux = step(state, images, masks, np.array([[0, 0, 0], [2, 16, 8]]), 0.001)
    torch.cuda.synchronize()
    assert _ext.launch_counts()["normal"] == 2
    assert bool(torch.isfinite(aux["loss"]))
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
