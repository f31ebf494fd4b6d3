"""The kernels at the shapes of the plain UNet, the resnet50 VAE-UNet with
deep supervision and remat, on the card.

Marked ``cuda``; each test asks the ``cuda`` fixture for the card and skips
without one.  This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_cuda_models.py -m cuda --noconftest -q
"""

import pytest
import torch

from vaeunet_tpu_torch.models import build_unet
from vaeunet_tpu_torch.ops import _ext, remat
from vaeunet_tpu_torch.ops.layers import BatchNorm, Conv, conv3x3_bn
from vaeunet_tpu_torch.ops.pallas import conv_bn_stats, resize_mm
from vaeunet_tpu_torch.ops.resize import resize_bilinear
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


# the new paths' channel counts at a small batch and size: Ci = 3 (bf16
# takes the Ci <= 8 kernel, fp32 copies 4 bytes at a time), the ragged K chunks of the
# resnet50 decoder (3104, 1056, 544), the UNet's 1024-wide bottom
NEW_CONVS = [((2, 3, 64, 64), 64), ((2, 3104, 8, 8), 512), ((2, 1056, 16, 16), 256),
             ((2, 544, 32, 32), 128), ((2, 512, 8, 8), 1024), ((2, 1024, 8, 8), 1024),
             ((2, 128, 64, 64), 64)]


@pytest.mark.parametrize("shape,co", NEW_CONVS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_plain_at_the_new_shapes(cuda, shape, co, dtype):
    """y within 1e-5 of the summed magnitudes (plus a bf16 ulp), the sums
    within 1e-5 (fp32) / 1e-4 (bf16) relative: as chip_smoke.py holds it."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = cl(torch.randn(shape, device=cuda, generator=g).to(dtype))
    w = (torch.randn((co, shape[1], 3, 3), device=cuda, generator=g)
         / (3.0 * shape[1] ** 0.5)).to(dtype)
    counter = ("conv_bn_stats_ci8" if conv_bn_stats.route(shape[1], co, dtype)
               == conv_bn_stats.SMALL_CI_ENTRY else "conv_bn_stats")
    before = _ext.launch_counts()[counter]
    y, s, q = conv_bn_stats.conv3x3_bn_stats(x, w)
    assert _ext.launch_counts()[counter] == before + 1
    ry, rs, rq = conv_bn_stats.conv3x3_bn_stats_plain(x, w)
    mag = torch.nn.functional.conv2d(x.float().abs(), w.float().abs(), padding=1)
    room = 1e-5 * mag
    if dtype == torch.bfloat16:
        room = room + torch.maximum(y.float().abs(), ry.float().abs()) * 2.0 ** -7
    assert bool(((y.float() - ry.float()).abs() <= room).all())
    rel = 1e-5 if dtype == torch.float32 else 1e-4
    assert bool(((s - rs).abs() <= rel * ry.float().abs().sum(dim=(0, 2, 3))).all())
    assert bool(((q - rq).abs() <= rel * rq).all())


@pytest.mark.parametrize("shape,out", [((2, 1, 512, 512), (128, 128)),
                                       ((2, 1, 512, 512), (64, 64)),
                                       ((2, 1, 512, 512), (32, 32)),
                                       ((1, 1, 1424, 2144), (2848, 4288))])
def test_one_channel_path_resizes_take_the_row_kernel_bit_for_bit(cuda, shape, out):
    """The mask downsamples for deep supervision and predict.py's upscale,
    align_corners=False: the row kernel, equal to the plain version and to
    the scalar kernel."""
    x = cl(torch.rand(shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1)))
    y = resize_mm.resize(x, out, False)
    assert "_row_" in resize_mm.launch_args(x, y, False)[0]
    other = torch.empty_like(y)
    fn, args = resize_mm.launch_args(x, other, False, scalar=True)
    _ext.call("resize", fn, x.device, *args)
    torch.cuda.synchronize()
    assert torch.equal(y, resize_mm.resize_plain(x, out, False))
    assert torch.equal(y, other)


@pytest.mark.parametrize("shape,out", [((2, 2048, 16, 16), 32), ((2, 64, 256, 256), 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_new_path_resizes_match_plain_and_scalar(cuda, shape, out, dtype):
    """The resnet50 decoder's first upsample and the bilinear UNet's last
    (align_corners=True), forward and backward: within the plain version's
    tolerance (fp32 1e-6, of the summed magnitudes in the backward, plus a
    bf16 ulp), and the kernel the plan picks equal to the scalar kernel."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = cl(torch.randn(shape, device=cuda, generator=g).to(dtype))
    gy = cl(torch.randn((shape[0], shape[1], out, out), device=cuda, generator=g).to(dtype))
    y = resize_mm.resize(x, (out, out), True)
    gx = resize_mm.resize_backward(gy, shape[2:], True)
    for got, src, backward in ((y, x, False), (gx, gy, True)):
        other = torch.empty_like(got)
        fn, args = resize_mm.launch_args(src, other, True, backward=backward, scalar=True)
        _ext.call("resize", fn, src.device, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, other), backward
    ulp = 0.0 if dtype == torch.float32 else 2.0 ** -7
    ref = resize_mm.resize_plain(x, (out, out), True).float()
    assert bool(((y.float() - ref).abs() <= 1e-6 + ref.abs() * ulp).all())
    ref = resize_mm.resize_backward_plain(gy, shape[2:], True).float()
    mag = resize_mm.resize_backward_plain(gy.float().abs(), shape[2:], True)
    assert bool(((gx.float() - ref).abs() <= 1e-6 * mag + gx.float().abs() * ulp).all())


class _Block(torch.nn.Module):
    """An upsample (the resize kernel) and a conv + BN (the conv kernel)."""

    def __init__(self):
        super().__init__()
        self.conv = Conv(16, 16, 3, padding=1, bias=False)
        self.bn = BatchNorm(16)

    def forward(self, x):
        return conv3x3_bn(self.conv, self.bn, resize_bilinear(x, (32, 32)), relu=True)


@pytest.mark.parametrize("policy", ["full", "save_convs"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_through_a_checkpointed_block_with_kernels(cuda, policy, dtype):
    """The gradient reaches the input and the weights through a
    rematerialized block that holds a resize and a conv kernel, equal to
    the block's without remat; the BN statistics move once; 'save_convs'
    launches the conv once, 'full' twice."""
    torch.manual_seed(0)
    block = _Block().to(cuda).train()
    ref_block = _Block().to(cuda).train()
    ref_block.load_state_dict(block.state_dict())
    x = cl(torch.randn((2, 16, 16, 16), device=cuda)).to(dtype).requires_grad_(True)
    x_ref = x.detach().clone().requires_grad_(True)
    _ext.reset_launch_counts()
    y = remat.checkpoint(block, x, policy=policy)
    (y.float() ** 2).sum().backward()
    counts = _ext.launch_counts()
    (ref_block(x_ref).float() ** 2).sum().backward()
    torch.cuda.synchronize()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    assert counts["conv_bn_stats"] == (2 if policy == "full" else 1)
    assert counts["resize"] == 2 and counts["resize_bwd"] == 1
    # the recompute repeats the forward's kernels; what may differ is the
    # order of cuDNN's backward sums: fp32 rounding, or a bf16 ulp
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(x.grad, x_ref.grad, atol=tol, rtol=tol)
    torch.testing.assert_close(block.conv.weight.grad, ref_block.conv.weight.grad,
                               atol=tol, rtol=tol)
    assert int(block.bn.num_batches_tracked) == 1
    torch.testing.assert_close(block.bn.running_mean, ref_block.bn.running_mean, atol=0, rtol=0)
    torch.testing.assert_close(block.bn.running_var, ref_block.bn.running_var, atol=0, rtol=0)


@pytest.mark.parametrize("kind,per_step", [
    ("unet", dict(conv_bn_stats=17, conv_bn_stats_ci8=1, bn_train_fwd=18, bn_train_bwd=18,
                  resize=0, resize_bwd=0, normal=0)),
    ("unet_bilinear", dict(conv_bn_stats=17, conv_bn_stats_ci8=1, bn_train_fwd=18,
                           bn_train_bwd=18, resize=4, resize_bwd=4, normal=0)),
    ("resnet50_ds", dict(conv_bn_stats=21, bn_train_fwd=21, bn_train_bwd=21, resize=8,
                         resize_row=4, resize_bwd=5, resize_bwd_row=1, normal=1)),
])
def test_steps_launch_the_counted_kernels(cuda, kind, per_step):
    """A bf16 step at 64^2, batch 2: every parameter gets a finite
    gradient and the kernels launch as often as the code says; the
    optimizer step is one launch of each of its two kernels over every
    parameter's elements."""
    fields = dict(unet=dict(model_type="basic"),
                  unet_bilinear=dict(model_type="basic", bilinear=True),
                  resnet50_ds=dict(backbone="resnet50", deep_supervision=True))[kind]
    config = TrainConfig(batch_size=2, gradient_accumulation_steps=1, patch_size=64, amp=True,
                         **fields)
    state = create_train_state(config, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    images = torch.rand((2, 64, 64, 3), device=cuda, generator=g)
    masks = (torch.rand((2, 64, 64, 1), device=cuda, generator=g) > 0.9).float()
    _ext.reset_launch_counts()
    make_train_step(config, state.model).compute_gradients(state, images, masks, 0.001)
    torch.cuda.synchronize()
    counts = _ext.launch_counts()
    for k, v in per_step.items():
        assert counts[k] == v, (k, counts)
    for name, p in state.model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert counts["clip_adamw_norm"] == counts["clip_adamw_update"] == 0
    state.optimizer.step()
    torch.cuda.synchronize()
    after = _ext.launch_counts()
    assert {k: after[k] - counts[k] for k in after if after[k] != counts[k]} == {
        "clip_adamw_norm": 1, "clip_adamw_update": 1,
        "clip_adamw_elems": sum(p.numel() for p in state.model.parameters())}


@pytest.mark.parametrize("kind,bn_torch", [("resnet50", 57), ("resnet50_ds", 57)])
def test_profiled_step_counts_the_torch_op_bns(cuda, kind, bn_torch):
    """Under a profiler session, one bf16 resnet50 step at 64^2, batch 2
    runs 57 training BNs on torch's ops (every BN outside the 21 fused
    sites; deep supervision's heads carry none), and ``bn_torch_bytes``
    counts their inputs' bf16 bytes; unprofiled, the counters stay 0."""
    config = TrainConfig(batch_size=2, gradient_accumulation_steps=1, patch_size=64, amp=True,
                         backbone="resnet50", deep_supervision=kind == "resnet50_ds")
    state = create_train_state(config, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    images = torch.rand((2, 64, 64, 3), device=cuda, generator=g)
    masks = (torch.rand((2, 64, 64, 1), device=cuda, generator=g) > 0.9).float()
    step = make_train_step(config, state.model)
    seen = []
    hooks = [m.register_forward_pre_hook(lambda _m, args: seen.append(args[0]))
             for m in state.model.modules() if isinstance(m, BatchNorm)]
    try:
        _ext.reset_launch_counts()
        step.compute_gradients(state, images, masks, 0.001)
        assert _ext.launch_counts()["bn_torch"] == 0
        seen.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            step.compute_gradients(state, images, masks, 0.001)
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    counts = _ext.launch_counts()
    assert counts["bn_torch"] == len(seen) == bn_torch
    assert counts["bn_torch_bytes"] == sum(t.numel() * 2 for t in seen)
    assert all(t.dtype == torch.bfloat16 for t in seen)
    assert counts["bn_train_fwd"] == counts["bn_train_bwd"] == 2 * 21


def test_unet_eval_forward_launches_bn_relu(cuda):
    model = build_unet(3, 1, bilinear=True, device=cuda)
    x = cl(torch.rand((1, 3, 64, 48), device=cuda))
    _ext.reset_launch_counts()
    with torch.inference_mode():
        logits = model(x)
    counts = _ext.launch_counts()
    assert logits.shape == (1, 1, 64, 48) and bool(torch.isfinite(logits).all())
    assert counts["bn_relu"] == 18 and counts["resize"] == 4
