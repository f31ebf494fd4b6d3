"""The EfficientNet-B4 VAE-UNet (``models/efficientnet.py``) on the CPU,
against the plain reference of its benchmark configuration
(``benchmark/reference/efficientnet.py``) on one seeded weight dictionary,
at the published widths: the squeeze-excite, one MBConv block, the
encoder's feature maps, the whole model's forward, loss and gradient; the
``bn_batch`` SiLU path against ``F.batch_norm`` + ``F.silu``; the depthwise
conv's routing away from the fused 3x3 kernel; the model through the
loop's step, ``training/loop.py`` and ``segmentation_distribution``.

Bounds, each with its reason:

- a part (SE, block, encoder maps) and the eval-mode forward: the same
  float32 arithmetic in another order, so atol 5e-4 on the logits and
  1e-4 on mu, logvar and the parts' outputs (the port's parity bounds
  against the JAX package; they read ~2e-7 here);
- the float32 training loss: 1e-5 relative (float32 rounding of one
  forward);
- the float32 gradient before the clip, whole, by relative L2 against
  the reference's in float64, within 1.5 times the float32 reference's
  own gap: at 64^2 training-mode BN over few rows makes the gradient
  chaotic in float32 rounding (``tests/torch_train_parity.py``); both
  read 0.5-1 % at batch 4, their ratio 0.88-1.10 over four weight seeds.
  The training comparisons take batch 4, not 2: at batch 2 the latent's
  BNs (``z_initial``, ``z_proj``) see two distinct values a channel, whose
  normalised output is +-1 and whose gradient is divided by their
  difference, so either float32 gradient reads 1-26 % from float64 and
  their ratio 0.7-3.9;
- the port's side in bf16 fails these bounds (the last test shows it), so
  they can tell the precision the port computes in.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import weights
from benchmark.reference import efficientnet as ref_effnet
from benchmark.reference.efficientnet import EfficientNetVAEUNet
from benchmark.reference.train import follow, loss_of
from vaeunet_tpu_torch.inference.predict import segmentation_distribution
from vaeunet_tpu_torch.models import efficientnet
from vaeunet_tpu_torch.models.vae_unet import build_model
from vaeunet_tpu_torch.ops import _ext, layers
from vaeunet_tpu_torch.ops.pallas import bn_train
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

BACKBONE = "efficientnet_b4"
BETA = FREE_BITS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def seeded(serving: bool, seed: int = 7):
    with torch.device("meta"):
        shapes = EfficientNetVAEUNet()
    return weights.make(shapes, seed, "cpu", serving=serving)


def load_part(part: torch.nn.Module, ref: torch.nn.Module, seed: int = 5) -> None:
    """The same random weights (and serving-like statistics) into a port
    part and a reference part whose state dicts share names."""
    g = torch.Generator().manual_seed(seed)
    state = {k: v for k, v in ref.state_dict().items() if not k.endswith("num_batches_tracked")}
    for k, v in state.items():
        if k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
        else:
            v.copy_(torch.randn(v.shape, generator=g) * (0.5 if v.dim() == 1 else 0.2))
    part.load_state_dict(state, strict=False)
    assert set(state) == {k for k in part.state_dict() if not k.endswith("num_batches_tracked")}


def test_reference_state_dict_is_the_programs():
    with torch.device("meta"):
        ref = EfficientNetVAEUNet()
    prog = build_model(backbone=BACKBONE, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in prog.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    assert shapes == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert prog.encoder.feature_channels == ref.encoder.channels == [24, 32, 56, 160, 448]
    assert [b.conv1[0].weight.shape[1] for b in prog.decoder_blocks] == [640, 600, 320, 184]
    assert shapes["encoder.conv_stem.weight"] == (48, 3, 3, 3)
    assert shapes["encoder.blocks.0.0.conv_dw.weight"] == (48, 1, 3, 3)
    assert shapes["encoder.blocks.0.0.se.conv_reduce.weight"] == (12, 48, 1, 1)
    assert shapes["encoder.blocks.1.0.conv_pw.weight"] == (144, 24, 1, 1)
    assert shapes["encoder.blocks.5.7.conv_dw.weight"] == (1632, 1, 5, 5)
    assert shapes["encoder.blocks.5.7.se.conv_reduce.weight"] == (68, 1632, 1, 1)
    assert shapes["encoder.blocks.6.1.conv_pwl.weight"] == (448, 2688, 1, 1)
    assert [len(s) for s in prog.encoder.blocks] == [2, 4, 4, 6, 6, 8, 2]
    assert sum(p.numel() for p in prog.encoder.parameters()) == 16_742_216


@pytest.mark.parametrize("channels,reduced,hw", [(48, 12, 16), (1632, 68, 4), (2688, 112, 2)])
def test_squeeze_excite_against_the_reference(channels, reduced, hw):
    port, ref = layers.SqueezeExcite(channels, reduced), ref_effnet.SqueezeExcite(
        channels, reduced)
    load_part(port, ref)
    x = torch.randn((2, channels, hw, hw), generator=torch.Generator().manual_seed(1))
    before = _ext.launch_counts()["se"]
    torch.testing.assert_close(port(cl(x)), ref(x), atol=1e-4, rtol=0)
    assert _ext.launch_counts()["se"] == before + 1


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("ci,co,k,stride,expansion,hw", [
    (48, 24, 3, 1, 1, 32), (24, 24, 3, 1, 1, 32), (24, 32, 3, 2, 6, 32), (56, 112, 3, 2, 6, 8),
    (160, 160, 5, 1, 6, 4)])
def test_block_against_the_reference(ci, co, k, stride, expansion, hw, train):
    """One block at its published widths: output, and in training the
    gradients of its input and of every parameter, each by relative L2
    within 1e-4 (float32 rounding of the BN's sums over the batch: both
    read under 5e-6 against float64; bf16 reads ~4e-3)."""
    port = (efficientnet.DepthwiseSeparable(ci, co, k, stride) if expansion == 1
            else efficientnet.InvertedResidual(ci, co, k, stride, expansion))
    ref = ref_effnet.Block(ci, co, k, stride, expansion)
    load_part(port, ref)
    port.train(train)
    ref.train(train)
    x = torch.randn((2, ci, hw, hw), generator=torch.Generator().manual_seed(2))
    xp, xr = cl(x).requires_grad_(), x.clone().requires_grad_()
    yp, yr = port(xp), ref(xr)
    assert yp.shape == (2, co, hw // stride, hw // stride)
    torch.testing.assert_close(yp, yr, atol=1e-4, rtol=0)
    if train:
        g = torch.randn(yr.shape, generator=torch.Generator().manual_seed(3))
        yp.backward(cl(g))
        yr.backward(g)
        grads = dict(ref.named_parameters())
        pairs = [("x", xp.grad, xr.grad)] + [(n, p.grad, grads[n].grad)
                                             for n, p in port.named_parameters()]
        for name, a, r in pairs:
            assert float((a - r).norm() / r.norm()) <= 1e-4, name


def test_encoder_feature_maps():
    w = seeded(serving=True)
    prog = weights.load(build_model(backbone=BACKBONE, device="cpu"), w).eval()
    ref = weights.load(EfficientNetVAEUNet(), w).eval()
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(4))
    before = _ext.launch_counts()
    with torch.no_grad():
        fp, fr = prog.encoder(cl(x)), ref.encoder(x)
    after = _ext.launch_counts()
    assert [tuple(f.shape) for f in fp] == [(2, 24, 32, 32), (2, 32, 16, 16), (2, 56, 8, 8),
                                           (2, 160, 4, 4), (2, 448, 2, 2)]
    for a, b in zip(fp, fr):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert after["dwconv"] - before["dwconv"] == 32 and after["se"] - before["se"] == 32


def test_forward_agrees_at_64():
    w = seeded(serving=True)
    prog = weights.load(build_model(backbone=BACKBONE, device="cpu"), w).eval()
    ref = weights.load(EfficientNetVAEUNet(), w).eval()
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 3, 64, 64), generator=g)
    eps = torch.randn((2, 32), generator=g)
    with torch.no_grad():
        lp, mp, vp = prog(cl(x), eps=eps)
        lr, mr, vr = ref(x, eps)
    assert lp.shape == lr.shape == (2, 1, 64, 64)
    torch.testing.assert_close(lp, lr, atol=5e-4, rtol=0)
    torch.testing.assert_close(mp, mr, atol=1e-4, rtol=0)
    torch.testing.assert_close(vp, vr, atol=1e-4, rtol=0)


def train_batch(b: int = 4, hw: int = 64):
    g = torch.Generator().manual_seed(3)
    images = torch.rand((b, hw, hw, 3), generator=g)
    masks = (torch.rand((b, hw, hw, 1), generator=g) > 0.85).float()
    eps = torch.randn((b, 32), generator=g)
    return images, masks, eps


def program_step(amp: bool, w):
    """The loop's step (before the clip) on the port: (aux, gradients)."""
    images, masks, eps = train_batch()
    config = TrainConfig(model_type="resnet", backbone=BACKBONE, batch_size=4,
                         gradient_accumulation_steps=1, patch_size=64, amp=amp, beta=BETA,
                         free_bits=FREE_BITS)
    state = create_train_state(config, seed=0, device="cpu")
    weights.load(state.model, w)
    aux = make_train_step(config, state.model).compute_gradients(state, images, masks, BETA,
                                                                 eps=eps[None])
    return aux, {n: p.grad for n, p in state.model.named_parameters()}


def reference_step(w, dtype):
    images, masks, eps = train_batch()
    ref = weights.load(EfficientNetVAEUNet().train(), w).to(dtype)
    mu_lv = {}
    ref.register_forward_hook(
        lambda _m, _i, out: mu_lv.update(mu=out[1].detach(), logvar=out[2].detach()))
    loss = loss_of(ref, images.to(dtype), masks.to(dtype), eps.to(dtype), BETA, FREE_BITS)
    loss.backward()
    return float(loss.detach()), mu_lv, {n: p.grad for n, p in ref.named_parameters()}


def gaps(aux, grads, w):
    """The training numbers this file bounds: the loss's relative gap, mu's
    and logvar's widest gap, the gradient's relative L2 gap to float64
    over the float32 reference's."""
    loss32, mulv, ref32 = reference_step(w, torch.float32)
    _, _, exact = reference_step(w, torch.float64)
    names = sorted(exact)
    assert set(grads) == set(exact)

    def gap(grad):
        a = torch.cat([grad[n].double().reshape(-1) for n in names])
        e = torch.cat([exact[n].reshape(-1) for n in names])
        return float((a - e).norm() / e.norm())

    return {"loss": abs(float(aux["loss"]) - loss32) / abs(loss32),
            "mu": float((aux["mu"] - mulv["mu"]).abs().max()),
            "logvar": float((aux["logvar"] - mulv["logvar"]).abs().max()),
            "grad": gap(grads) / gap(ref32)}


BOUNDS = {"loss": 1e-5, "mu": 1e-4, "logvar": 1e-4, "grad": 1.5}


def test_fp32_train_step_follows_the_reference():
    """The loop's float32 step (amp off) at batch 4, 64^2: loss, mu and
    logvar of the training forward, and the whole gradient before the clip
    (bounds: the module docstring); then ``follow``'s first loss is the
    step's."""
    w = seeded(serving=False)
    aux, grads = program_step(False, w)
    got = gaps(aux, grads, w)
    assert all(got[k] <= BOUNDS[k] for k in BOUNDS), got
    images, masks, eps = train_batch()
    first = follow(weights.load(EfficientNetVAEUNet(), w), [(images, masks, eps)], BETA,
                   FREE_BITS, 1e-4, 1e-5, 1.0)
    assert abs(float(aux["loss"]) - first["loss"][0]) <= 1e-5 * abs(first["loss"][0])


def test_bf16_train_step_fails_the_bounds():
    """The same step in bf16 (amp on) breaks at least one bound: the
    comparison tells the precision apart."""
    w = seeded(serving=False)
    got = gaps(*program_step(True, w), w)
    assert any(got[k] > BOUNDS[k] for k in BOUNDS), got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_batch_silu_plain_against_torch(dtype):
    """``bn_batch``'s CPU path with the SiLU against training
    ``F.batch_norm`` + ``F.silu``, forward and backward: the output within
    ``test_torch_bn_batch.py``'s bound for the BN alone (the moments and
    torch's sums round apart), the gradients by relative L2 1e-5 in float32
    and 2e-2 in bf16 (torch's SiLU backward rounds g' to bf16, the closed
    form keeps it in float32)."""
    g = torch.Generator().manual_seed(8)
    x = cl((torch.randn((4, 24, 9, 7), generator=g) * 1.5 + 0.3).to(dtype))
    grad = cl(torch.randn(x.shape, generator=g).to(dtype))
    w = torch.rand(24, generator=g) + 0.5
    b = torch.randn(24, generator=g) * 0.5
    xa, wa, ba = x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    out = bn_train.bn_batch(xa, wa, ba, bn_train.SILU, 1e-5, None)
    xb, wb, bb = x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    want = F.silu(F.batch_norm(xb, None, None, wb, bb, True, 0.1, 1e-5))
    ulp = torch.finfo(dtype).eps
    torch.testing.assert_close(out.float(), want.float(), rtol=2 * ulp + 1e-4, atol=4 * ulp)
    ours = torch.autograd.grad(out, (xa, wa, ba), grad)
    theirs = torch.autograd.grad(want, (xb, wb, bb), grad)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, t in zip(ours, theirs):
        rel = float((a.double() - t.double()).norm() / t.double().norm())
        assert rel <= tol, rel


def test_batchnorm_module_silu_on_every_path():
    """``BatchNorm(x, silu=True)`` is ``F.silu`` of the BN in training (CPU)
    and in eval mode; the ReLU path is unchanged."""
    bn = layers.BatchNorm(16)
    x = cl(torch.randn((2, 16, 5, 5), generator=torch.Generator().manual_seed(9)))
    for train in (True, False):
        bn.train(train)
        ref = layers.BatchNorm(16).train(train)
        ref.load_state_dict(bn.state_dict())
        want = F.batch_norm(x, ref.running_mean, ref.running_var, ref.weight, ref.bias, train,
                            0.1, 1e-5)
        torch.testing.assert_close(bn(x, silu=True), F.silu(want))
        torch.testing.assert_close(bn(x, relu=True), F.relu(F.batch_norm(
            x, bn.running_mean.clone(), bn.running_var.clone(), bn.weight, bn.bias, train,
            0.1, 1e-5)))


def test_depthwise_conv_never_takes_the_fused_site(monkeypatch):
    """A stride-1 3x3 depthwise conv with its BN, through ``conv3x3_bn`` or
    through the encoder, never reaches ``conv3x3_bn_stats``; a dense one
    does."""
    calls = []
    real = layers.conv3x3_bn_stats

    def spy(x, w):
        calls.append(tuple(w.shape))
        return real(x, w)

    monkeypatch.setattr(layers, "conv3x3_bn_stats", spy)
    dw = layers.DepthwiseConv(32, 3, 1)
    assert not dw.takes_bn_stats_kernel() and dw.groups == 32 and dw.padding == (1, 1)
    bn = layers.BatchNorm(32).train()
    x = cl(torch.randn((2, 32, 8, 8), generator=torch.Generator().manual_seed(1)))
    before = _ext.launch_counts()["conv_bn_stats"]
    layers.conv3x3_bn(dw, bn, x, relu=True).sum().backward()
    encoder = efficientnet.EfficientNetEncoder().train()
    encoder(cl(torch.rand((2, 3, 64, 64))))
    assert calls == [] and _ext.launch_counts()["conv_bn_stats"] == before
    layers.conv3x3_bn(layers.Conv(32, 8, 3, padding=1, bias=False), layers.BatchNorm(8).train(),
                      x, relu=True)
    assert calls == [(8, 32, 3, 3)]


def test_unknown_backbone_is_refused():
    with pytest.raises(ValueError, match="unknown backbone"):
        build_model(backbone="efficientnet_b9", device="cpu")


def test_indexed_step_and_remat_train_the_model():
    """``make_train_step(indexed=True)`` moves every parameter of the model
    that has a gradient, and a rematerialized model's step gives the plain
    one's gradient."""
    images = torch.randint(0, 256, (6, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    masks = (torch.rand((6, 64, 64, 1), generator=torch.Generator().manual_seed(3)) > 0.8).to(
        torch.uint8)
    grads = []
    for remat in (False, True):
        config = TrainConfig(model_type="resnet", backbone=BACKBONE, batch_size=2,
                             gradient_accumulation_steps=1, patch_size=64, amp=False,
                             use_remat=remat)
        state = create_train_state(config, seed=0, device="cpu")
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        step = make_train_step(config, state.model, indexed=True)
        state, aux = step(state, images, masks, np.array([4, 1]), 1e-3,
                          eps=torch.randn((1, 2, 32), generator=torch.Generator().manual_seed(5)))
        assert np.isfinite(float(aux["loss"])) and state.step == 1
        # a conv's bias before a batch-statistics BN has a gradient of 0 up
        # to rounding, and may stay where it was
        still = [n for n, p in state.model.named_parameters() if torch.equal(p, before[n])]
        assert all(float(state.model.get_parameter(n).grad.abs().max()) < 1e-6 for n in still)
        assert len(still) <= 1, still
        grads.append({n: p.grad.clone() for n, p in state.model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], atol=1e-6, rtol=1e-4)


def test_serving_distribution_runs_in_eval_mode():
    model = build_model(backbone=BACKBONE, device="cpu")
    image = np.random.default_rng(0).random((96, 80, 3)).astype(np.float32)
    samples, mu, logvar = segmentation_distribution(model, image, num_samples=2,
                                                    generator=torch.Generator().manual_seed(0),
                                                    device="cpu")
    assert samples.shape == (2, 96, 80, 1) and mu.shape == logvar.shape == (32,)
    assert bool(((samples >= 0) & (samples <= 1)).all()) and not model.training
