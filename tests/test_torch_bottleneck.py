"""The port's bottleneck backbones (resnet50/101, ``models/resnet.py``)
against the JAX package on the CPU: the block and the encoder at narrow
``stage_features``, the full-width resnet50 VAE-UNet at 64^2, and the
``conv3`` / ``bn3`` names of ``compat/jax_weights.py``.  Weights are a
seeded flax init with randomized batch statistics, carried into the port.

Bounds: features atol 1e-4; logits atol 5e-4, mu/logvar 1e-4, masks may
disagree only where |p - 0.5| < 1e-4; training-mode BN statistics 1e-5.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaeunet_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from vaeunet_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet

from vaeunet_tpu_torch.compat import jax_weights
from vaeunet_tpu_torch.models import ResNetEncoder, UNetResNet
from vaeunet_tpu_torch.models.resnet import BottleneckBlock
from vaeunet_tpu_torch.ops import _ext

NARROW = (8, 16, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def randomized(variables) -> dict:
    """numpy params and randomized batch statistics of a flax init."""
    rng = np.random.RandomState(2)

    def randomize(path, leaf):
        if path[-1].key == "mean":
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)

    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(randomize, variables["batch_stats"])}


def to_port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def port_state_dict(variables, prefix: str = "") -> dict:
    sd: dict = {}
    jax_weights._encoder(sd, variables["params"], variables["batch_stats"], prefix)
    return sd


def block_state_dict(variables) -> dict:
    """One block's flax tree in the port's names."""
    sd: dict = {}
    jax_weights._block(sd, variables["params"], variables["batch_stats"], "b")
    return {k[2:]: v for k, v in sd.items()}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cin,features,stride", [(16, 8, 1), (32, 8, 1), (32, 16, 2)])
def test_bottleneck_block_matches_jax(cin, features, stride, train):
    """1x1 - 3x3(s) - 1x1 x4 + identity or 1x1 downsample, eval BN or
    training BN (running statistics moved as JAX moves them)."""
    x = np.random.RandomState(1).randn(2, 12, 12, cin).astype(np.float32)
    jblock = JaxBottleneckBlock(features, stride)
    variables = randomized(jax.jit(lambda k: jblock.init(k, jnp.asarray(x)))(
        jax.random.PRNGKey(0)))
    block = BottleneckBlock(cin, features, stride).to(memory_format=torch.channels_last)
    result = block.load_state_dict(block_state_dict(variables), strict=False)
    assert result.unexpected_keys == [] and result.missing_keys == []
    assert (block.downsample is None) == (cin == 4 * features and stride == 1)
    block.train(train)
    if train:
        ref, upd = jblock.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        out = block(to_port(x))
        want = block_state_dict({"params": variables["params"],
                                 "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
        for k, v in block.state_dict().items():
            if "running_" in k:
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, rtol=1e-5,
                                           err_msg=k)
    else:
        ref = jblock.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=False)
        with torch.no_grad():
            out = block(to_port(x))
    assert out.shape == (2, 4 * features, 12 // stride, 12 // stride)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("backbone,sizes", [("resnet50", (3, 4, 6, 3)),
                                            ("resnet101", (3, 4, 23, 3))])
def test_encoder_matches_jax_at_narrow_widths(backbone, sizes):
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    jenc = JaxResNetEncoder(3, backbone=backbone, stage_features=NARROW)
    variables = randomized(jax.jit(lambda k: jenc.init(k, jnp.zeros((1, 32, 32, 3))))(
        jax.random.PRNGKey(0)))
    assert jax_weights.stage_sizes(variables["params"]) == sizes
    enc = ResNetEncoder(3, backbone=backbone, stage_features=NARROW).eval()
    enc = enc.to(memory_format=torch.channels_last)
    sd = port_state_dict(variables)
    assert set(sd) == set(enc.state_dict())
    assert sum(k.endswith("conv3.weight") for k in sd) == sum(sizes)
    enc.load_state_dict(sd)
    assert enc.feature_channels == jenc.feature_channels == [64, 32, 64, 64, 128]
    ref = jax.jit(lambda v, x: jenc.apply(v, x, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        feats = enc(to_port(x))
    for f, r, c in zip(feats, ref, enc.feature_channels):
        assert f.shape[1] == c and f.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(nhwc(f), np.asarray(r), atol=1e-4, rtol=0)


@functools.lru_cache(maxsize=None)
def resnet50_pair():
    """(port resnet50 UNetResNet, JAX variables), full widths."""
    jmodel = JaxUNetResNet(3, 1, backbone="resnet50")
    variables = randomized(jax.jit(lambda k: jmodel.init(
        {"params": k, "latent": k}, jnp.zeros((1, 32, 32, 3)), train=False, sample=False))(
        jax.random.PRNGKey(0)))
    model = UNetResNet(3, 1, backbone="resnet50").eval().to(memory_format=torch.channels_last)
    assert jax_weights.load_jax_variables(model, variables) == []
    return model, variables


def test_resnet50_decoder_plan_and_names():
    """The decoder's plan from the encoder's channels (JAX
    ``vae_unet.py:282-295``): a 2048-wide ``z_initial``, first conv 2048 +
    1024 + 32 = 3104 in; every name of the port's state dict comes from the
    flax tree, ``conv3`` / ``bn3`` included."""
    model, variables = resnet50_pair()
    assert model.encoder.feature_channels == [64, 256, 512, 1024, 2048]
    assert model.z_initial[0].out_channels == 2048
    assert [b.conv1[0].in_channels for b in model.decoder_blocks] == [3104, 1056, 544, 224]
    assert [b.conv1[0].out_channels for b in model.decoder_blocks] == [512, 256, 128, 64]
    sd = jax_weights.convert_jax_unet_resnet(variables)
    assert set(sd) == set(model.state_dict())
    assert "encoder.layer3.22.conv3.weight" not in sd
    assert sd["encoder.layer4.2.bn3.running_var"].shape == (2048,)


def test_resnet50_forward_matches_jax():
    model, variables = resnet50_pair()
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    ref_logits, ref_mu, ref_logvar = jax.jit(
        lambda v, x: JaxUNetResNet(3, 1, backbone="resnet50").apply(
            v, x, train=False, sample=False))(jax.tree.map(jnp.asarray, variables),
                                              jnp.asarray(x))
    with torch.no_grad():
        logits, mu, logvar = model(to_port(x), sample=False)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(ref_logvar), atol=1e-4)
    logits, ref_logits = nhwc(logits), np.asarray(ref_logits)
    np.testing.assert_allclose(logits, ref_logits, atol=5e-4, rtol=0)
    p, p_ref = 1 / (1 + np.exp(-logits)), 1 / (1 + np.exp(-ref_logits))
    disagree = (p > 0.5) != (p_ref > 0.5)
    assert (np.abs(p_ref[disagree] - 0.5) < 1e-4).all()


def test_resnet50_training_forward_routes_stride1_convs_to_the_kernel(monkeypatch):
    """13 bottleneck conv2s of stride 1 plus the 8 decoder convs take the
    fused conv + moments wrapper in a training forward: 21, the count
    ``chip_smoke.py`` holds the card to."""
    from vaeunet_tpu_torch.ops.pallas import conv_bn_stats

    calls = []
    real = conv_bn_stats._Conv3x3BnStats.apply

    def counting(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(conv_bn_stats._Conv3x3BnStats, "apply", counting)
    model = copy.deepcopy(resnet50_pair()[0]).train()
    x = to_port(np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32))
    _ext.reset_launch_counts()
    logits, _, _ = model(x, sample=False)
    assert len(calls) == 21
    assert calls.count((2, 3104, 4, 4)) == 1
    assert _ext.launch_counts()["conv_bn_stats"] == 0      # the CPU takes the plain version
