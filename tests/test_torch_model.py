"""The port's ResNet encoder and VAE-UNet against the JAX package on the CPU,
on one set of weights carried across both ways:

- resnet34 ('all', the flagship): the port's seeded weights, with
  randomized BN statistics, go to JAX through
  ``vaeunet_tpu.compat.torch_weights.convert_unet_resnet_state_dict``;
- resnet18 (the other strategies): a seeded flax init with randomized
  ``batch_stats`` comes to the port through ``compat/jax_weights``.

Bounds: logits atol 5e-4, mu/logvar 1e-4, masks may disagree only where
|p - 0.5| < 1e-4; both JAX decoder lowerings (fused_decoder True/False).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaeunet_tpu.compat.torch_weights import convert_unet_resnet_state_dict
from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet
from vaeunet_tpu.models.vae_unet import resolve_injection as jax_resolve_injection

from vaeunet_tpu_torch import build_model, capture_attention
from vaeunet_tpu_torch.compat.jax_weights import (
    convert_jax_unet_resnet,
    load_jax_variables,
    stage_sizes,
)
from vaeunet_tpu_torch.models.vae_unet import UNetResNet, resolve_injection
from vaeunet_tpu_torch.ops.pallas.reparam import normal_plain
from vaeunet_tpu_torch.ops.sampling import seed_from_generator

STRATEGIES = ["all", "first", "last", "bottleneck", "inject_no_bottleneck", "none"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def randomize_bn_stats(model: torch.nn.Module, seed: int = 0) -> None:
    """Fresh (0, 1) running statistics would hide a mapping bug."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)


def image(seed: int = 0, hw=(64, 64), batch: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).randn(batch, *hw, 3).astype(np.float32)


def to_port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def resnet34_pair():
    """(port model, JAX variables) on the port's weights."""
    model = build_model(backbone="resnet34", latent_injection="all", seed=0, device="cpu")
    randomize_bn_stats(model, seed=1)
    variables = jax.tree.map(jnp.asarray, convert_unet_resnet_state_dict(model.state_dict()))
    return model, variables


@functools.lru_cache(maxsize=None)
def resnet18_pair(injection: str):
    """(port model, JAX variables) on a seeded flax init."""
    jmodel = JaxUNetResNet(3, 1, backbone="resnet18", latent_injection=injection)
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 64, 64, 3)), train=False)
    rng = np.random.RandomState(2)

    def randomize(path, leaf):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.normal(0, 0.5, leaf.shape).astype(np.float32))
        return jnp.asarray(rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32))

    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map_with_path(
                     randomize, variables["batch_stats"])}
    model = UNetResNet(3, 1, backbone="resnet18", latent_injection=injection).eval()
    missing = load_jax_variables(model, jax.tree.map(np.asarray, variables))
    assert all(k.startswith("z_initial.") for k in missing), missing
    return model.to(memory_format=torch.channels_last), variables


def pair(injection: str):
    return resnet34_pair() if injection == "all" else resnet18_pair(injection)


def assert_masks_agree(logits: np.ndarray, ref_logits: np.ndarray) -> None:
    p = 1 / (1 + np.exp(-logits))
    p_ref = 1 / (1 + np.exp(-ref_logits))
    disagree = (p > 0.5) != (p_ref > 0.5)
    assert (np.abs(p_ref[disagree] - 0.5) < 1e-4).all()


def test_encoder_features_match_jax():
    model, variables = resnet34_pair()
    x = image(3)
    ref = JaxUNetResNet(3, 1).apply(variables, jnp.asarray(x), False,
                                    method=lambda m, x, t: m.encoder(x, train=t))
    with torch.no_grad():
        ours = model.encoder(to_port(x))
    assert [tuple(f.shape) for f in ours] == [
        (2, c, h, h) for c, h in zip([64, 64, 128, 256, 512], [32, 16, 8, 4, 2])]
    for f, r in zip(ours, ref):
        assert f.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), np.asarray(r), atol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("injection", STRATEGIES)
def test_forward_matches_jax(injection, fused):
    model, variables = pair(injection)
    backbone = "resnet34" if injection == "all" else "resnet18"
    x = image(4)
    jmodel = JaxUNetResNet(3, 1, backbone=backbone, latent_injection=injection,
                           fused_decoder=fused)
    ref_logits, ref_mu, ref_logvar = jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False, sample=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        logits, mu, logvar = model(to_port(x), sample=False)
    logits = logits.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(ref_logvar), atol=1e-4)
    np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=5e-4, rtol=0)
    assert_masks_agree(logits, np.asarray(ref_logits))


def test_weight_carry_over_is_lossless():
    """port state_dict -> JAX tree -> compat/jax_weights: identical tensors."""
    model, _ = resnet34_pair()
    sd = model.state_dict()
    back = convert_jax_unet_resnet(convert_unet_resnet_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.cpu()), k
    assert stage_sizes(convert_unet_resnet_state_dict(sd)["params"]["encoder"]) == (3, 4, 6, 3)
    assert stage_sizes(resnet18_pair("first")[1]["params"]["encoder"]) == (2, 2, 2, 2)


@pytest.mark.parametrize("spec", STRATEGIES + [(0, 2), [1], "no-such-strategy"])
def test_resolve_injection_matches_jax(spec):
    assert resolve_injection(spec) == jax_resolve_injection(spec)


def test_attention_maps_match_jax_sow():
    model, variables = resnet34_pair()
    x = image(5)
    _, state = JaxUNetResNet(3, 1, fused_decoder=False).apply(
        variables, jnp.asarray(x), train=False, sample=False, mutable=["intermediates"])
    with torch.no_grad(), capture_attention(model) as maps:
        model(to_port(x), sample=False)
    assert sorted(maps) == [f"decoder_blocks.{i}" for i in range(4)]
    for i in range(4):
        ref = np.asarray(state["intermediates"][f"decoder_{i}"]["attention"]["psi"][0])
        np.testing.assert_allclose(maps[f"decoder_blocks.{i}"].permute(0, 2, 3, 1).numpy(),
                                   ref, atol=1e-4)
    with torch.no_grad():
        model(to_port(x), sample=False)
    assert len(maps) == 4          # hooks are gone after the block


def test_decode_zero_probe_matches_jax():
    model, variables = resnet34_pair()
    z = np.random.RandomState(6).randn(2, 32).astype(np.float32)
    ref = JaxUNetResNet(3, 1).apply(variables, jnp.asarray(z), (40, 40), (64, 64), False,
                                    method=JaxUNetResNet.decode)
    with torch.no_grad():
        ours = model.decode(torch.from_numpy(z), input_size=(40, 40), probe_hw=(64, 64))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=5e-4)


def test_sampled_forward_draws_from_the_generator():
    """forward(sample) = decode(mu + eps * std), eps the noise kernel's plain
    stream under the generator's next seed; a fixed generator repeats."""
    model, _ = resnet34_pair()
    x = to_port(image(7, batch=1))
    with torch.no_grad():
        a, mu, logvar = model(x, generator=torch.Generator().manual_seed(3))
        b, _, _ = model(x, generator=torch.Generator().manual_seed(3))
        c, _, _ = model(x, generator=torch.Generator().manual_seed(4))
        seed = seed_from_generator(torch.Generator().manual_seed(3))
        z = mu + normal_plain(mu.shape, seed) * torch.exp(0.5 * logvar)
        ref = model.decode_features(z, model.encoder(x), output_hw=(64, 64))
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(a, ref, atol=1e-6, rtol=0)
