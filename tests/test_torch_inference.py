"""The port's serving path against the JAX package on the CPU, on the same
resnet34 weights (carried to JAX by ``convert_unet_resnet_state_dict``)
and the same noise: ``jax.random.normal`` draws the eps that the JAX call
draws from its key, and the port takes it through ``eps=``.

Bounds: samples atol 2e-4, mu/logvar 1e-4, uncertainty mean/std 2e-4,
entropy/mutual information 1e-3, masks as in the model tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaeunet_tpu.inference.predict import (
    predict_full_image as jax_predict_full_image,
    predict_image as jax_predict_image,
    segmentation_distribution as jax_segmentation_distribution,
    uncertainty_maps as jax_uncertainty_maps,
)
from vaeunet_tpu.inference.tiled import predict_with_patches as jax_predict_with_patches
from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet
from vaeunet_tpu.vae_utils import (
    calculate_latent_stats as jax_latent_stats,
    generate_predictions as jax_generate_predictions,
)

from tests.test_torch_model import assert_masks_agree, resnet34_pair
from vaeunet_tpu_torch.inference import (
    predict_full_image,
    predict_image,
    predict_with_patches,
    segmentation_distribution,
    uncertainty_maps,
)
from vaeunet_tpu_torch.vae_utils import calculate_latent_stats, generate_predictions

JAX_MODEL = JaxUNetResNet(3, 1)
D = 32


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def fundus(h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


@pytest.mark.parametrize("hw,patch,tile_batch,n", [
    ((64, 64), None, 8, 3),      # untiled
    ((96, 80), 64, 3, 2),        # 4 tiles, batches of 3: the last padded
])
def test_segmentation_distribution_matches_jax(hw, patch, tile_batch, n):
    model, variables = resnet34_pair()
    img = fundus(*hw)
    key = jax.random.PRNGKey(7)
    ref_samples, ref_mu, ref_logvar = jax_segmentation_distribution(
        JAX_MODEL, variables, jnp.asarray(img), key, n, 1.0, patch, tile_batch)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (n, 1, D))))
    samples, mu, logvar = segmentation_distribution(
        model, img, num_samples=n, temperature=1.0, patch_size=patch,
        tile_batch=tile_batch, eps=eps, device="cpu")
    assert samples.shape == (n, *hw, 1)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(ref_logvar), atol=1e-4)
    np.testing.assert_allclose(samples.numpy(), np.asarray(ref_samples), atol=2e-4)

    maps = uncertainty_maps(samples)
    ref_maps = jax_uncertainty_maps(ref_samples)
    for k, atol in (("mean", 2e-4), ("std", 2e-4), ("entropy", 1e-3),
                    ("mutual_info", 1e-3)):
        np.testing.assert_allclose(maps[k].numpy(), np.asarray(ref_maps[k]), atol=atol,
                                   err_msg=k)


def test_uncertainty_maps_match_jax_on_the_same_samples():
    samples = np.random.RandomState(1).rand(5, 12, 9, 1).astype(np.float32)
    samples[:, 0, 0] = 0.0                    # the eps clip at p = 0
    ours = uncertainty_maps(torch.from_numpy(samples))
    ref = jax_uncertainty_maps(jnp.asarray(samples))
    assert sorted(ours) == sorted(ref)
    for k in ref:   # std is the population std (ddof 0), as jnp.std
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_predict_image_matches_jax():
    model, variables = resnet34_pair()
    img = fundus(64, 48, seed=2)
    ref_probs, ref_mask = jax_predict_image(JAX_MODEL, variables, jnp.asarray(img))
    probs, mask = predict_image(model, img, device="cpu")
    assert probs.shape == (64, 48, 1) and mask.dtype == torch.bool
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs), atol=1e-4)
    logit = lambda p: np.log(p) - np.log1p(-p)   # noqa: E731
    assert_masks_agree(logit(probs.numpy().astype(np.float64)),
                       logit(np.asarray(ref_probs).astype(np.float64)))
    disagree = mask.numpy() != np.asarray(ref_mask)
    assert (np.abs(np.asarray(ref_probs)[disagree] - 0.5) < 1e-4).all()
    # a generator turns sampling on and repeats with its state
    a, _ = predict_image(model, img, generator=torch.Generator().manual_seed(1), device="cpu")
    b, _ = predict_image(model, img, generator=torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, probs)


def test_predict_full_image_and_patches_match_jax():
    model, variables = resnet34_pair()
    img = fundus(96, 80, seed=3)
    z = np.random.RandomState(4).randn(1, D).astype(np.float32)
    ref_full = jax_predict_full_image(JAX_MODEL, variables, jnp.asarray(img), jnp.asarray(z))
    full = predict_full_image(model, img, torch.from_numpy(z), device="cpu")
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full), atol=2e-4)
    ref_tiled = jax_predict_with_patches(JAX_MODEL, variables, jnp.asarray(img),
                                         jnp.asarray(z), 64, None, 2)
    tiled = predict_with_patches(model, img, torch.from_numpy(z), 64, batch_size=2,
                                 device="cpu")
    np.testing.assert_allclose(tiled.numpy(), np.asarray(ref_tiled), atol=2e-4)


def test_generate_predictions_and_latent_stats_match_jax():
    model, variables = resnet34_pair()
    imgs = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    key = jax.random.PRNGKey(8)
    ref = jax.jit(jax_generate_predictions, static_argnums=(0, 5))(
        JAX_MODEL, variables, jnp.asarray(imgs), key, 1.5, 3)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (3, 2, D))))
    ours = generate_predictions(model, torch.from_numpy(imgs), None, temperature=1.5,
                                num_samples=3, eps=eps)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-4)

    mu = np.random.RandomState(6).randn(8, D).astype(np.float32)
    logvar = np.random.RandomState(7).randn(8, D).astype(np.float32) * 0.3
    ref_stats = jax_latent_stats(jnp.asarray(mu), jnp.asarray(logvar))
    stats = calculate_latent_stats(torch.from_numpy(mu), torch.from_numpy(logvar))
    for k in ref_stats:
        np.testing.assert_allclose(float(stats[k]), float(ref_stats[k]), rtol=1e-5, err_msg=k)


def test_segmentation_distribution_draws_from_the_generator():
    """Without eps, the N latents come from one fused draw under the
    generator's next seed: the same samples as feeding that draw's noise."""
    from vaeunet_tpu_torch.ops.pallas.reparam import normal_plain
    from vaeunet_tpu_torch.ops.sampling import seed_from_generator

    model, _ = resnet34_pair()
    img = fundus(64, 64, seed=9)
    samples, _, _ = segmentation_distribution(model, img, torch.Generator().manual_seed(5),
                                              num_samples=2, temperature=0.7, device="cpu")
    seed = seed_from_generator(torch.Generator().manual_seed(5))
    eps = normal_plain((2, D), seed).view(2, 1, D)
    ref, _, _ = segmentation_distribution(model, img, num_samples=2, temperature=0.7,
                                          eps=eps, device="cpu")
    torch.testing.assert_close(samples, ref, atol=1e-6, rtol=0)
    assert not torch.equal(samples[0], samples[1])
