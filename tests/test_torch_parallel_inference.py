"""The port's sample-parallel ensemble and sharded tiled prediction
(``vaeunet_tpu_torch/parallel/inference.py``) on two gloo ranks on the CPU,
against JAX's ``ensemble_sample_parallel`` and ``predict_tiled_sharded``
on a 2-device mesh of the session's 8 CPU devices, with the same latents,
and against the port's one-rank decode and ``predict_with_patches``.

The weights are the port's seeded resnet34 with randomized BN statistics,
carried to JAX by ``convert_unet_resnet_state_dict`` (as
``tests/test_torch_inference.py`` does).  Bounds: against JAX atol 2e-4
on the probability maps (the serving slice's sample bound); against the
port's one-rank results atol 1e-5 (JAX's own sharded-vs-single bound).
The tile grid of the 112x112 image at patch 64 has 9 tiles, so the second
rank's share is padded with the last tile.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from vaeunet_tpu.compat.torch_weights import convert_unet_resnet_state_dict
from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet
from vaeunet_tpu.parallel.inference import (
    ensemble_sample_parallel as jax_ensemble_sample_parallel,
    predict_tiled_sharded as jax_predict_tiled_sharded,
)
from vaeunet_tpu.parallel.mesh import make_mesh as jax_make_mesh

from vaeunet_tpu_torch.inference import predict_with_patches
from vaeunet_tpu_torch.inference.tiled import compute_tile_grid
from vaeunet_tpu_torch.models import build_model
from vaeunet_tpu_torch.parallel import launch
from vaeunet_tpu_torch.parallel.inference import decode_samples
from tests import torch_dist_workers as workers

PATCH, N, LATENT = 64, 4, 32
MODEL = dict(backbone="resnet34", latent_injection="all", seed=0)


@pytest.fixture(autouse=True)
def _no_process_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    model = build_model(device="cpu", **MODEL)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    rng = np.random.RandomState(6)
    image = rng.rand(PATCH, PATCH, 3).astype(np.float32)
    zs = rng.randn(N, LATENT).astype(np.float32)
    tile_image = rng.rand(112, 112, 3).astype(np.float32)
    z = rng.randn(1, LATENT).astype(np.float32)
    return model, image, zs, tile_image, z


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    model, image, zs, tile_image, z = setup
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    return launch(workers.inference_checks, 2,
                  args=(dict(MODEL), sd, image, zs, tile_image, z, PATCH),
                  device="cpu", timeout=300, threads=2,
                  workdir=str(tmp_path_factory.mktemp("inference")))


@pytest.fixture(scope="module")
def jax_results(setup):
    model, image, zs, tile_image, z = setup
    variables = jax.tree.map(jnp.asarray, convert_unet_resnet_state_dict(model.state_dict()))
    mesh = jax_make_mesh(2, devices=jax.devices()[:2])
    jmodel = JaxUNetResNet(3, 1)
    ens = jax_ensemble_sample_parallel(jmodel, variables, jnp.asarray(image), jnp.asarray(zs),
                                       mesh)
    tiled = jax_predict_tiled_sharded(jmodel, variables, jnp.asarray(tile_image),
                                      jnp.asarray(z), mesh, patch_size=PATCH)
    return np.asarray(ens), np.asarray(tiled)


def test_the_grid_pads_a_rank(setup):
    assert len(compute_tile_grid(112, 112, PATCH)) % 2 == 1


@pytest.mark.parametrize("rank", [0, 1])
def test_ensemble_matches_jax(ranks, jax_results, rank):
    ours = ranks[rank]["ensemble"].numpy()
    assert ours.shape == jax_results[0].shape == (N, PATCH, PATCH, 1)
    np.testing.assert_allclose(ours, jax_results[0], atol=2e-4)


def test_ensemble_matches_the_one_rank_decode(setup, ranks):
    model, image, zs, _, _ = setup
    ref = decode_samples(model, image, zs, torch.device("cpu"))
    for out in ranks:
        torch.testing.assert_close(out["ensemble"], ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rank", [0, 1])
def test_tiled_sharded_matches_jax(ranks, jax_results, rank):
    ours = ranks[rank]["tiled"].numpy()
    assert ours.shape == jax_results[1].shape == (112, 112, 1)
    np.testing.assert_allclose(ours, jax_results[1], atol=2e-4)


def test_tiled_sharded_matches_predict_with_patches(setup, ranks):
    model, _, _, tile_image, z = setup
    ref = predict_with_patches(model, tile_image, torch.from_numpy(z), patch_size=PATCH,
                               batch_size=2, device="cpu")
    for out in ranks:
        torch.testing.assert_close(out["tiled"], ref, atol=1e-5, rtol=0)


def test_ranks_return_the_same_maps(ranks):
    for key in ("ensemble", "tiled"):
        assert torch.equal(ranks[0][key], ranks[1][key])


def test_samples_must_divide_over_the_data_axis(ranks):
    """As JAX's ``:47-49`` asserts: 3 samples over 2 ranks raise."""
    for out in ranks:
        assert "samples 3 not divisible by data axis 2" in out["refusal"]
