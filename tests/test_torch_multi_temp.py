"""The port's ``multi_temp_training_step`` (JAX ``step.py:201-229``) and
the two metrics of ``metrics.py:66-80`` against the JAX package on the
CPU, on the parity harness's weights (``tests/torch_train_parity.py``)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import vaeunet_tpu.ops.sampling as jax_sampling
import vaeunet_tpu.vae_utils as jax_vae_utils
from vaeunet_tpu import metrics as jax_metrics
from vaeunet_tpu.training.state import build_model as jax_build_model
from vaeunet_tpu.training.step import multi_temp_training_step as jax_multi_temp

from vaeunet_tpu_torch import metrics
from vaeunet_tpu_torch.training import multi_temp_training_step
from tests.torch_train_parity import jax_state, port_state


def test_multi_temp_training_step_matches_jax(monkeypatch):
    """Same weights (the parity harness's resnet18), batch (32^2) and noise
    on both sides; the losses within the harness's loss bound, and the
    port's total is differentiable."""
    rng = np.random.RandomState(4)
    images = rng.rand(2, 32, 32, 3).astype(np.float32)
    masks = (rng.rand(2, 32, 32, 1) > 0.9).astype(np.float32)
    noise = [rng.randn(2, 32).astype(np.float32), rng.randn(3, 2, 32).astype(np.float32),
             rng.randn(3, 2, 32).astype(np.float32)]
    feed = iter(noise)

    def gaussian_like(rng_key, shape, dtype=jnp.float32):
        e = next(feed)
        assert e.shape == tuple(shape)
        return jnp.asarray(e, dtype)

    monkeypatch.setattr(jax_sampling, "gaussian_like", gaussian_like)
    monkeypatch.setattr(jax_vae_utils, "gaussian_like", gaussian_like)
    jcfg, jstate = jax_state(1)
    model = jax_build_model(jcfg)
    # jitted (the noise feed runs once, while tracing): eager, each layer
    # dispatches on its own
    jtotal, jparts = jax.jit(lambda v, x, m: jax_multi_temp(jcfg, model, v, x, m,
                                                            jax.random.PRNGKey(0)))(
        jstate.variables(), jnp.asarray(images), jnp.asarray(masks))
    cfg, state = port_state(1)
    total, parts = multi_temp_training_step(cfg, state.model, images, masks, None,
                                            eps=[torch.from_numpy(e) for e in noise])
    for ours, theirs in ((total, jtotal), (parts["standard_loss"], jparts["standard_loss"]),
                         (parts["multi_temp_loss"], jparts["multi_temp_loss"])):
        np.testing.assert_allclose(ours.item(), float(theirs), atol=1e-5, rtol=2e-6)
    total.backward()
    assert state.model.final_conv.weight.grad is not None


def test_new_metrics_equal_jax():
    rng = np.random.RandomState(5)
    pred = rng.randn(3, 5, 16, 16).astype(np.float32)
    target = (rng.rand(3, 5, 16, 16) > 0.6).astype(np.float32)
    pred[1] = -10.0                                     # an empty prediction
    for sig in (False, True):
        np.testing.assert_allclose(
            metrics.multiclass_dice_score(torch.from_numpy(pred), torch.from_numpy(target),
                                          apply_sigmoid=sig).item(),
            float(jax_metrics.multiclass_dice_score(jnp.asarray(pred), jnp.asarray(target),
                                                    apply_sigmoid=sig)), rtol=1e-6)
    for mc in (False, True):
        np.testing.assert_allclose(
            metrics.dice_loss_metric(torch.from_numpy(pred), torch.from_numpy(target),
                                     multiclass=mc).item(),
            float(jax_metrics.dice_loss_metric(jnp.asarray(pred), jnp.asarray(target),
                                               multiclass=mc)), rtol=1e-6)
