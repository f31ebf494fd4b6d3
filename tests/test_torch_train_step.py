"""The port's train step (no accumulation) and eval step against the JAX
package on the CPU; set-up and tolerances in ``tests/torch_train_parity.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet
from vaeunet_tpu.training.step import make_eval_step as jax_make_eval_step
from vaeunet_tpu.training.step import make_train_step as jax_make_train_step

from vaeunet_tpu_torch.training import make_eval_step, make_train_step
from tests.torch_train_parity import (
    BETA,
    as_state_dict,
    assert_aux_matches,
    assert_grads_match,
    assert_state_matches,
    batch,
    feed_jax_noise,
    jax_grads,
    jax_state,
    jax_variables,
    port_state,
)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_train_step_matches_jax(monkeypatch):
    images, masks, eps = batch()
    feed_jax_noise(monkeypatch, eps)
    jcfg, jstate = jax_state(1)
    grads, _, ref_aux = jax_grads(jcfg, jstate.params, jstate.batch_stats, images, masks)
    ref_grads = as_state_dict(grads, jstate.batch_stats)
    new_jstate, jaux = jax_make_train_step(jcfg)(jstate, images, masks, jnp.float32(BETA))

    cfg, state = port_state(1)
    aux = make_train_step(cfg, state.model).compute_gradients(state, images, masks, BETA,
                                                               eps=eps[None])
    assert_aux_matches(aux, ref_aux)
    assert_grads_match(state.model, ref_grads)

    cfg, state = port_state(1)
    state, aux = make_train_step(cfg, state.model)(state, images, masks, BETA, eps=eps[None])
    assert state.step == 1
    assert_aux_matches(aux, jaux)
    assert_state_matches(state.model, as_state_dict(new_jstate.params, new_jstate.batch_stats))


@pytest.mark.parametrize("mask_hw", [(64, 64), (48, 40)])
def test_eval_step_matches_jax(monkeypatch, mask_hw):
    """Running-statistics BN, a sampled z (fed the same eps), metrics on raw
    logits with a `valid` row mask; masks of another size resize the
    logits.  Predictions may differ only where a logit lies within 1e-4 of
    the 0.5 threshold."""
    images, masks, eps = batch(4)
    masks = masks[:, :mask_hw[0], :mask_hw[1]]
    valid = np.array([1.0, 0.0], np.float32)
    feed_jax_noise(monkeypatch, eps)
    jcfg, _ = jax_state(1)
    variables = jax.tree.map(jnp.asarray, jax_variables())
    ref_metrics, ref_logits = jax_make_eval_step(jcfg, JaxUNetResNet(3, 1, backbone="resnet18"))(
        variables, jnp.asarray(images), jnp.asarray(masks), jax.random.PRNGKey(0),
        jnp.asarray(valid))
    cfg, state = port_state(1)
    metrics, logits = make_eval_step(cfg, state.model)(images, masks, eps=eps, valid=valid)
    ref_logits = np.asarray(ref_logits)
    assert logits.shape == ref_logits.shape == (2, *mask_hw, 1)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=5e-4)
    disagree = (logits.numpy() > 0.5) != (ref_logits > 0.5)
    assert (np.abs(ref_logits[disagree] - 0.5) < 1e-4).all()
    assert sorted(metrics) == sorted(ref_metrics)
    if not disagree.any():
        for k in metrics:
            np.testing.assert_allclose(metrics[k].item(), float(ref_metrics[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert not state.model.training
