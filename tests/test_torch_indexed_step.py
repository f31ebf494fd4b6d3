"""The port's indexed train step (``augment=False``) on a uint8 image
cache against the JAX package's ``make_train_step(indexed=True)`` with the
same record gather, weights and noise, on the CPU; set-up and bounds in
``tests/torch_train_parity.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vaeunet_tpu.data import device_cache as jax_cache
from vaeunet_tpu.training.step import make_train_step as jax_make_train_step

from vaeunet_tpu_torch.data.device_cache import gather_patch_records_device
from vaeunet_tpu_torch.training import make_train_step
from tests.torch_train_parity import (
    BETA,
    HW,
    as_state_dict,
    assert_aux_matches,
    assert_state_matches,
    feed_jax_noise,
    jax_state,
    port_state,
)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def cpu(x):
    return torch.from_numpy(np.asarray(x))


def test_indexed_train_step_matches_jax(monkeypatch):
    """``augment=False``: the indexed step on a uint8 image cache against
    JAX's ``make_train_step(indexed=True)`` with the same record gather,
    weights and noise; the harness's bounds."""
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (3, HW + 16, HW + 8, 3)).astype(np.uint8)
    masks = (rng.rand(3, HW + 16, HW + 8) > 0.9).astype(np.uint8)
    rec = np.array([[2, 16, 8], [0, 3, 0]], np.int64)
    eps = rng.randn(2, 32).astype(np.float32)
    feed_jax_noise(monkeypatch, eps)
    jcfg, jstate = jax_state(1)

    def jax_gather(di, dm, r):
        return jax_cache.gather_patch_records_device(di, dm, r, HW)

    jstep = jax_make_train_step(jcfg, indexed=True, gather=jax_gather)
    new_jstate, jaux = jstep(jstate, jnp.asarray(images), jnp.asarray(masks), jnp.asarray(rec),
                             jnp.float32(BETA))

    cfg, state = port_state(1)

    def gather(di, dm, r):
        return gather_patch_records_device(di, dm, r, HW)

    step = make_train_step(cfg, state.model, indexed=True, gather=gather)
    state, aux = step(state, cpu(images), cpu(masks), rec, BETA, eps=eps[None])
    assert state.step == 1
    assert_aux_matches(aux, jaux)
    assert_state_matches(state.model, as_state_dict(new_jstate.params, new_jstate.batch_stats))
