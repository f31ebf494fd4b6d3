"""The port's train step with gradient accumulation against the JAX package
on the CPU (set-up and tolerances in ``tests/torch_train_parity.py``), its
optimizer against optax, and the bf16 step on the CPU."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from vaeunet_tpu.training.step import make_train_step as jax_make_train_step

from vaeunet_tpu_torch.training import (
    TrainConfig,
    create_train_state,
    get_learning_rate,
    make_eval_step,
    make_train_step,
    set_learning_rate,
)
from vaeunet_tpu_torch.training.state import ClippedAdamW
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
    port_state,
)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_accumulated_train_step_matches_jax(monkeypatch):
    """accum 2 over batch 4: two microbatches of 2, BN statistics threaded.
    The JAX ``lax.scan`` traces its body once, so both microbatches draw the
    same eps; the port is fed that block twice."""
    images, masks, eps = batch(6, n=4)
    feed_jax_noise(monkeypatch, eps)
    jcfg, jstate = jax_state(2)
    g1, stats, aux1 = jax_grads(jcfg, jstate.params, jstate.batch_stats, images[:2], masks[:2])
    g2, _, aux2 = jax_grads(jcfg, jstate.params, stats, images[2:], masks[2:])
    ref_grads = as_state_dict(jax.tree.map(lambda a, b: (a + b) / 2, g1, g2), jstate.batch_stats)
    ref_aux = {k: (aux1[k] + aux2[k]) / 2 for k in ("loss", "recon_loss", "kl_loss")}
    ref_aux.update({k: np.concatenate([aux1[k], aux2[k]]) for k in ("mu", "logvar")})
    new_jstate, jaux = jax_make_train_step(jcfg)(jstate, images, masks, jnp.float32(BETA))

    feed = np.stack([eps, eps])                      # [accum, micro, latent]
    cfg, state = port_state(2)
    aux = make_train_step(cfg, state.model).compute_gradients(state, images, masks, BETA,
                                                               eps=feed)
    assert_aux_matches(aux, ref_aux)
    assert_grads_match(state.model, ref_grads)

    cfg, state = port_state(2)
    state, aux = make_train_step(cfg, state.model)(state, images, masks, BETA, eps=feed)
    assert_aux_matches(aux, jaux)
    assert_state_matches(state.model, as_state_dict(new_jstate.params, new_jstate.batch_stats))
    with pytest.raises(ValueError, match="eps has shape"):
        make_train_step(cfg, state.model)(state, images, masks, BETA, eps=eps)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_and_adamw_follow_optax(scale):
    """optax.chain(clip_by_global_norm(1), adamw) on the same gradients for
    three steps, below and above the clip."""
    rng = np.random.RandomState(7)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * scale).astype(np.float32) for s in shapes] for _ in range(3)]
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=1e-2)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ClippedAdamW(tp, cfg)
    for step_grads in grads:
        updates, opt_state = tx.update([jnp.asarray(g) for g in step_grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), np.sqrt(sum((g ** 2).sum() for g in step_grads)),
                                   rtol=1e-6)
    for ours, ref in zip(tp, jp):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-6)


def test_bf16_step_on_the_cpu_updates_every_parameter():
    """amp: images cast to bf16, every layer in bf16, parameters and BN
    statistics fp32; every parameter receives a finite gradient.  An eval
    step first: what it caches under inference mode (the resize tables)
    must not break the training step after it."""
    cfg = TrainConfig(backbone="resnet18", batch_size=4, gradient_accumulation_steps=1,
                      amp=True, patch_size=32, learning_rate=1e-3)
    state = create_train_state(cfg, seed=0, device="cpu")
    assert get_learning_rate(state) == pytest.approx(1e-3)
    set_learning_rate(state, 5e-4)
    assert get_learning_rate(state) == pytest.approx(5e-4)
    rng = np.random.RandomState(8)
    images = rng.rand(4, 32, 32, 3).astype(np.float32)
    masks = (rng.rand(4, 32, 32, 1) > 0.9).astype(np.float32)
    make_eval_step(cfg, state.model)(images[:, :24, :20], masks[:, :24, :20],
                                     torch.Generator().manual_seed(0))
    state, aux = make_train_step(cfg, state.model)(state, images[:, :24, :20],
                                                   masks[:, :24, :20], BETA)
    assert np.isfinite(aux["loss"].item()) and aux["mu"].dtype == torch.float32
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert all(b.dtype in (torch.float32, torch.int64) for b in state.model.buffers())
