"""The port's data-parallel steps (``vaeunet_tpu_torch/parallel/dp.py``) on
two gloo ranks on the CPU, against the JAX package and against the port's
own one-rank step; set-up and tolerances in ``tests/torch_train_parity.py``
(resnet18 VAE-UNet, 64^2, fp32, a global batch of 4: 2 rows a rank).

The JAX reference of the global-batch step is JAX's single-device step on
the global batch: JAX's own ``test_dp_pjit_matches_single_device`` shows
that its pjit step over a mesh computes that step, and a 2-device pjit
compile of the train step here would double this file's time.  The eval
step is held against JAX's ``make_dp_eval_step`` on a 2-device mesh of the
session's 8 CPU devices.  The per-device step is held against its hand
split (JAX ``test_dp_explicit_matches_hand_split_reference``), computed
with the port's one-rank step on each half.

The ranks run in fresh processes (``parallel.launch``, a FileStore in
``tmp_path``); their bodies are in ``tests/torch_dist_workers.py``.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet
from vaeunet_tpu.parallel.dp import make_dp_eval_step as jax_make_dp_eval_step
from vaeunet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vaeunet_tpu.parallel.mesh import shard_batch as jax_shard_batch
from vaeunet_tpu.training.config import TrainConfig as JaxTrainConfig
from vaeunet_tpu.training.state import create_train_state as jax_create_train_state
from vaeunet_tpu.training.step import make_train_step as jax_make_train_step

from vaeunet_tpu_torch.parallel import launch
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step
from tests import torch_dist_workers as workers
from tests.torch_train_parity import (
    BETA,
    HW,
    LATENT,
    as_state_dict,
    assert_aux_matches,
    assert_grads_match,
    assert_state_matches,
    config_kwargs,
    feed_jax_noise,
    jax_grads,
    jax_variables_jit as jax_variables,
)

WORLD, GLOBAL, ACCUM = 2, 4, 2
# the ranks' and this process's torch threads: the per-device step is held
# to its hand split at 1e-5, and convolutions round by their thread count
THREADS = 2


@pytest.fixture(autouse=True)
def _no_process_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(prev)


def _cfg_kwargs(accum: int = 1) -> dict:
    return dict(config_kwargs(accum), batch_size=GLOBAL // accum)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(3)
    images = rng.rand(GLOBAL, HW, HW, 3).astype(np.float32)
    masks = (rng.rand(GLOBAL, HW, HW, 1) > 0.9).astype(np.float32)
    eps = rng.randn(1, GLOBAL, LATENT).astype(np.float32)
    e_images = rng.rand(GLOBAL, HW, HW, 3).astype(np.float32)
    e_masks = (rng.rand(GLOBAL, HW, HW, 1) > 0.8).astype(np.float32)
    e_eps = rng.randn(GLOBAL, LATENT).astype(np.float32)
    valid = np.array([1.0, 1.0, 1.0, 0.0], np.float32)       # a ragged last batch
    return images, masks, eps, (e_images, e_masks, e_eps, valid)


def _port_state(seed: int = 0):
    config = TrainConfig(**_cfg_kwargs())
    return config, create_train_state(config, seed=seed, variables=jax_variables(), device="cpu")


@pytest.fixture(scope="module")
def rank_run(data, tmp_path_factory):
    """The two ranks' launches (the steps; the step with accumulation),
    started in the background so that they run while this process computes
    the references: futures of their results."""
    images, masks, eps, eval_batch = data
    _, state = _port_state()
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    with ThreadPoolExecutor(2) as pool:
        future = pool.submit(launch, workers.dp_steps, WORLD,
                             args=(_cfg_kwargs(), sd, images, masks, eps, BETA, eval_batch),
                             device="cpu", timeout=300, threads=THREADS,
                             workdir=str(tmp_path_factory.mktemp("dp")))
        accum = pool.submit(launch, workers.dp_accum_step, WORLD,
                            args=(_cfg_kwargs(ACCUM), sd, images, masks,
                                  eps.reshape(ACCUM, GLOBAL // ACCUM, -1), BETA),
                            device="cpu", timeout=300, threads=THREADS,
                            workdir=str(tmp_path_factory.mktemp("dp_accum")))
        yield {"steps": future, "accum": accum}
        future.result()
        accum.result()


@pytest.fixture
def ranks(rank_run, one_rank, jax_reference, jax_eval, hand_split):
    """The ranks' results, once every reference is computed."""
    return rank_run["steps"].result()


def _as_model(sd: dict):
    return types.SimpleNamespace(state_dict=lambda: sd)


@pytest.fixture(scope="module")
def one_rank(data):
    """The port's single-process step on the global batch."""
    images, masks, eps, _ = data
    config, state = _port_state()
    state, aux = make_train_step(config, state.model)(state, images, masks, BETA, eps=eps)
    return aux, state.model.state_dict()


@pytest.fixture(scope="module")
def jax_reference(data):
    """JAX's single-device step on the global batch, and its gradient."""
    images, masks, eps, _ = data
    with pytest.MonkeyPatch.context() as mp:
        feed_jax_noise(mp, eps[0])
        jcfg = JaxTrainConfig(**_cfg_kwargs())
        jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(0),
                                        variables=jax.tree.map(jnp.asarray, jax_variables()))
        grads, _, grad_aux = jax_grads(jcfg, jstate.params, jstate.batch_stats, images, masks)
        grads = as_state_dict(grads, jstate.batch_stats)      # before the step donates jstate
        new, aux = jax_make_train_step(jcfg)(jstate, images, masks, jnp.float32(BETA))
    return grads, grad_aux, aux, as_state_dict(new.params, new.batch_stats)


@pytest.mark.parametrize("rank", range(WORLD))
def test_global_step_matches_the_one_rank_step(ranks, one_rank, rank):
    """Global-batch BN and loss over the ranks: the step of one rank on the
    whole batch, within the harness bounds."""
    aux, sd = one_rank
    assert_aux_matches(ranks[rank]["global_aux"], aux)
    assert_state_matches(_as_model(ranks[rank]["global_state"]), sd)


@pytest.mark.parametrize("rank", range(WORLD))
def test_global_step_matches_jax(ranks, jax_reference, rank):
    _, _, aux, sd = jax_reference
    assert_aux_matches(ranks[rank]["global_aux"], aux)
    assert_state_matches(_as_model(ranks[rank]["global_state"]), sd)


@pytest.mark.parametrize("rank", range(WORLD))
def test_global_gradient_matches_jax_grad(ranks, jax_reference, rank):
    """The averaged gradient is the global batch's: held as the harness
    holds the one-rank step's against ``jax.grad``."""
    grads, grad_aux, _, _ = jax_reference
    _, state = _port_state()
    for name, p in state.model.named_parameters():
        p.grad = ranks[rank]["global_grads"].get(name)
    assert_aux_matches(ranks[rank]["global_grad_aux"], grad_aux)
    assert_grads_match(state.model, grads)


def test_global_step_with_accumulation_matches_the_one_rank_step(data, rank_run):
    """Accumulation 2 over a global batch of 4: each rank holds its share
    of both microbatches, so microbatch i of the ranks together is the
    one-rank step's microbatch i (its BN statistics threaded through them)."""
    images, masks, eps, _ = data
    config = TrainConfig(**_cfg_kwargs(ACCUM))
    state = create_train_state(config, seed=0, variables=jax_variables(), device="cpu")
    state, aux = make_train_step(config, state.model)(
        state, images, masks, BETA, eps=eps.reshape(ACCUM, GLOBAL // ACCUM, -1))
    for out in rank_run["accum"].result():
        assert_aux_matches(out["aux"], aux)
        assert_state_matches(_as_model(out["state"]), state.model.state_dict())


@pytest.mark.parametrize("key", ["global_state", "augment_state", "explicit_state"])
def test_ranks_hold_the_same_weights(ranks, key):
    """After a step every rank holds the same parameters and statistics,
    bit for bit (one all-reduce result on all ranks)."""
    a, b = ranks[0][key], ranks[1][key]
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]


def test_augmented_global_step_matches_the_one_rank_step(data, ranks):
    """With the augmentation and the latent noise drawn from the state's
    generator: the ranks draw the global batch's parameters and noise and
    keep their rows, so the step is the one-rank step's on the same
    generator."""
    images, masks, _, _ = data
    config, state = _port_state(seed=5)
    state, aux = make_train_step(config, state.model, augment=True)(state, images, masks, BETA)
    for r in range(WORLD):
        assert_aux_matches(ranks[r]["augment_aux"], aux)
        assert_state_matches(_as_model(ranks[r]["augment_state"]), state.model.state_dict())


@pytest.fixture(scope="module")
def hand_split(data):
    """Per-half gradients and BN statistics of the one-rank step, averaged,
    then one optimizer step from the mean gradient."""
    images, masks, eps, _ = data
    half = GLOBAL // WORLD
    grads, stats, losses = [], [], []
    config = None
    for r in range(WORLD):
        rows = slice(r * half, (r + 1) * half)
        config, state = _port_state()
        step = make_train_step(config, state.model)
        aux = step.compute_gradients(state, images[rows], masks[rows], BETA,
                                     eps=eps[:, rows])
        grads.append({k: p.grad.clone() for k, p in state.model.named_parameters()})
        stats.append({k: v.clone() for k, v in state.model.state_dict().items()
                      if "running_" in k})
        losses.append(aux["loss"])
    config, state = _port_state()
    for k, p in state.model.named_parameters():
        p.grad = (grads[0][k] + grads[1][k]) / 2
    state.optimizer.step()
    sd = state.model.state_dict()
    sd.update({k: (stats[0][k] + stats[1][k]) / 2 for k in stats[0]})
    return (losses[0] + losses[1]) / 2, sd


@pytest.mark.parametrize("rank", range(WORLD))
def test_explicit_step_matches_the_hand_split(ranks, hand_split, rank):
    """Per-device BN (torch DDP's semantics): the mean of the per-half
    gradients and statistics, as JAX's hand-split test holds them (loss
    1e-6, statistics 1e-6, parameters 1e-5)."""
    loss, sd = hand_split
    got = ranks[rank]["explicit_state"]
    assert ranks[rank]["explicit_aux"]["loss"].item() == pytest.approx(loss.item(), abs=1e-6)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = 1e-6 if "running_" in k else 1e-5
        torch.testing.assert_close(got[k], v, atol=tol, rtol=0, msg=k)
    assert ranks[rank]["explicit_aux"]["mu"].shape == (GLOBAL, LATENT)


def test_explicit_statistics_are_per_rank(ranks):
    """The per-device step's running statistics are the mean of the halves',
    not the global batch's: some differ from the global step's."""
    a, b = ranks[0]["explicit_state"], ranks[0]["global_state"]
    diffs = [(a[k] - b[k]).abs().max().item() for k in a if "running_" in k]
    assert max(diffs) > 1e-7


@pytest.fixture(scope="module")
def jax_eval(data):
    _, _, _, (e_images, e_masks, e_eps, valid) = data
    with pytest.MonkeyPatch.context() as mp:
        feed_jax_noise(mp, e_eps)
        mesh = jax_make_mesh(WORLD, devices=jax.devices()[:WORLD])
        step = jax_make_dp_eval_step(JaxTrainConfig(**_cfg_kwargs()), mesh,
                                     JaxUNetResNet(3, 1, backbone="resnet18"))
        di, dm, dv = jax_shard_batch(mesh, jnp.asarray(e_images), jnp.asarray(e_masks),
                                     jnp.asarray(valid))
        metrics, logits = step(jax.tree.map(jnp.asarray, jax_variables()), di, dm,
                               jax.random.PRNGKey(0), dv)
    return {k: float(v) for k, v in metrics.items()}, np.asarray(logits)


@pytest.mark.parametrize("rank", range(WORLD))
def test_eval_step_matches_jax_dp_eval(ranks, jax_eval, rank):
    """The metrics of the global batch under a ragged ``valid`` (sums
    pooled over the ranks) and the gathered logits, against JAX's pjit
    eval on 2 devices; predictions may differ only where a logit lies
    within 1e-4 of the 0.5 threshold (``test_torch_train_step.py``)."""
    ref_metrics, ref_logits = jax_eval
    metrics, logits = ranks[rank]["eval_metrics"], ranks[rank]["eval_logits"].numpy()
    assert logits.shape == ref_logits.shape == (GLOBAL, HW, HW, 1)
    np.testing.assert_allclose(logits, ref_logits, atol=5e-4)
    disagree = (logits > 0.5) != (ref_logits > 0.5)
    assert (np.abs(ref_logits[disagree] - 0.5) < 1e-4).all()
    assert sorted(metrics) == sorted(ref_metrics)
    if not disagree.any():
        for k in metrics:
            np.testing.assert_allclose(metrics[k].item(), ref_metrics[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
