"""The port's tensor parallelism (``vaeunet_tpu_torch/parallel/tp.py``) on
the CPU: which parameters the rule shards, against JAX's ``param_pspec``
on the flagship's parameter tree, and the channel-sharded step on a
(data 1, model 2) mesh of two gloo ranks against the port's unsharded
step (resnet18 VAE-UNet, 64^2, fp32, batch 2, ``min_channels`` 128 as
JAX's own TP tests take it).

Tolerances: the eval forward atol 1e-5 (the sharded convs sum over the
same inputs; only the split of the output channels differs); the clip's
norm against the whole gathered gradient's, rtol 1e-5; the training step
as ``tests/torch_train_parity.py`` holds a step (loss 1e-5, parameters 2
lr, running statistics 1e-4 + 1e-3 |ref|; the gradient by relative L2
<= 0.25: training-mode gradients at these sizes are chaotic in fp32
rounding, and JAX's own TP test measured a gradient cosine of 0.96 between
its sharded and unsharded steps).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet
from vaeunet_tpu.parallel.tp import param_pspec as jax_param_pspec

from vaeunet_tpu_torch.compat.jax_weights import convert_jax_unet_resnet
from vaeunet_tpu_torch.models import build_model
from vaeunet_tpu_torch.parallel import launch
from vaeunet_tpu_torch.parallel.tp import param_shardings
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step
from tests import torch_dist_workers as workers

HW, BATCH, LR, BETA, MIN_CHANNELS = 64, 2, 1e-3, 0.001, 128
CFG = dict(model_type="resnet", backbone="resnet18", batch_size=BATCH,
           gradient_accumulation_steps=1, amp=False, patch_size=HW, learning_rate=LR, seed=0)
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


@pytest.mark.parametrize("min_channels", [128, 256, 512])
def test_param_pspec_matches_jax(min_channels):
    """The flagship's tree (resnet34, latent 32, 'all', attention skips):
    each flax leaf is filled with its own index, carried into the port's
    names by the converter, and the port's sharded set is JAX's."""
    model = JaxUNetResNet(3, 1)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)), train=False, sample=False))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes["params"])
    tree = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(leaves)])
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])
    jax_sharded = {i for i, (path, leaf) in enumerate(leaves)
                   if "model" in str(jax_param_pspec(path, leaf, min_channels))}
    sd = convert_jax_unet_resnet({"params": tree, "batch_stats": stats})
    port = build_model(device="cpu")
    port.load_state_dict(sd)
    choice = param_shardings(port, min_channels)
    port_sharded = {int(sd[n].reshape(-1)[0]) for n, dim in choice.items() if dim is not None}
    assert port_sharded == jax_sharded
    assert jax_sharded, "no parameter is sharded"
    assert all(dim in (None, 0) for dim in choice.values())


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(4)
    images = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    masks = (rng.rand(BATCH, HW, HW, 1) > 0.9).astype(np.float32)
    eps = rng.randn(1, BATCH, 32).astype(np.float32)
    return images, masks, eps


def _state():
    config = TrainConfig(**CFG)
    return config, create_train_state(config, seed=0, device="cpu")


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    images, masks, eps = data
    _, state = _state()
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    return launch(workers.tp_steps, 2, args=(CFG, sd, images, masks, eps, BETA, MIN_CHANNELS),
                  device="cpu", timeout=300, model_axis=2, threads=THREADS,
                  workdir=str(tmp_path_factory.mktemp("tp")))


@pytest.fixture(scope="module")
def unsharded(data):
    images, masks, eps = data
    config, state = _state()
    state.model.eval()
    with torch.no_grad():
        x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        logits = state.model(x, sample=False)[0]
    step = make_train_step(config, state.model)
    step.compute_gradients(state, images, masks, BETA, eps=eps)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    config, state = _state()
    state, aux = make_train_step(config, state.model)(state, images, masks, BETA, eps=eps)
    return logits, grads, aux, state.model.state_dict()


def test_tp_shards_what_the_rule_names(ranks):
    config, state = _state()
    want = {n for n, dim in param_shardings(state.model, MIN_CHANNELS).items() if dim == 0}
    full = dict(state.model.named_parameters())
    for out in ranks:
        assert set(out["sharded"]) == want and want
        for n, shape in out["local_shapes"].items():
            expect = list(full[n].shape)
            if n in want:
                expect[0] //= 2
            assert list(shape) == expect, n


@pytest.mark.parametrize("rank", [0, 1])
def test_tp_eval_forward_matches_unsharded(ranks, unsharded, rank):
    torch.testing.assert_close(ranks[rank]["eval_logits"], unsharded[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("rank", [0, 1])
def test_tp_clip_norm_counts_the_whole_gradient(ranks, rank):
    """Clip-by-global-norm sums the sharded gradients' squares over the
    model group: the norm of the whole gathered gradient."""
    out = ranks[rank]
    assert out["clip_norm"] == pytest.approx(out["full_norm"], rel=1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_tp_gradient_matches_unsharded(ranks, unsharded, rank):
    grads, ref = ranks[rank]["grads"], unsharded[1]
    assert grads.keys() == ref.keys()
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    ours = torch.cat([grads[k].flatten() for k in ref])
    theirs = torch.cat([ref[k].flatten() for k in ref])
    assert ((ours - theirs).norm() / theirs.norm()).item() <= 0.25


@pytest.mark.parametrize("rank", [0, 1])
def test_tp_step_matches_unsharded(ranks, unsharded, rank):
    _, _, aux, sd = unsharded
    out = ranks[rank]
    for k in ("loss", "recon_loss"):
        np.testing.assert_allclose(out["aux"][k].item(), aux[k].item(), atol=1e-5, rtol=2e-6)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            torch.testing.assert_close(out["state"][k], v, atol=1e-4, rtol=1e-3, msg=k)
        else:
            torch.testing.assert_close(out["state"][k], v, atol=2 * LR + 1e-6, rtol=0, msg=k)


def test_tp_model_ranks_agree(ranks):
    """Downstream of every gather the model ranks compute alike: the
    replicated parameters and the gathered sharded ones are equal bit for
    bit after the step."""
    a, b = ranks[0]["state"], ranks[1]["state"]
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
