"""Deep supervision, remat, ``debug_nans`` and the optimizer's state on the
CPU.

- The deep-supervision loss and its gradient against JAX's
  ``_forward_loss`` (resnet18 VAE-UNet, 64^2, fp32, batch 2, the same
  noise), remat 'save_convs' on both sides; tolerances as
  ``tests/torch_train_parity.py`` sets them.
- Remat 'full' and 'save_convs' against no remat on the port alone, for
  the VAE-UNet and the bilinear UNet: loss and BN running statistics within
  1e-6, the gradient within relative L2 1e-5, every BN's
  ``num_batches_tracked`` moved by exactly 1; 'save_convs' runs no 3x3
  conv twice (the strided ones included, as JAX keeps them), 'full' runs
  every one of the blocks' 3x3 convs again.  The UNet takes 'full' only.
- ``debug_nans`` raises on a NaN input and changes nothing otherwise.
- ``ClippedAdamW`` saved and restored takes the step an unbroken one takes.
"""

import functools
import io

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from vaeunet_tpu.losses import make_criterion as jax_make_criterion
from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet
from vaeunet_tpu.training.config import TrainConfig as JaxTrainConfig
from vaeunet_tpu.training.state import create_train_state as jax_create_train_state
from vaeunet_tpu.training.step import _forward_loss as jax_forward_loss

from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step
from tests.torch_train_parity import (
    BATCH,
    BETA,
    HW,
    as_state_dict,
    assert_aux_matches,
    assert_grads_match,
    batch,
    feed_jax_noise,
)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def vae_config(**kw) -> dict:
    base = dict(model_type="resnet", backbone="resnet18", batch_size=BATCH,
                gradient_accumulation_steps=1, amp=False, patch_size=HW, learning_rate=1e-3,
                seed=0)
    base.update(kw)
    return base


@functools.lru_cache(maxsize=None)
def ds_variables():
    """A seeded flax init of the resnet18 VAE-UNet with its three
    deep-supervision heads, batch statistics randomized, as numpy."""
    model = JaxUNetResNet(3, 1, backbone="resnet18", deep_supervision=True)
    variables = jax.jit(lambda k: model.init({"params": k, "latent": k},
                                             jnp.zeros((1, 32, 32, 3)), train=False,
                                             sample=False))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)

    def randomize(path, leaf):
        if path[-1].key == "mean":
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)

    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(randomize, variables["batch_stats"])}


def test_deep_supervision_loss_and_gradient_match_jax(monkeypatch):
    """Levels 2, 1, 0 with weights 1/2, 1/4, 1/8 against the masks resized
    to 16^2, 8^2, 4^2 (align_corners=False), the sum over the total weight;
    both sides rematerialize with 'save_convs'."""
    images, masks, eps = batch()
    feed_jax_noise(monkeypatch, eps)
    kw = vae_config(deep_supervision=True, use_remat=True, remat_policy="save_convs")
    jcfg = JaxTrainConfig(**kw)
    jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(0),
                                    variables=jax.tree.map(jnp.asarray, ds_variables()))
    jmodel = JaxUNetResNet(3, 1, backbone="resnet18", deep_supervision=True, use_remat=True,
                           remat_policy="save_convs")
    fn = jax.jit(jax.grad(functools.partial(jax_forward_loss, jmodel, jax_make_criterion("EX"),
                                            jcfg), has_aux=True))
    grads, (stats, ref_aux) = fn(jstate.params, jstate.batch_stats, jnp.asarray(images),
                                 jnp.asarray(masks), jax.random.PRNGKey(5), jnp.float32(BETA))

    cfg = TrainConfig(**kw)
    state = create_train_state(cfg, seed=0, variables=ds_variables(), device="cpu")
    model = state.model
    assert model.deep_supervision and model.use_remat and len(model.ds_heads) == 3
    aux = make_train_step(cfg, model).compute_gradients(state, images, masks, BETA,
                                                         eps=eps[None])
    assert_aux_matches(aux, ref_aux)
    ref_grads = as_state_dict(grads, jstate.batch_stats)
    assert {f"ds_heads.{i}.{p}" for i in range(3) for p in ("weight", "bias")} <= set(ref_grads)
    assert_grads_match(model, ref_grads)
    for i in range(3):
        k = f"ds_heads.{i}.bias"        # no BN after a head: held per element
        np.testing.assert_allclose(model.get_parameter(k).grad.numpy(), ref_grads[k].numpy(),
                                   atol=1e-3 * ref_grads[k].abs().max().item(), err_msg=k)
    ref_stats = as_state_dict(jstate.params, stats)
    for k, v in model.state_dict().items():
        if "running_" in k:
            torch.testing.assert_close(v, ref_stats[k], atol=1e-4, rtol=1e-3, msg=k)

    # the same weights without the heads: another recon loss
    v = ds_variables()
    v = {"params": {k: p for k, p in v["params"].items() if not k.startswith("ds_head")},
         "batch_stats": v["batch_stats"]}
    cfg_plain = TrainConfig(**vae_config())
    state = create_train_state(cfg_plain, seed=0, variables=v, device="cpu")
    plain = make_train_step(cfg_plain, state.model).compute_gradients(
        state, images, masks, BETA, eps=eps[None])
    assert abs(plain["recon_loss"].item() - aux["recon_loss"].item()) > 1e-4


class _Count3x3Convs(TorchDispatchMode):
    """Counts the 3x3 convolutions (the conv kernel's plain version and the
    strided convs), the backward's recompute included."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default and tuple(args[1].shape[-2:]) == (3, 3):
            self.n += 1
        return func(*args, **(kwargs or {}))


def run_step(cfg: TrainConfig, images, masks, eps):
    """compute_gradients from seed 0 -> (aux, gradients, state dict, 3x3
    convs run in the forward and the backward)."""
    state = create_train_state(cfg, seed=0, device="cpu")
    with _Count3x3Convs() as convs:
        aux = make_train_step(cfg, state.model).compute_gradients(
            state, images, masks, BETA, eps=eps)
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters() if p.grad is not None}
    return aux, grads, state.model.state_dict(), convs.n


@pytest.mark.parametrize("kind", ["vae", "unet"])
def test_remat_policies_equal_no_remat(kind):
    images, masks, eps = batch(4)
    if kind == "vae":
        kw, eps, policies = vae_config(), eps[None], ("full", "save_convs")
    else:
        kw, eps, policies = vae_config(model_type="basic", bilinear=True), None, ("full",)
    base_aux, base_grads, base_sd, base_calls = run_step(TrainConfig(**kw), images, masks, eps)
    # resnet18: 13 kernel convs + 3 strided in the encoder, 8 in the decoder
    assert base_calls == (24 if kind == "vae" else 18)
    for policy in policies:
        aux, grads, sd, n = run_step(TrainConfig(**kw, use_remat=True, remat_policy=policy),
                                     images, masks, eps)
        assert n == (2 * base_calls if policy == "full" else base_calls), (policy, n)
        for k in ("loss", "recon_loss", "kl_loss"):
            np.testing.assert_allclose(aux[k].item(), base_aux[k].item(), atol=1e-6, err_msg=k)
        assert set(grads) == set(base_grads)
        ours = torch.cat([g.flatten() for g in grads.values()])
        theirs = torch.cat([base_grads[k].flatten() for k in grads])
        rel = ((ours - theirs).norm() / theirs.norm()).item()
        assert rel <= 1e-5, (policy, rel)
        for k, v in sd.items():
            if "running_" in k:
                torch.testing.assert_close(v, base_sd[k], atol=1e-6, rtol=0, msg=(policy, k))
            elif k.endswith("num_batches_tracked"):
                assert v.item() == 1, (policy, k, v.item())


def test_debug_nans_raises_on_a_nan_input_and_changes_nothing_else():
    images, masks, eps = batch(5)
    cfg = TrainConfig(**vae_config(debug_nans=True))
    state = create_train_state(cfg, seed=0, device="cpu")
    aux = make_train_step(cfg, state.model).compute_gradients(state, images, masks, BETA,
                                                               eps=eps[None])
    ref_aux, ref_grads, _, _ = run_step(TrainConfig(**vae_config()), images, masks, eps[None])
    assert aux["loss"].item() == ref_aux["loss"].item()
    for k, p in state.model.named_parameters():
        assert torch.equal(p.grad, ref_grads[k]), k
    bad = images.copy()
    bad[0, 3, 5, 1] = np.nan
    state = create_train_state(cfg, seed=0, device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        make_train_step(cfg, state.model)(state, bad, masks, BETA, eps=eps[None])


def test_clipped_adamw_round_trip():
    """Two steps unbroken, against one step, a save through ``torch.save``
    of the model's and the optimizer's state dicts, a fresh state loaded
    from them, and one more step: the same parameters, bit for bit."""
    images, masks, _ = batch(6)
    cfg = TrainConfig(**vae_config(model_type="basic", bilinear=True, gradient_clipping=0.5))
    unbroken = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, unbroken.model)
    for _ in range(2):
        unbroken, _ = step(unbroken, images, masks, BETA)

    first = create_train_state(cfg, seed=0, device="cpu")
    first, _ = make_train_step(cfg, first.model)(first, images, masks, BETA)
    buf = io.BytesIO()
    torch.save({"model": first.model.state_dict(), "opt": first.optimizer.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    assert saved["opt"]["max_norm"] == 0.5
    resumed = create_train_state(TrainConfig(**vae_config(model_type="basic", bilinear=True)),
                                 seed=1, device="cpu")
    resumed.model.load_state_dict(saved["model"])
    resumed.optimizer.load_state_dict(saved["opt"])
    assert resumed.optimizer.max_norm == 0.5
    resumed, _ = make_train_step(cfg, resumed.model)(resumed, images, masks, BETA)
    for (k, a), b in zip(unbroken.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("in_hw,out_hw,b", [((512, 512), (128, 128), 16),
                                            ((512, 512), (64, 64), 16),
                                            ((512, 512), (32, 32), 16),
                                            ((1424, 2144), (2848, 4288), 1)])
def test_one_channel_path_resizes_plan_the_row_route(in_hw, out_hw, b):
    """The deep-supervision mask downsamples (by 4, 8, 16) and predict.py's
    upscale take the row route within the shared-memory budget and the
    grid; a numpy model of its blocks, at the plan's tile, equals the plain
    version bit for bit (two images, fp32)."""
    from tests.test_torch_resize_tiled import row_forward_model
    from vaeunet_tpu_torch.ops.pallas import resize_mm

    plan = resize_mm.plan_forward(in_hw, out_hw, 1, 4, False, b)
    assert plan.route == "row" and plan.smem_bytes <= resize_mm.SMEM_BUDGET
    assert plan.blocks <= resize_mm.MAX_BLOCKS and plan.tile_w % 4 == 0
    x = np.random.RandomState(7).rand(min(b, 2), *in_hw).astype(np.float32)
    ours = row_forward_model(x, out_hw, False, (plan.tile_h, plan.tile_w), 4)
    ref = resize_mm.resize_plain(torch.from_numpy(x)[:, None], out_hw, False)
    assert torch.equal(torch.from_numpy(ours)[:, None], ref)
