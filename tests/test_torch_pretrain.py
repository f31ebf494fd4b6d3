"""The port's masked-reconstruction pretext, encoder transplant and backbone
import (``vaeunet_tpu_torch/training/pretrain.py``,
``compat/torch_weights.py::convert_resnet34_backbone``) against the JAX
package on the CPU (the contrastive pretext and the pretrain CLI:
``tests/test_torch_pretrain_contrastive.py``).

Weights: a seeded flax init of JAX's ``MaskedReconstructor`` (resnet18,
64^2, compiled by ``jax.jit``) with randomized BN statistics, carried into
the port by ``compat/jax_weights.py::convert_jax_pretrain``.  The block
mask is fed to both sides (JAX's ``make_block_mask`` patched for the test,
the port's ``mask=``).  Bounds: the eval forward atol 5e-4 (the logits'
bound); parameters after one AdamW step 2 lr (+ 1e-6) and running
statistics 1e-4 + 1e-3 |ref|, as ``tests/torch_train_parity.py`` holds a
train step; the training loss and masked MSE rtol 2e-3.  That last bound
is JAX's own rounding: its training-mode BN sums in sequential fp32, and
at this model's stem (2 x 32 x 32 values a channel) its output is 3.5e-5
off a float64 computation where the port's is 7.9e-7; the head's five BNs
over 8 values a channel carry that to the reconstruction, whose MSE the
loss is (measured: 6.5e-4 relative between the two sides).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vaeunet_tpu.training.pretrain as jax_pretrain
from vaeunet_tpu.compat.torch_weights import (
    convert_resnet34_backbone as jax_convert_resnet34_backbone,
)

from vaeunet_tpu_torch.compat import (
    convert_jax_pretrain,
    convert_resnet34_backbone,
)
from vaeunet_tpu_torch.data.device_cache import _upload
from vaeunet_tpu_torch.models.resnet import ResNetEncoder
from vaeunet_tpu_torch.training import TrainConfig, create_train_state
from vaeunet_tpu_torch.training.pretrain import (
    MaskedReconstructor,
    build_pretrain_model,
    create_pretrain_state,
    encoder_subtree,
    make_block_mask,
    make_pretrain_step,
    transplant_encoder,
)

HW, B, LR = 64, 2, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def randomized(variables, seed: int):
    rng = np.random.RandomState(seed)

    def randomize(path, leaf):
        if path[-1].key == "mean":
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)

    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(randomize, variables["batch_stats"])}


@pytest.fixture(scope="module")
def masked_pair():
    """(JAX model, numpy variables, port model on the same weights)."""
    jmodel = jax_pretrain.MaskedReconstructor(backbone="resnet18")
    init = jax.jit(lambda k: jmodel.init({"params": k}, jnp.zeros((1, HW, HW, 3)), train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 2)
    model = MaskedReconstructor(backbone="resnet18").to(memory_format=torch.channels_last)
    model.load_state_dict(convert_jax_pretrain(variables))
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(3)
    images = rng.rand(B, HW, HW, 3).astype(np.float32)
    mask = np.repeat(np.repeat((rng.rand(B, 2, 2) < 0.4).astype(np.float32), 32, 1), 32, 2)
    return images, mask[..., None]


def test_block_mask_shape_and_ratio():
    """JAX ``test_block_mask_shape_and_ratio``: coherent 0/1 blocks at the ratio."""
    m = make_block_mask(torch.Generator().manual_seed(0), 4, 64, block=16, mask_ratio=0.4)
    assert m.shape == (4, 64, 64, 1)
    assert set(np.unique(m.numpy())) <= {0.0, 1.0}
    blocks = m.numpy()[:, ::16, ::16, 0]
    np.testing.assert_array_equal(np.repeat(np.repeat(blocks, 16, 1), 16, 2), m.numpy()[..., 0])
    assert 0.2 < float(m.mean()) < 0.6


def test_convert_jax_pretrain_covers_the_model(masked_pair):
    _, variables, model = masked_pair
    sd = convert_jax_pretrain(variables)
    assert set(sd) == set(model.state_dict())


def test_masked_reconstructor_matches_jax(masked_pair, batch):
    """Eval mode: running-statistics BN, the valid 3x3 head convs with bias,
    the five resizes and the last one to the input size."""
    jmodel, variables, model = masked_pair
    images, _ = batch
    ref = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(images),
                                  train=False))
    with torch.no_grad():
        out = model(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (B, HW, HW, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4)


def test_pretrain_step_matches_jax(masked_pair, batch, monkeypatch):
    """One masked-reconstruction step on the same weights and mask."""
    jmodel, variables, _ = masked_pair
    images, mask = batch
    monkeypatch.setattr(jax_pretrain, "make_block_mask",
                        lambda rng, b, hw, block=32, mask_ratio=0.4: jnp.asarray(mask))
    tx, jstep = jax_pretrain.make_pretrain_step(jmodel, LR, amp=False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    params, stats, _, _, ref_loss, ref_mse = jstep(params, stats, tx.init(params),
                                                   jnp.asarray(images), jax.random.PRNGKey(1))
    ref = convert_jax_pretrain({"params": jax.tree.map(np.asarray, params),
                                "batch_stats": jax.tree.map(np.asarray, stats)})

    model = MaskedReconstructor(backbone="resnet18").to(memory_format=torch.channels_last)
    model.load_state_dict(convert_jax_pretrain(variables))
    state = create_pretrain_state(model, LR)
    state, loss, mse = make_pretrain_step(model, amp=False)(state, images, mask=mask)
    assert state.step == 1
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=2e-3)
    np.testing.assert_allclose(mse.item(), float(ref_mse), rtol=2e-3)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            torch.testing.assert_close(v, ref[k], atol=1e-4, rtol=1e-3, msg=k)
        else:
            torch.testing.assert_close(v, ref[k], atol=2 * LR + 1e-6, rtol=0, msg=k)


def test_indexed_pretrain_step_gathers_the_batch(batch):
    """``indexed=True`` takes rows of a uint8 device array / 255: the same
    step as on those rows in fp32."""
    images, mask = batch
    u8 = (images * 255).round().astype(np.uint8)
    data, _ = _upload(u8, u8[..., :1], "cpu")
    results = []
    for indexed in (True, False):
        model = build_pretrain_model("masked", "resnet18", seed=4, device="cpu")
        state = create_pretrain_state(model, LR)
        step = make_pretrain_step(model, amp=False, indexed=indexed)
        args = (data, np.array([1, 0])) if indexed else (u8[[1, 0]].astype(np.float32) / 255.0,)
        state, loss, _ = step(state, *args, mask=mask)
        results.append((loss, model.state_dict()))
    assert torch.equal(results[0][0], results[1][0])
    assert all(torch.equal(results[0][1][k], v) for k, v in results[1][1].items())


def test_pretraining_learns_and_draws_its_masks(batch):
    """JAX ``test_pretrain_learns_and_transplants``: four steps on one mask
    lower the loss; with the masks drawn from the state's generator the
    steps repeat for one seed and differ for another."""
    images, mask = batch
    model = build_pretrain_model("masked", "resnet18", seed=0, device="cpu")
    state = create_pretrain_state(model, LR, seed=1)
    step = make_pretrain_step(model, amp=False)
    losses = []
    for _ in range(4):
        state, loss, _ = step(state, images, mask=mask)
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
    drawn = []
    for seed in (1, 1, 2):
        model = build_pretrain_model("masked", "resnet18", seed=0, device="cpu")
        state = create_pretrain_state(model, LR, seed=seed)
        step = make_pretrain_step(model, amp=False)
        drawn.append([step(state, images)[1].item() for _ in range(2)])
    assert drawn[0] == drawn[1] != drawn[2]
    assert drawn[0][0] != drawn[0][1]


def test_transplant_encoder_and_its_shape_check():
    """The pretext's ``encoder.*`` entries replace the VAE-UNet's, bit for
    bit; the rest stay; a backbone mismatch raises (JAX ``:230-245``)."""
    enc = encoder_subtree(build_pretrain_model("masked", "resnet18", seed=5,
                                               device="cpu").state_dict())
    assert enc and all(k.startswith("encoder.") for k in enc)
    cfg = TrainConfig(model_type="resnet", backbone="resnet18", latent_dim=8, amp=False)
    sd = create_train_state(cfg, seed=0, device="cpu").model.state_dict()
    out = transplant_encoder(sd, enc)
    assert out.keys() == sd.keys()
    for k, v in out.items():
        assert torch.equal(v, enc[k] if k in enc else sd[k]), k
    model = create_train_state(cfg, seed=0, device="cpu").model
    model.load_state_dict(out)
    cfg50 = TrainConfig(model_type="resnet", backbone="resnet50", latent_dim=8, amp=False)
    sd50 = create_train_state(cfg50, seed=0, device="cpu").model.state_dict()
    with pytest.raises(ValueError, match="backbone mismatch"):
        transplant_encoder(sd50, enc)


def test_convert_resnet34_backbone_matches_jax():
    """A torchvision/timm-named resnet34 state dict (with its ``fc``): the
    port's encoder state equals JAX's conversion carried into the port's
    names, and loads into ``ResNetEncoder('resnet34')`` strictly."""
    g = torch.Generator().manual_seed(8)
    sd = {k: torch.rand(v.shape, generator=g) if v.is_floating_point() else v
          for k, v in ResNetEncoder(backbone="resnet34").state_dict().items()}
    sd["fc.weight"], sd["fc.bias"] = torch.rand(1000, 512), torch.rand(1000)
    ours = convert_resnet34_backbone(sd)
    tree = jax_convert_resnet34_backbone({k: v.numpy() for k, v in sd.items()})
    theirs = {k[len("encoder."):]: v for k, v in convert_jax_pretrain(
        {"params": {"encoder": tree["params"]},
         "batch_stats": {"encoder": tree["batch_stats"]}}).items()}
    assert set(theirs) <= set(ours) and "fc.weight" not in ours
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), k
    enc = ResNetEncoder(backbone="resnet34")
    enc.load_state_dict(ours)


def test_convert_resnet34_backbone_refuses_other_trees():
    sd = ResNetEncoder(backbone="resnet18").state_dict()
    with pytest.raises(KeyError, match="not a resnet34"):
        convert_resnet34_backbone(sd)
