"""The port's plain UNet (``models/parts.py``, ``models/unet.py``) against
the JAX package on the CPU, both ``bilinear`` settings, at full widths on
64^2: the port's seeded weights (BN statistics randomized) go to JAX through
``vaeunet_tpu.compat.torch_weights.convert_unet_state_dict``, and a seeded
flax init comes back through ``compat/jax_weights.convert_jax_unet``.

Bounds as in the VAE-UNet tests: logits atol 5e-4, masks may disagree only
where |p - 0.5| < 1e-4; the train step's as ``tests/torch_train_parity.py``
sets them (here kl = 0 and mu, logvar are zeros [B, 1]).
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaeunet_tpu.compat.torch_weights import convert_unet_state_dict
from vaeunet_tpu.inference.predict import predict_image as jax_predict_image
from vaeunet_tpu.losses import make_criterion as jax_make_criterion
from vaeunet_tpu.models.parts import DoubleConv as JaxDoubleConv
from vaeunet_tpu.models.parts import Up as JaxUp
from vaeunet_tpu.models.parts import _pad_to_match as jax_pad_to_match
from vaeunet_tpu.models.unet import UNet as JaxUNet
from vaeunet_tpu.training.config import TrainConfig as JaxTrainConfig
from vaeunet_tpu.training.state import create_train_state as jax_create_train_state
from vaeunet_tpu.training.step import _forward_loss as jax_forward_loss
from vaeunet_tpu.training.step import make_eval_step as jax_make_eval_step
from vaeunet_tpu.training.step import make_train_step as jax_make_train_step

from vaeunet_tpu_torch import predict_image
from vaeunet_tpu_torch.compat.jax_weights import convert_jax_unet, load_jax_variables
from vaeunet_tpu_torch.models import UNet, build_unet
from vaeunet_tpu_torch.models.parts import _pad_to_match
from vaeunet_tpu_torch.training import (
    TrainConfig,
    build_model,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tests.torch_train_parity import assert_aux_matches, assert_grads_match

HW, LR = 64, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def randomize_bn_stats(model: torch.nn.Module, seed: int = 1) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)


def image(seed: int = 0, hw=(HW, HW), batch: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).rand(batch, *hw, 3).astype(np.float32)


def to_port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_masks_agree(logits: np.ndarray, ref_logits: np.ndarray) -> None:
    p, p_ref = 1 / (1 + np.exp(-logits)), 1 / (1 + np.exp(-ref_logits))
    disagree = (p > 0.5) != (p_ref > 0.5)
    assert (np.abs(p_ref[disagree] - 0.5) < 1e-4).all()


@functools.lru_cache(maxsize=None)
def port_pair(bilinear: bool, n_classes: int = 1):
    """(port UNet, JAX variables) on the port's seeded weights."""
    model = build_unet(3, n_classes, bilinear=bilinear, seed=0, device="cpu")
    randomize_bn_stats(model)
    variables = convert_unet_state_dict(model.state_dict(), bilinear=bilinear)
    return model, jax.tree.map(jnp.asarray, variables)


@functools.lru_cache(maxsize=None)
def jax_init(bilinear: bool):
    """A seeded flax init with randomized batch statistics, as numpy."""
    variables = jax.jit(lambda k: JaxUNet(3, 1, bilinear=bilinear).init(
        k, jnp.zeros((1, 16, 16, 3)), train=False))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)

    def randomize(path, leaf):
        if path[-1].key == "mean":
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)

    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(randomize, variables["batch_stats"])}


def sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = variables[col]
        for p in path:
            node = node[p]
        out[col] = node
    return out


@pytest.mark.parametrize("bilinear", [False, True])
def test_unet_matches_jax(bilinear):
    model, variables = port_pair(bilinear)
    x = image(1)
    ref = np.asarray(jax.jit(lambda v, x: JaxUNet(3, 1, bilinear=bilinear).apply(
        v, x, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        logits = model(to_port(x))
    assert logits.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(logits), ref, atol=5e-4, rtol=0)
    assert_masks_agree(nhwc(logits), ref)


def assert_trees_close(ours, ref, atol: float) -> None:
    a, b = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (ours, ref))
    assert [jax.tree_util.keystr(k) for k, _ in a] == [jax.tree_util.keystr(k) for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("bilinear", [False, True])
def test_parts_match_jax(bilinear, train):
    """DoubleConv (``inc``) and Up (``up3``) alone, eval BN or training BN
    (whose running statistics must move as JAX's do)."""
    base, variables = port_pair(bilinear)
    model = copy.deepcopy(base).train(train)
    f = 2 if bilinear else 1
    rng = np.random.RandomState(3)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    x1 = rng.randn(2, 8, 8, 256 // f).astype(np.float32)
    x2 = rng.randn(2, 16, 16, 128).astype(np.float32)
    for name, jax_mod, args in (("inc", JaxDoubleConv(64), (x,)),
                                ("up3", JaxUp(256, 128 // f, bilinear), (x1, x2))):
        v = sub(variables, name)
        jargs = [jnp.asarray(a) for a in args]
        if train:
            ref, upd = jax_mod.apply(v, *jargs, train=True, mutable=["batch_stats"])
            out = getattr(model, name)(*map(to_port, args))
            stats = convert_unet_state_dict(model.state_dict(), bilinear)["batch_stats"][name]
            assert_trees_close(stats, upd["batch_stats"], atol=1e-5)
        else:
            ref = jax_mod.apply(v, *jargs, train=False)
            with torch.no_grad():
                out = getattr(model, name)(*map(to_port, args))
        np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("bilinear", [False, True])
def test_convert_jax_unet_carries_a_flax_tree(bilinear):
    """A seeded flax tree through ``convert_jax_unet`` (transposed-conv
    kernels included) gives the JAX model's logits, and the port's own
    state dict survives the round trip through both converters."""
    variables = jax_init(bilinear)
    model = UNet(3, 1, bilinear=bilinear).eval().to(memory_format=torch.channels_last)
    assert load_jax_variables(model, variables) == []
    x = image(4)
    ref = np.asarray(jax.jit(lambda v, x: JaxUNet(3, 1, bilinear=bilinear).apply(
        v, x, train=False))(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    with torch.no_grad():
        logits = nhwc(model(to_port(x)))
    np.testing.assert_allclose(logits, ref, atol=5e-4, rtol=0)
    assert_masks_agree(logits, ref)
    sd = port_pair(bilinear)[0].state_dict()
    back = convert_jax_unet(convert_unet_state_dict(sd, bilinear=bilinear))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items() if "num_batches" not in k)
    assert ("up1.up.weight" in sd) == (not bilinear)


def test_odd_sizes_pad_to_match():
    """50 x 70 with two classes: every Up pads its upsampled input (F.pad
    order, left = diff // 2) before the gate and the concatenation."""
    rng = np.random.RandomState(5)
    a = rng.randn(2, 5, 6, 4).astype(np.float32)
    b = np.zeros((2, 8, 9, 4), np.float32)
    ours = _pad_to_match(to_port(a), to_port(b))
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(ours), np.asarray(jax_pad_to_match(a, b)))
    model, variables = port_pair(False, n_classes=2)
    x = image(6, hw=(50, 70))
    ref = np.asarray(jax.jit(lambda v, x: JaxUNet(3, 2).apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        logits = nhwc(model(to_port(x)))
    assert logits.shape == (2, 50, 70, 2)
    np.testing.assert_allclose(logits, ref, atol=5e-4, rtol=0)


@pytest.mark.parametrize("bilinear", [False, True])
def test_predict_image_plain_matches_jax(bilinear):
    """The milesial predict path: sigmoid of the forward, > threshold."""
    model, variables = port_pair(bilinear)
    img = image(7, batch=1)[0]
    probs, mask = predict_image(model, img, out_threshold=0.5, device="cpu")
    ref_probs, ref_mask = jax_predict_image(JaxUNet(3, 1, bilinear=bilinear), variables,
                                            jnp.asarray(img), 0.5)
    assert probs.shape == mask.shape == (HW, HW, 1) and mask.dtype == torch.bool
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs), atol=1e-4)
    disagree = mask.numpy() != np.asarray(ref_mask)
    assert (np.abs(np.asarray(ref_probs)[disagree] - 0.5) < 1e-4).all()
    with pytest.raises(ValueError, match="no"):
        predict_image(model, img, generator=torch.Generator(), device="cpu")


def unet_config(**kw) -> dict:
    base = dict(model_type="basic", bilinear=True, batch_size=2, gradient_accumulation_steps=1,
                amp=False, patch_size=HW, learning_rate=LR, seed=0)
    base.update(kw)
    return base


def train_batch(seed: int = 8):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, HW, HW, 3).astype(np.float32),
            (rng.rand(2, HW, HW, 1) > 0.9).astype(np.float32))


def test_unet_train_step_matches_jax():
    """The non-VAE branch (``step.py:43-51``): kl = 0, mu and logvar fp32
    zeros [B, 1]; the whole gradient against ``jax.grad`` by relative L2,
    the 1x1 out conv per element; then one clipped AdamW step."""
    images, masks = train_batch()
    variables = jax_init(True)
    jcfg = JaxTrainConfig(**unet_config())
    jstate = jax_create_train_state(jcfg, jax.random.PRNGKey(0),
                                    variables=jax.tree.map(jnp.asarray, variables))
    grad_fn = jax.jit(jax.grad(functools.partial(
        jax_forward_loss, JaxUNet(3, 1, bilinear=True), jax_make_criterion("EX"), jcfg),
        has_aux=True))
    grads, (_, ref_aux) = grad_fn(jstate.params, jstate.batch_stats, jnp.asarray(images),
                                  jnp.asarray(masks), jax.random.PRNGKey(5), jnp.float32(0.001))
    ref_grads = convert_jax_unet({"params": jax.tree.map(np.asarray, grads),
                                  "batch_stats": variables["batch_stats"]})

    cfg = TrainConfig(**unet_config())
    state = create_train_state(cfg, seed=0, variables=variables, device="cpu")
    assert isinstance(state.model, UNet) and state.model.bilinear
    aux = make_train_step(cfg, state.model).compute_gradients(state, images, masks, 0.001)
    assert aux["kl_loss"].item() == 0.0
    assert aux["mu"].shape == aux["logvar"].shape == (2, 1)
    assert aux["mu"].dtype == torch.float32 and not aux["mu"].any()
    assert_aux_matches(aux, ref_aux)
    assert_grads_match(state.model, ref_grads, head="outc.conv")

    new_jstate, jaux = jax_make_train_step(jcfg)(jstate, images, masks, jnp.float32(0.001))
    state = create_train_state(cfg, seed=0, variables=variables, device="cpu")
    state, aux = make_train_step(cfg, state.model)(state, images, masks, 0.001)
    assert_aux_matches(aux, jaux)
    ref = convert_jax_unet({"params": jax.tree.map(np.asarray, new_jstate.params),
                            "batch_stats": jax.tree.map(np.asarray, new_jstate.batch_stats)})
    for k, v in state.model.state_dict().items():
        if "running_" in k:
            torch.testing.assert_close(v, ref[k], atol=1e-4, rtol=1e-3, msg=k)
        elif "num_batches" not in k:
            torch.testing.assert_close(v, ref[k], atol=2 * LR + 1e-6, rtol=0, msg=k)
    with pytest.raises(ValueError, match="latent"):
        make_train_step(cfg, state.model)(state, images, masks, 0.001,
                                          eps=np.zeros((1, 2, 32), np.float32))


def test_unet_eval_step_matches_jax():
    """The eval step's plain branch (``step.py:261-265``): eval BN, metrics
    on raw logits with a ``valid`` row mask."""
    images, masks = train_batch(9)
    variables = jax_init(False)
    valid = np.array([1.0, 0.0], np.float32)
    jcfg = JaxTrainConfig(**unet_config(bilinear=False))
    ref_metrics, ref_logits = jax_make_eval_step(jcfg)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images), jnp.asarray(masks),
        jax.random.PRNGKey(0), jnp.asarray(valid))
    cfg = TrainConfig(**unet_config(bilinear=False))
    state = create_train_state(cfg, seed=0, variables=variables, device="cpu")
    metrics, logits = make_eval_step(cfg, state.model)(images, masks, valid=valid)
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=5e-4)
    disagree = (logits.numpy() > 0.5) != (ref_logits > 0.5)
    assert (np.abs(ref_logits[disagree] - 0.5) < 1e-4).all()
    assert sorted(metrics) == sorted(ref_metrics)
    if not disagree.any():
        for k in metrics:
            np.testing.assert_allclose(metrics[k].item(), float(ref_metrics[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("fields,match", [
    (dict(model_type="basic", deep_supervision=True), "deep_supervision"),
    (dict(model_type="resnet", bilinear=True), "bilinear"),
    (dict(model_type="nope"), "model_type"),
    (dict(model_type="basic", remat_policy="everything"), "remat_policy"),
    (dict(model_type="basic", use_remat=True, remat_policy="save_convs"), "remat_policy"),
])
def test_build_model_refuses_what_it_cannot_honour(fields, match):
    with pytest.raises(ValueError, match=match):
        build_model(TrainConfig(**fields), device="cpu")


def test_build_model_honours_the_unet_fields():
    model = build_model(TrainConfig(model_type="basic", bilinear=True, use_remat=True,
                                    n_classes=2), device="cpu")
    assert isinstance(model, UNet)
    assert (model.bilinear, model.use_remat, model.n_classes) == (True, True, 2)
    assert not model.training
