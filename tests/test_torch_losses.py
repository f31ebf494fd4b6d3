"""The port's losses, metrics, KL annealer, plateau schedule and TrainConfig
against the JAX package on the CPU, on inputs from numpy seeds."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaeunet_tpu import losses as jl
from vaeunet_tpu import metrics as jm
from vaeunet_tpu.training.config import TrainConfig as JaxTrainConfig
from vaeunet_tpu.training.schedule import ReduceLROnPlateau as JaxReduceLROnPlateau

from vaeunet_tpu_torch import losses as tl
from vaeunet_tpu_torch import metrics as tm
from vaeunet_tpu_torch.training import ReduceLROnPlateau, TrainConfig


def seg_pair(seed: int, shape=(2, 16, 16, 1), scale: float = 3.0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape) * scale).astype(np.float32)
    targets = (rng.rand(*shape) > 0.8).astype(np.float32)
    return logits, targets


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


LOSSES = ["dice_loss", "bce_with_logits", "combined_loss", "ma_focal_loss",
          "ma_segmentation_loss", "focal_loss", "multichannel_combined_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_values_and_gradients_match_jax(name):
    shape = (2, 16, 16, 3) if name == "multichannel_combined_loss" else (2, 16, 16, 1)
    logits, targets = seg_pair(0, shape)
    logits[0, 0, 0, 0] = 40.0                     # saturated sigmoids
    logits[1, 3, 2, 0] = -40.0
    jfn, tfn = getattr(jl, name), getattr(tl, name)
    ref, ref_grad = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(targets))
    lt = t(logits).requires_grad_()
    ours = tfn(lt, t(targets))
    ours.backward()
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref_grad), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(ref_grad)).max())


def test_losses_take_bf16_logits_and_guard_nan():
    logits, targets = seg_pair(1)
    logits[0, 1, 1, 0] = np.nan                   # the reference's NaN guard: sigmoid -> 0
    for name in ("dice_loss", "ma_focal_loss"):
        ref = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(targets))
        ours = getattr(tl, name)(t(logits), t(targets))
        np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)
    ours = tl.combined_loss(t(logits[:, 2:]).to(torch.bfloat16), t(targets[:, 2:]))
    ref = jl.combined_loss(jnp.asarray(logits[:, 2:], jnp.bfloat16), jnp.asarray(targets[:, 2:]))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("lesion,override", [("EX", "auto"), ("MA", "auto"), ("HE", "focal"),
                                             ("MA", "combined"), ("ALL", "auto")])
def test_make_criterion_matches_jax(lesion, override):
    shape = (2, 8, 8, 4) if lesion == "ALL" else (2, 8, 8, 1)
    logits, targets = seg_pair(2, shape)
    ref = jl.make_criterion(lesion, override)(jnp.asarray(logits), jnp.asarray(targets))
    ours = tl.make_criterion(lesion, override)(t(logits), t(targets))
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("free_bits,clamp_leak", [(1e-3, 0.0), (0.5, 0.0), (1e-3, 0.3), (0.0, 0.1)])
def test_kl_with_free_bits_matches_jax(free_bits, clamp_leak):
    """Dimensions above the +100 rail (huge logvar, large mu), below the
    free-bits floor (mu = logvar = 0) and a NaN, with the straight-through
    leak of the clamp's excess."""
    rng = np.random.RandomState(3)
    mu = rng.randn(4, 8).astype(np.float32)
    logvar = rng.randn(4, 8).astype(np.float32)
    logvar[0, 0] = 6.0                            # 0.5 e^6 > 100: clamped
    mu[1, 1] = 20.0                               # 0.5 * 400 > 100: clamped
    mu[2, 2] = logvar[2, 2] = 0.0                 # KL 0: below the floor
    mu[3, 3] = np.nan
    fn = lambda m, lv: jl.kl_with_free_bits(m, lv, free_bits=free_bits, clamp_leak=clamp_leak)
    ref, (gmu, glv) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(logvar))
    mt, lt = t(mu).requires_grad_(), t(logvar).requires_grad_()
    ours = tl.kl_with_free_bits(mt, lt, free_bits=free_bits, clamp_leak=clamp_leak)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(gmu), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(glv), rtol=1e-5, atol=1e-7)
    if clamp_leak > 0:        # the clamped dimension still pulls back
        assert lt.grad[0, 0] != 0 and mt.grad[1, 1] != 0
    else:
        assert lt.grad[0, 0] == 0 and mt.grad[1, 1] == 0


@pytest.mark.parametrize("strategy", ["linear", "cyclical", "constant"])
def test_kl_annealer_matches_jax(strategy):
    ours = tl.KLAnnealer(kl_start=0.0, kl_end=0.001, warmup_epochs=4, strategy=strategy)
    ref = jl.KLAnnealer(kl_start=0.0, kl_end=0.001, warmup_epochs=4, strategy=strategy)
    for epoch in (0, 1, 2.5, 4, 7, 100):
        assert ours.get_weight(epoch) == ref.get_weight(epoch)
        assert ours.get_weight(epoch, 3, 10) == ref.get_weight(epoch, 3, 10)


@pytest.mark.parametrize("apply_sigmoid", [False, True])
@pytest.mark.parametrize("valid", [None, [1, 0, 1]])
def test_get_all_metrics_matches_jax(apply_sigmoid, valid):
    logits, targets = seg_pair(4, (3, 12, 12, 1), scale=1.0)
    logits[0, 0, 0, 0] = 0.55                     # between 0.5 and the sigmoid threshold 0
    targets[2] = 0.0                              # an empty row
    v = None if valid is None else np.asarray(valid, np.float32)
    ref = jm.get_all_metrics(jnp.asarray(logits), jnp.asarray(targets),
                             apply_sigmoid=apply_sigmoid,
                             valid=None if v is None else jnp.asarray(v))
    ours = tm.get_all_metrics(t(logits), t(targets), apply_sigmoid=apply_sigmoid,
                              valid=None if v is None else t(v))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].item(), float(ref[k]), rtol=1e-6, err_msg=k)


def test_metrics_valid_rows_score_as_the_unpadded_batch_and_empty_dice_is_one():
    logits, targets = seg_pair(5, (4, 8, 8, 1))
    padded = tm.get_all_metrics(t(logits), t(targets), valid=torch.tensor([1, 1, 0, 0]))
    true = tm.get_all_metrics(t(logits[:2]), t(targets[:2]))
    for k in true:
        np.testing.assert_allclose(padded[k].item(), true[k].item(), rtol=1e-6, err_msg=k)
    empty = torch.full((1, 4, 4, 1), -5.0)
    assert tm.dice_score(empty, torch.zeros_like(empty)).item() == 1.0


def test_metric_tracker_matches_jax():
    ours, ref = tm.MetricTracker(), jm.MetricTracker()
    for phase, m in [("train", {"loss": 0.5, "dice": 0.3}), ("val", {"dice": 0.4, "extra": 2.0}),
                     ("val", {"dice": 0.2})]:
        ours.update(phase, m)
        ref.update(phase, m)
    for phase in ("train", "val"):
        assert ours.get_current(phase) == ref.get_current(phase)
    for d in (0.3, 0.2, 0.35, 0.35):
        assert ours.is_best_dice(d) == ref.is_best_dice(d)
    assert ours.best_dice == ref.best_dice


def test_plateau_schedule_matches_jax_and_torch():
    lin = torch.nn.Linear(1, 1)
    opt = torch.optim.SGD(lin.parameters(), lr=1.0)
    torch_ref = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, mode="max", patience=2,
                                                           factor=0.5, min_lr=0.01)
    ours = ReduceLROnPlateau(factor=0.5, patience=2, min_lr=0.01)
    ref = JaxReduceLROnPlateau(factor=0.5, patience=2, min_lr=0.01)
    lr = lr_ref = 1.0
    for m in [0.5, 0.6, 0.6, 0.6, 0.6, 0.61, 0.61, 0.61, 0.61, 0.2, 0.2, 0.2, 0.2, 0.2]:
        torch_ref.step(m)
        lr, lr_ref = ours.step(m, lr), ref.step(m, lr_ref)
        assert lr == lr_ref == pytest.approx(opt.param_groups[0]["lr"])
    assert ours.state_dict() == ref.state_dict()
    for lesion in ("MA", "EX"):
        assert (dataclasses.asdict(ReduceLROnPlateau.for_lesion(lesion))
                == dataclasses.asdict(JaxReduceLROnPlateau.for_lesion(lesion)))


@pytest.mark.parametrize("kw", [{}, {"latent_injection": (0, 2), "patch_size": 512, "beta": 0.0,
                                     "img_scale": 0.5, "free_bits": 0.0}])
def test_train_config_matches_jax_and_round_trips(kw):
    ours, ref = TrainConfig(**kw), JaxTrainConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.to_json() == ref.to_json()
    assert TrainConfig.from_json(ours.to_json()) == ours
    assert ours.checkpoint_path() == ref.checkpoint_path()
    extra = json.loads(ours.to_json())
    extra["unknown_field"] = 1
    assert TrainConfig.from_json(json.dumps(extra)) == ours
