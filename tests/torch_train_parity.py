"""Shared set-up of the train- and eval-step parity tests: the port against
the JAX package on the CPU, resnet18 VAE-UNet ('all'), 64^2, fp32, batch 2
(or 4 under accumulation 2, so a microbatch is 2 and not the degenerate
1, where the BN over the broadcast latent has zero variance).

Both sides start from one seeded flax init (batch statistics randomized,
since fresh (0, 1) statistics would hide a mapping fault), carried into the
port by ``compat/jax_weights.py``.  The latent noise comes from numpy and
is fed to JAX by patching ``vaeunet_tpu.ops.sampling.gaussian_like`` for
the test (the package itself is unchanged) and to the port as ``eps``.

Tolerances: loss and recon_loss atol 1e-5 plus rtol 2e-6; mu and logvar
atol 1e-4, the harness bound of the forward parity tests (training-mode BN
at layer4 normalizes over only 2 x 2 x 2 values, or 4 in a microbatch of
1, and carries fp32 rounding to ~1e-4); kl_loss the first-order bound
that the mu / logvar tolerance implies, 1e-4 * mean_b sum_d (|mu| +
|e^logvar - 1| / 2) (the KL of the randomized init is ~19); parameters
after the step atol 2 lr (+ 1e-6 for the fp32 rounding of p +- lr), since
the first Adam step is lr g / (|g| + eps), whose sign can flip where |g|
is near 0; running statistics atol 1e-4 plus
rtol 1e-3 (downstream of the latent BNs the activations of the two sides
drift apart by ~1e-4, see below, and the gate's BNs average them).

Gradients: this model's training-mode gradient at these sizes is chaotic
in fp32 rounding.  The batch-statistics BNs over the broadcast latent see
as many distinct values per channel as there are images, the gate's
one-channel BN and the ReLUs pass differences on, and a tensor's gradient
can move by several per cent for a 1e-6 relative nudge of the images: the
JAX package's own two exact decoder lowerings (``fused_decoder`` True and
False) differ by 2-8 % (relative L2) on the same batch.  So the whole
gradient is held to relative L2 <= 0.25 against ``jax.grad`` (measured
0.05-0.10; a fold that drops or halves the sum-of-squares cotangent, or
drops the sum's, gives 1.0 to 35), every parameter must receive a finite
gradient (a cut graph leaves ``None``), and ``final_conv``, which no BN
follows, is held to 1e-3 of its max |g|.  The kernels' own backward
passes are held per element in ``tests/test_torch_train_ops.py``.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import vaeunet_tpu.ops.sampling as jax_sampling
from vaeunet_tpu.losses import make_criterion as jax_make_criterion
from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet
from vaeunet_tpu.training.config import TrainConfig as JaxTrainConfig
from vaeunet_tpu.training.state import create_train_state as jax_create_train_state
from vaeunet_tpu.training.step import _forward_loss as jax_forward_loss

from vaeunet_tpu_torch.compat.jax_weights import convert_jax_unet_resnet
from vaeunet_tpu_torch.training import TrainConfig, create_train_state

HW, BATCH, LATENT, LR, BETA = 64, 2, 32, 1e-3, 0.001


def config_kwargs(accum: int) -> dict:
    return dict(model_type="resnet", backbone="resnet18", batch_size=BATCH * accum,
                gradient_accumulation_steps=accum, amp=False, patch_size=HW,
                learning_rate=LR, seed=0)


@functools.lru_cache(maxsize=None)
def jax_variables():
    """A seeded flax init (eager: no jit compile) with randomized
    batch statistics, as numpy."""
    model = JaxUNetResNet(3, 1, backbone="resnet18")
    variables = model.init({"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
                           jnp.zeros((1, HW, HW, 3)), train=False, sample=False)
    rng = np.random.RandomState(2)

    def randomize(path, leaf):
        if path[-1].key == "mean":
            return rng.normal(0, 0.5, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)

    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(randomize, variables["batch_stats"])}


def batch(seed: int = 3, n: int = BATCH):
    """`n` images uniform in [0, 1), masks uniform > 0.9 (the bench's
    batch), and one noise block [BATCH, LATENT]."""
    rng = np.random.RandomState(seed)
    images = rng.rand(n, HW, HW, 3).astype(np.float32)
    masks = (rng.rand(n, HW, HW, 1) > 0.9).astype(np.float32)
    eps = rng.randn(BATCH, LATENT).astype(np.float32)
    return images, masks, eps


def feed_jax_noise(monkeypatch, eps: np.ndarray) -> None:
    """JAX's reparameterize draws through ``gaussian_like`` at trace time:
    hand it `eps` (its leading rows, in the shape asked for)."""
    def gaussian_like(rng, shape, dtype=jnp.float32):
        n = int(np.prod(shape[:-1]))
        return jnp.asarray(eps.reshape(-1, shape[-1])[:n], dtype).reshape(shape)
    monkeypatch.setattr(jax_sampling, "gaussian_like", gaussian_like)


def jax_state(accum: int):
    config = JaxTrainConfig(**config_kwargs(accum))
    v = jax.tree.map(jnp.asarray, jax_variables())
    return config, jax_create_train_state(config, jax.random.PRNGKey(0), variables=v)


def port_state(accum: int):
    config = TrainConfig(**config_kwargs(accum))
    return config, create_train_state(config, seed=0, variables=jax_variables(), device="cpu")


def jax_grads(config, params, batch_stats, images, masks):
    """``jax.grad`` of the JAX step's ``_forward_loss`` -> (grads, stats, aux)."""
    model = JaxUNetResNet(3, 1, backbone="resnet18")
    fn = jax.jit(jax.grad(functools.partial(jax_forward_loss, model,
                                            jax_make_criterion("EX"), config), has_aux=True))
    grads, (stats, aux) = fn(params, batch_stats, jnp.asarray(images), jnp.asarray(masks),
                             jax.random.PRNGKey(5), jnp.float32(BETA))
    return grads, stats, aux


def as_state_dict(params, batch_stats) -> dict:
    """A flax (params, batch_stats) pair in the port's state-dict names."""
    tree = {"params": jax.tree.map(np.asarray, params),
            "batch_stats": jax.tree.map(np.asarray, batch_stats)}
    return convert_jax_unet_resnet(tree)


def assert_grads_match(model: torch.nn.Module, ref: dict, head: str = "final_conv") -> None:
    """The whole gradient by relative L2, the output conv `head` (which no
    BN follows) per element."""
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) <= set(ref)
    assert all(g is not None for g in grads.values()), \
        [k for k, g in grads.items() if g is None]
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    ours = torch.cat([g.flatten() for g in grads.values()])
    theirs = torch.cat([ref[k].flatten() for k in grads])
    rel = ((ours - theirs).norm() / theirs.norm()).item()
    assert rel <= 0.25, f"gradient differs from jax.grad by {rel} (relative L2)"
    for k in (f"{head}.weight", f"{head}.bias"):
        tol = 1e-3 * ref[k].abs().max().item()
        err = (grads[k] - ref[k]).abs().max().item()
        assert err <= tol, f"{k}: grad differs by {err} > {tol}"


def assert_aux_matches(aux: dict, ref: dict) -> None:
    for k in ("loss", "recon_loss"):
        np.testing.assert_allclose(aux[k].item(), float(np.asarray(ref[k])), atol=1e-5,
                                   rtol=2e-6, err_msg=k)
    mu, logvar = np.asarray(ref["mu"]), np.asarray(ref["logvar"])
    kl_tol = 1e-4 * np.mean(np.sum(np.abs(mu) + 0.5 * np.abs(np.expm1(logvar)), axis=1))
    np.testing.assert_allclose(aux["kl_loss"].item(), float(np.asarray(ref["kl_loss"])),
                               atol=kl_tol, rtol=0, err_msg="kl_loss")
    for k in ("mu", "logvar"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)


def assert_state_matches(model: torch.nn.Module, ref: dict) -> None:
    """Parameters within 2 lr, running statistics within 1e-4 + 1e-3 |ref|."""
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            torch.testing.assert_close(v, ref[k], atol=1e-4, rtol=1e-3, msg=k)
        else:
            torch.testing.assert_close(v, ref[k], atol=2 * LR + 1e-6, rtol=0, msg=k)
