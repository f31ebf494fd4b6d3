"""Tensor parallelism where the VAE-UNet test (``test_torch_parallel_tp.py``)
does not reach, on the CPU: the plain UNet, whose 2x2 transposed convs the
rule shards on their input channels (row-parallel), and TP composed with
remat 'save_convs' on the resnet18 VAE-UNet.  Each runs on a (data 1,
model 2) mesh of two gloo ranks (one launch for both) against the port's
unsharded step on the same weights and batch (64^2, fp32, batch 2;
``min_channels`` 256 for the UNet, which shards up1-3.up and every conv of
256 or more output channels, and 128 for the VAE-UNet, as JAX's TP tests
take it).

Tolerances: the eval forward atol 1e-5 (the sharded convs sum over the same
inputs, only split differently); the clip's norm against the whole
gathered gradient's, rtol 1e-5; the gradient by relative L2 <= 1e-4 and
the output conv (which no BN follows) per element within 1e-3 of its max
|g|, as ``chip_smoke.py`` phase 15(b) holds the TP gradient: a backward
that sums where it should not (the row-parallel sum's, or the kept
products replayed against the wrong weight) is off by a factor of 2 or
more; the step as ``tests/torch_train_parity.py`` holds a step (loss
1e-5, parameters 2 lr, running statistics 1e-4 + 1e-3 |ref|).

The plain UNet's gradient is held to the unsharded model's with each
sharded transposed conv summing its two input-channel halves as the ranks
do (:class:`HandSplitConvTranspose2x`, the same function: its forward is
held to the unsharded one at 1e-5).  Against the unsharded step itself the
training-mode gradient differs by more than 1e-3 here, as much as one
process's gradient of the same batch with its two rows swapped: the BN
moments (var = q/n - mean^2) and the BNs after them amplify a sum taken
in another order, which the row-parallel sum is.  The column-parallel
convs compute each output channel as the whole conv does, so the
VAE-UNet's 'save_convs' gradient is held to the unsharded one directly.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vaeunet_tpu_torch.ops.layers import Conv, ConvTranspose2x
from vaeunet_tpu_torch.parallel import ParallelContext, launch
from vaeunet_tpu_torch.parallel.tp import param_shardings, shard_params
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step
from tests import torch_dist_workers as workers

HW, BATCH, LR, BETA = 64, 2, 1e-3, 0.001
BASE = dict(batch_size=BATCH, gradient_accumulation_steps=1, amp=False, patch_size=HW,
            learning_rate=LR, seed=0)
CFGS = {"unet": dict(model_type="basic", bilinear=False, **BASE),
        "remat": dict(model_type="resnet", backbone="resnet18", use_remat=True,
                      remat_policy="save_convs", **BASE)}
MIN_CHANNELS = {"unet": 256, "remat": 128}
HEAD = {"unet": "outc.conv", "remat": "final_conv"}
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


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(6)
    images = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    masks = (rng.rand(BATCH, HW, HW, 1) > 0.9).astype(np.float32)
    eps = rng.randn(1, BATCH, 32).astype(np.float32)
    return images, masks, eps


class HandSplitConvTranspose2x(ConvTranspose2x):
    """:class:`ConvTranspose2x` with its input channels in two halves whose
    outputs are added, then the bias: the row-parallel ranks' arithmetic
    (their two-rank all-reduce is one commutative addition) in one
    process."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        half = w.shape[0] // 2
        cl = torch.channels_last
        y0, y1 = (F.conv_transpose2d(x[:, i * half:(i + 1) * half].contiguous(memory_format=cl),
                                     w[i * half:(i + 1) * half], None, stride=2
                                     ).contiguous(memory_format=cl) for i in range(2))
        return (y0 + y1) + self.bias.to(x.dtype).view(1, -1, 1, 1)


def _state(kind, hand_split=False):
    """A fresh state of `kind`; `hand_split`: the transposed convs the rule
    shards as :class:`HandSplitConvTranspose2x`."""
    config = TrainConfig(**CFGS[kind])
    state = create_train_state(config, seed=0, device="cpu")
    if hand_split:
        modules = dict(state.model.named_modules())
        for name, dim in param_shardings(state.model, MIN_CHANNELS[kind]).items():
            mod = modules[name.rpartition(".")[0]]
            if dim is not None and type(mod) is ConvTranspose2x:
                mod.__class__ = HandSplitConvTranspose2x
    return config, state


def _sd(kind):
    return {k: v.clone() for k, v in _state(kind)[1].model.state_dict().items()}


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    images, masks, eps = data
    return launch(workers.tp_unet_and_save_convs, 2,
                  args=(CFGS["unet"], _sd("unet"), CFGS["remat"], _sd("remat"), images, masks,
                        eps, BETA, MIN_CHANNELS["unet"], MIN_CHANNELS["remat"]),
                  device="cpu", timeout=400, model_axis=2, threads=THREADS,
                  workdir=str(tmp_path_factory.mktemp("tp_unet")))


@pytest.fixture(scope="module")
def unsharded(data):
    """kind -> (eval logits, gradient, step aux, state after the step); the
    plain UNet's hand split under "unet_split"."""
    images, masks, eps = data
    out = {}
    for kind, split in (("unet", False), ("unet", True), ("remat", False)):
        feed = None if kind == "unet" else eps
        config, state = _state(kind, split)
        state.model.eval()
        with torch.no_grad():
            x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            logits = state.model(x) if kind == "unet" else state.model(x, sample=False)[0]
        make_train_step(config, state.model).compute_gradients(state, images, masks, BETA,
                                                               eps=feed)
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        config, state = _state(kind, split)
        state, aux = make_train_step(config, state.model)(state, images, masks, BETA, eps=feed)
        out[kind + ("_split" if split else "")] = (logits, grads, aux, state.model.state_dict())
    return out


def test_tp_shards_what_the_rule_names_on_the_plain_unet(ranks):
    """``shard_params`` shards exactly what ``param_shardings`` names: the
    wide convs on their output channels and up1-3's transposed convs
    ([in, out, 2, 2]) on their input channels, both dim 0."""
    _, state = _state("unet")
    want = {n for n, dim in param_shardings(state.model, MIN_CHANNELS["unet"]).items()
            if dim == 0}
    assert {"up1.up.weight", "up2.up.weight", "up3.up.weight"} <= want
    assert "up4.up.weight" not in want
    full = dict(state.model.named_parameters())
    for out in ranks:
        assert set(out["unet"]["sharded"]) == want
        for n, shape in out["unet"]["local_shapes"].items():
            expect = list(full[n].shape)
            if n in want:
                expect[0] //= 2
            assert list(shape) == expect, n


def test_tp_on_save_convs_shards_what_the_rule_names(ranks):
    _, state = _state("remat")
    want = {n for n, dim in param_shardings(state.model, MIN_CHANNELS["remat"]).items()
            if dim == 0}
    assert want and all(set(out["remat"]["sharded"]) == want for out in ranks)


def test_shard_params_raises_for_a_named_weight_it_cannot_shard():
    """A module type without a sharded form whose weight the rule names
    raises instead of staying replicated without a word."""
    model = torch.nn.Sequential(Conv(4, 256, 3, padding=1), torch.nn.Conv2d(256, 256, 1))
    ctx = ParallelContext(rank=0, world_size=2, n_data=1, n_model=2, data=None, model=None,
                          device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="1.weight"):
        shard_params(model, ctx)


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("rank", [0, 1])
def test_tp_eval_forward_matches_unsharded(ranks, unsharded, kind, rank):
    torch.testing.assert_close(ranks[rank][kind]["eval_logits"], unsharded[kind][0],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("rank", [0, 1])
def test_tp_clip_norm_counts_the_whole_gradient(ranks, kind, rank):
    out = ranks[rank][kind]
    assert out["clip_norm"] == pytest.approx(out["full_norm"], rel=1e-5)


def test_hand_split_is_the_unsharded_function(unsharded):
    """The reference the UNet's TP gradient is held to computes the
    unsharded forward (and so the same step)."""
    torch.testing.assert_close(unsharded["unet_split"][0], unsharded["unet"][0], atol=1e-5,
                               rtol=0)
    for k, v in unsharded["unet"][3].items():
        if not k.endswith("num_batches_tracked") and "running_" not in k:
            torch.testing.assert_close(unsharded["unet_split"][3][k], v, atol=2 * LR + 1e-6,
                                       rtol=0, msg=k)


@pytest.mark.parametrize("kind,ref", [("unet", "unet_split"), ("remat", "remat")])
@pytest.mark.parametrize("rank", [0, 1])
def test_tp_gradient_matches_unsharded(ranks, unsharded, kind, ref, rank):
    grads, ref = ranks[rank][kind]["grads"], unsharded[ref][1]
    assert grads.keys() == ref.keys()
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    ours = torch.cat([grads[k].flatten() for k in ref])
    theirs = torch.cat([ref[k].flatten() for k in ref])
    assert ((ours - theirs).norm() / theirs.norm()).item() <= 1e-4
    for k in (f"{HEAD[kind]}.weight", f"{HEAD[kind]}.bias"):
        assert (grads[k] - ref[k]).abs().max() <= 1e-3 * ref[k].abs().max(), k


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("rank", [0, 1])
def test_tp_step_matches_unsharded(ranks, unsharded, kind, rank):
    _, _, aux, sd = unsharded[kind]
    out = ranks[rank][kind]
    for k in ("loss", "recon_loss"):
        if k in aux:
            np.testing.assert_allclose(out["aux"][k].item(), aux[k].item(), atol=1e-5, rtol=2e-6)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(out["state"][k], v), k
        elif "running_" in k:
            torch.testing.assert_close(out["state"][k], v, atol=1e-4, rtol=1e-3, msg=k)
        else:
            torch.testing.assert_close(out["state"][k], v, atol=2 * LR + 1e-6, rtol=0, msg=k)


@pytest.mark.parametrize("kind", list(CFGS))
def test_tp_model_ranks_agree(ranks, kind):
    a, b = ranks[0][kind]["state"], ranks[1][kind]["state"]
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
