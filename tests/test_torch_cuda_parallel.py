"""The port's parallel paths on the card (marker ``cuda``; skipped without
one, decided in a fixture).  Two ranks share one card over gloo, whose
CUDA support covers the ``all_reduce`` the collectives build on (NCCL
takes over where each rank has a card of its own); one rank runs over
NCCL.  The rank bodies are ``tests/torch_dist_workers.py``'s; the sizes
and bounds are the CPU tests' (``tests/test_torch_parallel_*.py``), in
fp32 with TF32 off.  On the card's machine (no jax there):

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from vaeunet_tpu_torch.parallel import launch
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

# by its own name, from tests/ (pytest puts it on the path): on the card's
# machine an installed package is called ``tests`` too
import torch_dist_workers as workers  # noqa: E402

pytestmark = pytest.mark.cuda

HW, GLOBAL, LR, BETA = 64, 4, 1e-3, 0.001
CFG = dict(model_type="resnet", backbone="resnet18", batch_size=GLOBAL,
           gradient_accumulation_steps=1, amp=False, patch_size=HW, learning_rate=LR, seed=0)


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _data():
    rng = np.random.RandomState(3)
    images = rng.rand(GLOBAL, HW, HW, 3).astype(np.float32)
    masks = (rng.rand(GLOBAL, HW, HW, 1) > 0.9).astype(np.float32)
    eps = rng.randn(1, GLOBAL, 32).astype(np.float32)
    e_images = rng.rand(GLOBAL, HW, HW, 3).astype(np.float32)
    e_masks = (rng.rand(GLOBAL, HW, HW, 1) > 0.8).astype(np.float32)
    e_eps = rng.randn(GLOBAL, 32).astype(np.float32)
    return images, masks, eps, (e_images, e_masks, e_eps, np.array([1, 1, 1, 0], np.float32))


def assert_grads_match(grads: dict, ref: dict, head: str = "final_conv") -> None:
    """``tests/torch_train_parity.py``'s gradient bounds (that module
    imports jax, which the card's machine lacks): the whole by relative L2
    within 0.25, the output conv `head` (which no BN follows) per element
    within 1e-3 of its max |g|.  A mean taken as a sum or a rank's rows
    dropped fail the head check at once."""
    assert set(grads) == set(ref)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    ours = torch.cat([grads[k].flatten() for k in ref])
    theirs = torch.cat([v.flatten() for v in ref.values()])
    assert ((ours - theirs).norm() / theirs.norm()).item() <= 0.25
    for k in (f"{head}.weight", f"{head}.bias"):
        tol = 1e-3 * ref[k].abs().max().item()
        assert (grads[k] - ref[k]).abs().max().item() <= tol, k


def test_collectives_on_cuda_tensors_over_gloo(tmp_path):
    outs = launch(workers.collective_checks, 2, args=(3,), device="cuda", share_devices=True,
                  timeout=300, workdir=str(tmp_path))
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, out in enumerate(outs):
        assert out["backend"] == "gloo"
        torch.testing.assert_close(out["sum"], torch.tensor([[10.0, 12.0, 14.0]]))
        np.testing.assert_array_equal(out["grad"].numpy(), 4 + 2 * w[r:r + 1] + 6)
        assert out["gy_channels_last"]


def test_dp_global_step_on_the_card_matches_the_one_rank_step(tmp_path):
    images, masks, eps, eval_batch = _data()
    config = TrainConfig(**CFG)
    state = create_train_state(config, seed=0, device="cuda")
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    aux = make_train_step(config, state.model).compute_gradients(state, images, masks, BETA,
                                                                 eps=eps)
    ref_grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
    state.optimizer.step()
    ref = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    outs = launch(workers.dp_steps, 2, args=(CFG, sd, images, masks, eps, BETA, eval_batch),
                  device="cuda", share_devices=True, timeout=600, workdir=str(tmp_path))
    for out in outs:
        assert abs(out["global_aux"]["loss"].item() - aux["loss"].item()) <= 1e-5
        assert_grads_match(out["global_grads"], ref_grads)
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            got = out["global_state"][k]
            if "running_" in k:
                torch.testing.assert_close(got, v, atol=1e-4, rtol=1e-3, msg=k)
            else:
                torch.testing.assert_close(got, v, atol=2 * LR + 1e-6, rtol=0, msg=k)
    a, b = outs[0]["global_state"], outs[1]["global_state"]
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_world_one_over_nccl_is_the_single_step(tmp_path):
    images, masks, _, _ = _data()
    (out,) = launch(workers.dp_world_one, 1, args=(CFG, None, images, masks, BETA),
                    device="cuda", timeout=300, workdir=str(tmp_path))
    assert out == {"aux": True, "state": True, "generator": True}


def test_tp_step_on_the_card(tmp_path):
    """The channel-sharded step's clip norm counts the whole gradient and
    the model ranks agree bit for bit."""
    images, masks, eps, _ = _data()
    config = TrainConfig(**dict(CFG, batch_size=2))
    sd = {k: v.detach().cpu() for k, v in
          create_train_state(config, seed=0, device="cuda").model.state_dict().items()}
    outs = launch(workers.tp_steps, 2,
                  args=(dict(CFG, batch_size=2), sd, images[:2], masks[:2], eps[:, :2], BETA, 128),
                  device="cuda", share_devices=True, model_axis=2, timeout=600,
                  workdir=str(tmp_path))
    for out in outs:
        assert out["clip_norm"] == pytest.approx(out["full_norm"], rel=1e-5)
    assert all(torch.equal(outs[0]["state"][k], outs[1]["state"][k]) for k in outs[0]["state"])
