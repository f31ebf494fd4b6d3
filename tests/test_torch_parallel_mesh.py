"""The port's mesh, launcher and collectives (``vaeunet_tpu_torch/parallel/
mesh.py``, ``ops/collectives.py``) on the CPU: gloo ranks in fresh
processes (``parallel.launch``, a FileStore in ``tmp_path``; rank bodies in
``tests/torch_dist_workers.py``), never a process group in this one.

The rows a rank holds are checked against JAX's ``P('data')`` split of the
same array on a 2-device mesh of the session's 8 CPU devices; the mesh's
axes against JAX ``make_mesh``'s.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from vaeunet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vaeunet_tpu.parallel.mesh import shard_batch as jax_shard_batch

from vaeunet_tpu_torch.ops.sampling import fold_in
from vaeunet_tpu_torch.parallel import ParallelContext, launch, shard_batch
from vaeunet_tpu_torch.parallel.mesh import backend_for, mesh_device, rank_rows
from tests import torch_dist_workers as workers


@pytest.fixture(autouse=True)
def _no_process_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _ctx(n_data: int, data_rank: int) -> ParallelContext:
    """A context for the row arithmetic alone (no process group)."""
    return ParallelContext(rank=data_rank, world_size=n_data, n_data=n_data, n_model=1,
                           data=None, model=None, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("n_data", [1, 2, 4, 8])
def test_rank_rows_are_jax_data_shards(n_data):
    """accum = 1: rank r holds the rows JAX's ``P('data')`` puts on device r."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    mesh = jax_make_mesh(n_data, devices=jax.devices()[:n_data])
    sharded = jax_shard_batch(mesh, jnp.asarray(x))
    by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for r, dev in enumerate(mesh.devices[:, 0]):
        np.testing.assert_array_equal(x[rank_rows(16, n_data, r)], by_device[dev])
        np.testing.assert_array_equal(shard_batch(_ctx(n_data, r), x).numpy(), by_device[dev])


@pytest.mark.parametrize("n_data,accum", [(2, 2), (2, 4), (4, 2)])
def test_rank_rows_split_each_microbatch(n_data, accum):
    """accum > 1: microbatch i of every rank together is rows
    i*n/accum ... (i+1)*n/accum - 1 of the global batch, in rank order."""
    n = 16
    rows = [rank_rows(n, n_data, r, accum) for r in range(n_data)]
    micro = n // (n_data * accum)
    for i in range(accum):
        together = np.concatenate([r[i * micro:(i + 1) * micro] for r in rows])
        np.testing.assert_array_equal(together, np.arange(i * n // accum, (i + 1) * n // accum))
    np.testing.assert_array_equal(np.sort(np.concatenate(rows)), np.arange(n))


def test_rank_rows_refuse_a_ragged_split():
    with pytest.raises(ValueError, match="not divisible"):
        rank_rows(6, 4, 0)
    with pytest.raises(ValueError, match="not divisible"):
        rank_rows(8, 2, 0, accum=3)


def test_shard_batch_takes_torch_tensors_and_several_arrays():
    x = torch.arange(24.0).reshape(8, 3)
    m = np.arange(8)
    a, b = shard_batch(_ctx(2, 1), x, m, accum=2)
    torch.testing.assert_close(a, x[[2, 3, 6, 7]])
    np.testing.assert_array_equal(b.numpy(), [2, 3, 6, 7])


def test_backend_choice(monkeypatch):
    """gloo on the CPU; NCCL with a card a rank; fewer cards than ranks
    raise unless the ranks may share them (then gloo); no CUDA raises."""
    assert backend_for(4, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backend_for(2, "cuda") == "nccl"
    with pytest.raises(ValueError, match="requested 4 devices, have 2"):
        backend_for(4, "cuda")
    assert backend_for(4, "cuda", share_devices=True) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend_for(1, "cuda")


def test_fold_in_gives_each_rank_its_stream():
    seeds = [fold_in(12345, r) for r in range(8)]
    assert len(set(seeds)) == 8 and all(0 <= s < 2 ** 64 for s in seeds)
    assert fold_in(12345, 1) == fold_in(12345, 1) != fold_in(12346, 1)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return launch(workers.collective_checks, 2, args=(3,), device="cpu", timeout=120,
                  workdir=str(tmp_path_factory.mktemp("mesh")))


def test_collective_values(two_ranks):
    for r, out in enumerate(two_ranks):
        assert out["rank"] == r and out["backend"] == "gloo"
        assert out["shape"] == {"data": 2, "model": 1}
        torch.testing.assert_close(out["sum"], torch.tensor([[10.0, 12.0, 14.0]]))
        torch.testing.assert_close(out["gather"], torch.tensor([[0.0, 1, 2], [10, 11, 12]]))


def test_collective_gradients(two_ranks):
    """d/dx of 2 Σ all_reduce_sum(x) + Σ w·gather(x) + 3 Σ copy_to_group(x)
    on each rank: 2·2 + 2·w[own rows] + 3·2 (each backward sums the two
    ranks' cotangents)."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, out in enumerate(two_ranks):
        np.testing.assert_array_equal(out["grad"].numpy(), 4 + 2 * w[r:r + 1] + 6)


def test_gather_keeps_channels_last_and_bf16_exact(two_ranks):
    ys = [out["y"] for out in two_ranks]
    for out in two_ranks:
        assert out["gy_channels_last"]
        torch.testing.assert_close(out["gy"], torch.cat(ys, 1), rtol=0, atol=0)
        assert out["yb"].dtype == torch.bfloat16
        assert torch.equal(out["yb"], torch.cat([y.to(torch.bfloat16) for y in ys]))


def test_two_by_two_mesh_groups(tmp_path):
    """A (data 2, model 2) mesh: rank = data index * 2 + model index, as
    JAX ``make_mesh(4, model_axis=2)`` lays its devices; the data group
    sums over the ranks of one model index."""
    jmesh = jax_make_mesh(4, model_axis=2, devices=jax.devices()[:4])
    assert dict(jmesh.shape) == {"data": 2, "model": 2}
    outs = launch(workers.collective_checks, 4, args=(2,), device="cpu", timeout=120,
                  model_axis=2, workdir=str(tmp_path))
    for r, out in enumerate(outs):
        assert out["shape"] == dict(jmesh.shape)
        assert (out["data_rank"], out["model_rank"]) == divmod(r, 2)
        m = r % 2
        torch.testing.assert_close(out["sum"], torch.tensor([[0.0, 1]]) * 2 + 10 * (m + m + 2))


def test_make_mesh_refusals(tmp_path):
    """More devices than ranks raise as JAX's ``mesh.py:28-29``; so do
    fewer, and a model axis that does not divide them."""
    (out, _) = launch(workers.mesh_refusals, 2, device="cpu", timeout=120,
                      workdir=str(tmp_path))
    assert out["more"] == "requested 3 devices, have 2"
    assert "each rank is one device" in out["fewer"]
    assert "model axis 3" in out["axis"]
    if torch.cuda.is_available():
        assert out["default"] == "cuda"
    else:
        assert "no CUDA device is available" in out["default"]
    assert out["cpu"] == "cpu"


def test_mesh_device_is_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    """No device: a gloo rank takes ``resolve_device``'s CUDA (refused
    where there is none), an NCCL rank the card of its local rank; the CPU
    only where it is asked for, and never under NCCL."""
    assert mesh_device("cpu", "gloo", 1) == torch.device("cpu")
    with pytest.raises(ValueError, match="NCCL group runs on CUDA"):
        mesh_device("cpu", "nccl", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        mesh_device(None, "gloo", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mesh_device(None, "gloo", 3) == torch.device("cuda")
    assert mesh_device(None, "nccl", 6) == torch.device("cuda", 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh_device(None, "nccl", 6) == torch.device("cuda", 1)


def test_a_failing_rank_fails_the_launch(tmp_path):
    """A rank's exception ends every rank and reaches the caller, with no
    wait for the others' 60 s."""
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch(workers.failing_rank, 2, device="cpu", timeout=120, workdir=str(tmp_path))


def test_the_time_limit_ends_the_ranks(tmp_path):
    with pytest.raises(TimeoutError, match="still running"):
        launch(workers.sleeping_rank, 2, args=(120.0,), device="cpu", timeout=8,
               workdir=str(tmp_path))


def test_world_one_is_the_single_step(tmp_path):
    """On one rank the global-batch step with the augmentation and drawn
    noise equals ``make_train_step``'s, bit for bit, over two steps
    (parameters, statistics, aux and the generator's state)."""
    rng = np.random.RandomState(0)
    images = rng.rand(2, 32, 32, 3).astype(np.float32)
    masks = (rng.rand(2, 32, 32, 1) > 0.9).astype(np.float32)
    cfg = dict(model_type="resnet", backbone="resnet18", batch_size=2,
               gradient_accumulation_steps=1, amp=False, patch_size=32, learning_rate=1e-3)
    (out,) = launch(workers.dp_world_one, 1, args=(cfg, None, images, masks, 0.001),
                    device="cpu", timeout=240, workdir=str(tmp_path))
    assert out == {"aux": True, "state": True, "generator": True}


def test_the_rank_bodies_import_no_jax():
    """The ranks import ``tests/torch_dist_workers.py``: no jax, nothing of
    the JAX package (a rank started under this session's ``XLA_FLAGS``
    would otherwise load jax)."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; import tests.torch_dist_workers; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'vaeunet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
