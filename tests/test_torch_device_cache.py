"""The port's device cache against the JAX package's, on the CPU: both
gathers, single- and multi-lesion, equal JAX's bit for bit; a batch
gathered from either cache equals the host ``Loader``'s; the indexed train
and eval steps equal the plain steps on the ``Loader``'s batches (the
indexed step against JAX's: ``tests/test_torch_indexed_step.py``)."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from vaeunet_tpu.data import device_cache as jax_cache
from vaeunet_tpu.data.dataset import IDRIDDataset as JaxIDRIDDataset

from vaeunet_tpu_torch.data import IDRIDDataset, Loader
from vaeunet_tpu_torch.data import device_cache
from vaeunet_tpu_torch.data.device_cache import (
    DeviceCache,
    ImageDeviceCache,
    gather_batch_device,
    gather_patch_records_device,
    stage_host_batch,
)
from vaeunet_tpu_torch.training import TrainConfig, create_train_state
from vaeunet_tpu_torch.training import make_eval_step, make_train_step
from tests.torch_train_parity import BETA


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    """Fundus-like set of two image sizes (the image cache pads to the
    largest), EX masks on every image and HE masks on some."""
    root = tmp_path_factory.mktemp("idrid_cache")
    rng = np.random.RandomState(4)
    for split, n in (("train", 3), ("val", 2)):
        (root / "imgs" / split).mkdir(parents=True)
        for lt in ("EX", "HE"):
            (root / "masks" / split / lt).mkdir(parents=True)
        for i in range(n):
            h, w = (64, 80) if i % 2 else (72, 64)
            yy, xx = np.mgrid[0:h, 0:w]
            img = rng.randint(50, 220, (h, w, 3)).astype(np.uint8)
            cy, cx = rng.randint(16, h - 16), rng.randint(16, w - 16)
            mask = (((yy - cy) ** 2 + (xx - cx) ** 2 < 60) * 255).astype(np.uint8)
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray(mask).save(root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
            if i != 1:
                Image.fromarray(np.roll(mask, 9, axis=1)).save(
                    root / "masks" / split / "HE" / f"IDRiD_{i:02d}_HE.tif")
    return root


def datasets(root, tmp_path, lesion, split="train"):
    kw = dict(split=split, scale=1.0, patch_size=32, lesion_type=lesion, balance_seed=0)
    return (IDRIDDataset(str(root), cache_dir=str(tmp_path / "t"), **kw),
            JaxIDRIDDataset(str(root), cache_dir=str(tmp_path / "j"), **kw))


def cpu(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("lesion", ["EX", "ALL"])
def test_caches_and_gathers_equal_jax(synth_data, tmp_path, lesion):
    ours_ds, jax_ds = datasets(synth_data, tmp_path, lesion)
    assert device_cache.estimate_bytes(ours_ds) == jax_cache.estimate_bytes(jax_ds)
    assert device_cache.estimate_image_bytes(ours_ds) == jax_cache.estimate_image_bytes(jax_ds)
    idx = np.random.RandomState(1).permutation(len(ours_ds))[:5]

    ours, theirs = DeviceCache(ours_ds, device="cpu"), jax_cache.DeviceCache(jax_ds)
    np.testing.assert_array_equal(ours.images.numpy(), np.asarray(theirs.images))
    np.testing.assert_array_equal(ours.masks.numpy(), np.asarray(theirs.masks))
    assert ours.img_ids == theirs.img_ids and ours.nbytes == device_cache.estimate_bytes(ours_ds)
    a = gather_batch_device(ours.images, ours.masks, torch.as_tensor(idx))
    b = jax_cache.gather_batch_device(theirs.images, theirs.masks, jnp.asarray(idx))
    for x, y in zip(a, b):
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(ours.fetch(idx), theirs.fetch(idx)):
        np.testing.assert_array_equal(x, y)

    ours, theirs = ImageDeviceCache(ours_ds, device="cpu"), jax_cache.ImageDeviceCache(jax_ds)
    np.testing.assert_array_equal(ours.images.numpy(), np.asarray(theirs.images))
    np.testing.assert_array_equal(ours.masks.numpy(), np.asarray(theirs.masks))
    np.testing.assert_array_equal(ours.records, theirs.records)
    assert ours.nbytes == device_cache.estimate_image_bytes(ours_ds)
    assert ours.masks.dim() == (4 if lesion == "ALL" else 3)
    rec = ours.batch_indices(idx)
    a = ours.make_gather()(ours.images, ours.masks, torch.as_tensor(rec))
    b = theirs.make_gather()(theirs.images, theirs.masks, jnp.asarray(theirs.batch_indices(idx)))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(ours.fetch(idx), theirs.fetch(idx)):
        np.testing.assert_array_equal(x, y)


def test_record_gather_at_every_offset_equals_jax():
    """Random uint8 images, records at the edges and inside, one and five
    mask channels."""
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (3, 20, 24, 3)).astype(np.uint8)
    rec = np.array([[0, 0, 0], [2, 12, 16], [1, 5, 9], [2, 0, 16], [0, 12, 0]], np.int64)
    for masks in (rng.randint(0, 2, (3, 20, 24)).astype(np.uint8),
                  rng.randint(0, 2, (3, 20, 24, 5)).astype(np.uint8)):
        a = gather_patch_records_device(cpu(images), cpu(masks), torch.as_tensor(rec), 8)
        b = jax_cache.gather_patch_records_device(jnp.asarray(images), jnp.asarray(masks),
                                                  jnp.asarray(rec), 8)
        assert a[1].shape == (5, 8, 8, masks.shape[3] if masks.ndim == 4 else 1)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("lesion", ["EX", "ALL"])
def test_gathered_batch_equals_the_loaders(synth_data, tmp_path, lesion):
    """The index-only loader + a cache's gather = the host loader's batch,
    bit for bit (uint8 / 255.0 on both sides)."""
    ds, _ = datasets(synth_data, tmp_path, lesion)
    for cache in (DeviceCache(ds, device="cpu"), ImageDeviceCache(ds, device="cpu")):
        host = Loader(ds, 4, shuffle=True, seed=3, prefetch=0)
        index = Loader(ds, 4, shuffle=True, seed=3, index_only=True)
        gather = cache.make_gather()
        for hb, ib in zip(host, index):
            images, masks = gather(cache.images, cache.masks,
                                   torch.as_tensor(cache.batch_indices(ib["idx"])))
            np.testing.assert_array_equal(images.numpy(), hb["image"])
            np.testing.assert_array_equal(masks.numpy(), hb["mask"])


def test_stage_host_batch_on_the_cpu():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    (t,) = stage_host_batch(torch.device("cpu"), a)
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)


def test_caches_keep_the_device_rule(synth_data, tmp_path, monkeypatch):
    ds, _ = datasets(synth_data, tmp_path, "EX")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageDeviceCache(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCache(ds)


@pytest.mark.parametrize("augment", [False, True])
def test_indexed_steps_equal_plain_steps_on_the_loaders_batch(synth_data, tmp_path, augment):
    """Same seed, same batch: the indexed train step on the image cache and
    the plain step on the host batch leave identical parameters, BN
    buffers and generator states; the indexed eval step gives the plain
    one's metrics and logits."""
    ds, _ = datasets(synth_data, tmp_path, "EX")
    cache = ImageDeviceCache(ds, device="cpu")
    idx = np.arange(4)
    host = ds.gather_batch(idx)
    config = TrainConfig(model_type="resnet", backbone="resnet18", latent_dim=8, batch_size=4,
                         gradient_accumulation_steps=2, amp=False, patch_size=32,
                         learning_rate=1e-3, seed=0)
    states = []
    for indexed in (True, False):
        state = create_train_state(config, seed=0, device="cpu")
        step = make_train_step(config, state.model, augment=augment, indexed=indexed,
                               gather=cache.make_gather() if indexed else None)
        if indexed:
            state, aux = step(state, cache.images, cache.masks, cache.batch_indices(idx), BETA)
        else:
            state, aux = step(state, host["image"], host["mask"], BETA)
        states.append((state, aux))
    (a, aux_a), (b, aux_b) = states
    assert torch.equal(aux_a["loss"], aux_b["loss"])
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())

    ieval = make_eval_step(config, a.model, indexed=True, gather=cache.make_gather())
    peval = make_eval_step(config, a.model)
    valid = torch.tensor([1.0, 1.0, 1.0, 0.0])
    m1, l1 = ieval(cache.images, cache.masks, cache.batch_indices(idx),
                   torch.Generator().manual_seed(1), valid)
    m2, l2 = peval(host["image"], host["mask"], torch.Generator().manual_seed(1), valid)
    assert torch.equal(l1, l2) and all(torch.equal(m1[k], m2[k]) for k in m1)
