"""The port's host data pipeline against the JAX package's: ``IDRIDDataset``
(patch and full-image mode, one lesion and ``ALL``), ``BasicDataset``,
``Loader`` and ``native``, on the same synthetic fundus set.  Every array
must be equal, bit for bit: the port's host code is a copy of the same
numpy / PIL / cv2 code."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vaeunet_tpu import native as jax_native
from vaeunet_tpu.data.dataset import IDRIDDataset as JaxIDRIDDataset
from vaeunet_tpu.data.generic import BasicDataset as JaxBasicDataset
from vaeunet_tpu.data.loader import Loader as JaxLoader

from vaeunet_tpu_torch import native
from vaeunet_tpu_torch.data import BasicDataset, IDRIDDataset, Loader
from vaeunet_tpu_torch.data.dataset import _resize_bilinear_np, _write_atomic


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    """tests/test_data.py's synthetic set (dark background, bright circle,
    small lesion blobs), with HE masks on half the images so that
    ``lesion_type='ALL'`` has two non-empty channels."""
    root = tmp_path_factory.mktemp("idrid")
    rng = np.random.RandomState(0)
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        (root / "imgs" / split).mkdir(parents=True)
        for lt in ("EX", "HE"):
            (root / "masks" / split / lt).mkdir(parents=True)
        for i in range(n):
            h, w = 96, 128
            img = np.zeros((h, w, 3), np.uint8)
            yy, xx = np.mgrid[0:h, 0:w]
            circle = (yy - h // 2) ** 2 + (xx - w // 2) ** 2 < (h // 2 - 4) ** 2
            img[circle] = rng.randint(60, 200, (circle.sum(), 3))
            mask = np.zeros((h, w), np.uint8)
            cy, cx = rng.randint(30, 60), rng.randint(40, 80)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < 36
            mask[blob & circle] = 255
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray(mask).save(root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
            if i % 2 == 0:
                he = np.zeros((h, w), np.uint8)
                he[(yy - cx // 2) ** 2 + (xx - cy) ** 2 < 50] = 255
                Image.fromarray(he).save(root / "masks" / split / "HE" / f"IDRiD_{i:02d}_HE.tif")
    return root


def pair(synth_data, tmp_path, **kw):
    """The same dataset built by both packages, each with its own cache."""
    ours = IDRIDDataset(str(synth_data), cache_dir=str(tmp_path / "torch"), **kw)
    theirs = JaxIDRIDDataset(str(synth_data), cache_dir=str(tmp_path / "jax"), **kw)
    return ours, theirs


def assert_same_samples(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["img_id"] == b["img_id"] and a["coords"] == b["coords"]
        assert a["has_lesion"] == b["has_lesion"]
        for k in ("image", "mask"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", [
    dict(split="train", lesion_type="EX", patch_size=32, balance_seed=0),
    dict(split="train", lesion_type="EX", patch_size=32, balance_seed=3, oversample_lesion=20.0),
    dict(split="val", lesion_type="EX", patch_size=32),
    dict(split="test", lesion_type="EX", patch_size=48),
    dict(split="train", lesion_type="ALL", patch_size=32, balance_seed=0),
    dict(split="train", lesion_type="EX", patch_size=32, balance_seed=0,
         skip_border_check=True, scale=0.75),
], ids=["train", "oversample", "val", "test", "all", "no-border-scale"])
def test_patch_dataset_equals_jax(synth_data, tmp_path, kw):
    kw.setdefault("scale", 1.0)
    ours, theirs = pair(synth_data, tmp_path, **kw)
    assert ours.patch_index == theirs.patch_index
    assert ours.meta == theirs.meta
    assert ours.patch_size == theirs.patch_size and ours.stride == theirs.stride
    assert_same_samples(ours, theirs)
    for img_id in ours.unique_image_ids():
        for a, b in zip(ours.get_image_and_mask(img_id), theirs.get_image_and_mask(img_id)):
            np.testing.assert_array_equal(a, b)
    if kw["lesion_type"] == "ALL":
        assert ours[0]["mask"].shape[-1] == 5


@pytest.mark.parametrize("lesion", ["EX", "ALL"])
def test_full_image_dataset_equals_jax(synth_data, tmp_path, lesion):
    ours, theirs = pair(synth_data, tmp_path, split="val", scale=0.5, lesion_type=lesion)
    assert ours.is_full_image and ours.patch_size == theirs.patch_size
    assert_same_samples(ours, theirs)
    assert ours.gather_batch([0, 1]) is None       # no uint8 cache in full-image mode


def test_cache_is_reused_and_keyed_apart_from_jax(synth_data, tmp_path, monkeypatch):
    a = IDRIDDataset(str(synth_data), split="val", scale=1.0, patch_size=32,
                     cache_dir=str(tmp_path))
    b = IDRIDDataset(str(synth_data), split="val", scale=1.0, patch_size=32,
                     cache_dir=str(tmp_path))
    assert a.cache_dir == b.cache_dir and (a.cache_dir / "meta.json").exists()
    assert b.patch_index == a.patch_index
    monkeypatch.delenv("VAEUNET_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    c = IDRIDDataset(str(synth_data), split="val", scale=1.0, patch_size=32)
    assert ".cache/vaeunet_tpu_torch/" in str(c.cache_dir)
    monkeypatch.setenv("VAEUNET_CACHE_DIR", str(tmp_path / "env"))
    d = IDRIDDataset(str(synth_data), split="val", scale=1.0, patch_size=32)
    assert str(d.cache_dir).startswith(str(tmp_path / "env"))


def test_cache_write_is_all_or_nothing(tmp_path):
    """A write that fails half-way leaves the old file whole and no
    temporary file behind."""
    path = tmp_path / "meta.json"
    path.write_bytes(b"old")

    def half(f):
        f.write(b"new, half")
        raise OSError("disk full")

    with pytest.raises(OSError):
        _write_atomic(path, half)
    assert path.read_bytes() == b"old" and sorted(tmp_path.iterdir()) == [path]
    _write_atomic(path, lambda f: f.write(b"new"))
    assert path.read_bytes() == b"new" and sorted(tmp_path.iterdir()) == [path]


def test_concurrent_builds_of_one_cache_all_succeed(synth_data, tmp_path):
    """Data-parallel ranks build the same cache at once, one a little after
    the other: each must read whole files (a reader met a half-written
    ``.npz`` when the files were written in place)."""
    rng = np.random.RandomState(0)
    for r in range(40):
        out = []

        def build(delay):
            time.sleep(delay)
            try:
                ds = IDRIDDataset(str(synth_data), split="val", scale=1.0, patch_size=32,
                                  cache_dir=str(tmp_path / f"c{r}"))
                out.append(ds.patch_index)
            except Exception as e:       # noqa: BLE001 - any failure is the finding
                out.append(e)

        threads = [threading.Thread(target=build, args=(d,))
                   for d in (0.0, *rng.uniform(0, 0.03, 3))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and len(out) == len(threads)
        assert all(o == out[0] for o in out) and not isinstance(out[0], Exception), (r, out)


@pytest.mark.parametrize("split", ["train", "val"])
def test_native_batch_gather_equals_jax_and_the_samples(synth_data, tmp_path, split):
    ours, theirs = pair(synth_data, tmp_path, split=split, scale=1.0, patch_size=32,
                        lesion_type="EX", balance_seed=1)
    idx = np.random.RandomState(0).permutation(len(ours))[:6]
    a, b = ours.gather_batch(idx), theirs.gather_batch(idx)
    assert a["img_id"] == b["img_id"]
    for k in ("image", "mask"):
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], np.stack([ours[int(i)][k] for i in idx]))


def test_basic_dataset_equals_jax(tmp_path):
    rng = np.random.RandomState(1)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "masks").mkdir()
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (40, 56, 3), np.uint8)).save(
            tmp_path / "imgs" / f"car{i}.jpg")
        if i != 1:                                     # car1 has no mask: all zero
            Image.fromarray((rng.rand(40, 56) > 0.5).astype(np.uint8) * 255).save(
                tmp_path / "masks" / f"car{i}_mask.gif")
    ours = BasicDataset(str(tmp_path / "imgs"), str(tmp_path / "masks"), scale=0.5)
    theirs = JaxBasicDataset(str(tmp_path / "imgs"), str(tmp_path / "masks"), scale=0.5)
    assert ours.ids == theirs.ids == ["car0", "car1", "car2"]
    for i in range(3):
        for k in ("image", "mask"):
            np.testing.assert_array_equal(ours[i][k], theirs[i][k])
    assert not ours[1]["mask"].any()


@pytest.mark.parametrize("index_only", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_equals_jax(synth_data, tmp_path, shuffle, index_only):
    """Shuffled (seeded, drop_last) and in-order (padded last batch)
    batches: the same indices, pixels, ids and true counts."""
    ours, theirs = pair(synth_data, tmp_path, split="train", scale=1.0, patch_size=32,
                        lesion_type="EX", balance_seed=0)
    la = Loader(ours, 4, shuffle=shuffle, seed=5, index_only=index_only)
    lb = JaxLoader(theirs, 4, shuffle=shuffle, seed=5, index_only=index_only)
    assert len(la) == len(lb)
    for _ in range(2):                                 # two epochs: the shuffle advances
        batches = list(zip(la, lb))
        assert len(batches) == len(la)
        for a, b in batches:
            assert a.keys() == b.keys() and a["count"] == b["count"]
            for k in a:
                if k != "count":
                    np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    if not shuffle:
        assert batches[-1][0]["count"] == len(ours) - 4 * (len(la) - 1)


def test_native_builds_outside_the_package():
    assert native.available(), "g++ is installed: the library must build"
    native.require()
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert "vaeunet_tpu_torch" not in str(path.relative_to(path.parents[2]))
    # the Makefile (the build by hand) keeps the flags of the build at first use
    makefile = (Path(native.__file__).parent / "Makefile").read_text()
    line = next(ln for ln in makefile.splitlines() if ln.startswith("CXXFLAGS"))
    assert tuple(line.split("?=")[1].split()) == native.CXXFLAGS


def fallback(monkeypatch):
    """The numpy fallbacks: the library reported unavailable."""
    monkeypatch.setattr(native, "_load", lambda: None)


def test_native_gather_equals_jax_and_its_fallback(monkeypatch):
    rng = np.random.RandomState(0)
    images = [np.ascontiguousarray(rng.randint(0, 256, (40, 50, 3), np.uint8)) for _ in range(5)]
    masks = [np.ascontiguousarray(rng.randint(0, 2, (40, 50), np.uint8) * 255) for _ in range(5)]
    coords = np.stack([rng.randint(0, 20, 5), rng.randint(0, 30, 5)], 1).astype(np.int32)
    a = native.gather_patch_batch(images, masks, coords, 16)
    b = jax_native.gather_patch_batch(images, masks, coords, 16)
    with pytest.raises(ValueError, match="outside"):
        native.gather_patch_batch(images, masks, coords + 30, 16)
    fallback(monkeypatch)
    c = native.gather_patch_batch(images, masks, coords, 16)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def test_native_blend_and_resize_equal_jax_and_their_fallbacks(monkeypatch):
    rng = np.random.RandomState(2)
    tiles = rng.rand(4, 16, 16).astype(np.float32)
    weights = rng.rand(16, 16).astype(np.float32) + 0.1
    coords = np.array([[0, 0], [0, 8], [8, 0], [8, 8]], np.int32)
    img = rng.rand(37, 53, 3).astype(np.float32)
    sizes = ((74, 106), (20, 31))
    blend = native.feathered_blend(tiles, weights, coords, (24, 24))
    np.testing.assert_array_equal(blend,
                                  jax_native.feathered_blend(tiles, weights, coords, (24, 24)))
    resized = [native.resize_bilinear(img, hw) for hw in sizes]
    for r, hw in zip(resized, sizes):
        np.testing.assert_array_equal(r, jax_native.resize_bilinear(img, hw))
        np.testing.assert_array_equal(r, _resize_bilinear_np(img, hw))
    fallback(monkeypatch)
    np.testing.assert_array_equal(blend, native.feathered_blend(tiles, weights, coords, (24, 24)))
    for r, hw in zip(resized, sizes):
        np.testing.assert_array_equal(r, native.resize_bilinear(img, hw))
