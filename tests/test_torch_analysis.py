"""The port's analysis path against the JAX package on the CPU, on the same
resnet34 weights (``tests/test_torch_model.py::resnet34_pair``) and the
same noise: ``analyze_model``, ``fused_probability`` and
``generate_and_compare_ensemble`` over a synthetic IDRiD test split of 2
images of 64x64 (untiled) and 96x80 (64 tiles), N = 3; the dataset's square
fundus crop serves them at 65x65 and 81x81.  ``fused_probability`` takes
its images as given (64x64 and 96x80, with a second member at a smaller
scale).

The noise is JAX's: the port's sampling call is patched to take
``eps = jax.random.normal(sub, (N, 1, D))`` for the `sub` of the JAX
call's key sequence.  Bounds: samples and mean maps atol 2e-4; the CSV
rtol 1e-5 + atol 1e-6 where both analyzers get the same sample stack (the
JAX one); Dice values as given, or explained by pixels within 2e-4 of the
threshold.
"""

import functools
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import vaeunet_tpu.analysis.analyze as jax_analyze
import vaeunet_tpu.analysis.visualize as jax_visualize
import vaeunet_tpu.inference.ensemble as jax_ensemble
from vaeunet_tpu.data.dataset import IDRIDDataset as JaxIDRIDDataset
from vaeunet_tpu.models.vae_unet import UNetResNet as JaxUNetResNet

import vaeunet_tpu_torch.analysis.analyze as analyze
import vaeunet_tpu_torch.analysis.visualize as visualize
import vaeunet_tpu_torch.inference.ensemble as ensemble
from tests.test_torch_model import resnet34_pair
from vaeunet_tpu_torch.data.dataset import IDRIDDataset

JAX_MODEL = JaxUNetResNet(3, 1)
D, N = 32, 3
BASE_COLUMNS = ["img_id", "dice", "ece", "sparsification_error", "uncertainty_error_dice",
                "error_auroc", "error_auprc"]
EXTENDED_COLUMNS = ["brier", "nll", "mean_entropy", "mean_mutual_info",
                    "mean_coeff_variation", "uncertain_pixel_percent"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def write_split(root, hw, seed: int = 0, n: int = 2):
    """A test split of `n` fundus-like JPGs with EX masks (the layout of
    tests/test_analysis.py's set)."""
    rng = np.random.RandomState(seed)
    (root / "imgs" / "test").mkdir(parents=True)
    (root / "masks" / "test" / "EX").mkdir(parents=True)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        blob = (yy - h // 2) ** 2 + (xx - w // 2) ** 2 < (0.5 * min(h, w)) ** 2
        img = np.zeros((h, w, 3), np.uint8)
        img[blob] = rng.randint(80, 220, (blob.sum(), 3))
        lesion = ((yy - rng.randint(h // 3, 2 * h // 3)) ** 2
                  + (xx - rng.randint(w // 3, 2 * w // 3)) ** 2) < 40
        mask = np.zeros((h, w), np.uint8)
        mask[lesion & blob] = 255
        Image.fromarray(img).save(root / "imgs" / "test" / f"IDRiD_{i:02d}.jpg")
        Image.fromarray(mask).save(root / "masks" / "test" / "EX" / f"IDRiD_{i:02d}_EX.tif")


@functools.lru_cache(maxsize=None)
def datasets(tmp_root, hw):
    """(JAX dataset, port dataset) of one synthetic split."""
    root = Path(tmp_root) / f"idrid_{hw[0]}x{hw[1]}"
    write_split(root, hw)
    kw = dict(split="test", scale=1.0, patch_size=None, lesion_type="EX",
              skip_border_check=True)
    return (JaxIDRIDDataset(str(root), cache_dir=str(root / "cache_jax"), **kw),
            IDRIDDataset(str(root), cache_dir=str(root / "cache_port"), **kw))


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("analysis"))


def jax_noise(seed: int):
    """The eps of the JAX calls' key sequence: PRNGKey(seed), then
    ``rng, sub = split(rng)`` before each call."""
    rng = jax.random.PRNGKey(seed)
    while True:
        rng, sub = jax.random.split(rng)
        yield torch.from_numpy(np.array(jax.random.normal(sub, (N, 1, D))))


def with_eps(fn, noise):
    """`fn` (the port's segmentation_distribution) on the next JAX eps."""
    def call(*args, **kw):
        kw.pop("device", None)
        return fn(*args, eps=next(noise), device="cpu", **kw)
    return call


def recorder(fn, out: list):
    """`fn` with the first of its results kept in `out`."""
    def call(*args, **kw):
        res = fn(*args, **kw)
        out.append(np.array(res[0]))
        return res
    return call


CASES = [  # hw, patch, threshold mode, extended metrics
    ((64, 64), None, "fixed", False),
    ((64, 64), None, "area", True),
    ((96, 80), 64, "fixed", True),
]


@pytest.mark.parametrize("hw,patch,mode,extended", CASES)
def test_analyze_model_matches_jax(tmp_root, tmp_path, monkeypatch, hw, patch, mode, extended):
    model, variables = resnet34_pair()
    jax_ds, port_ds = datasets(tmp_root, hw)
    args = dict(lesion_type="EX", temperature=1.0, samples=N, patch_size=patch, overlap=None,
                batch_size=3, temp_values=(0.5, 1.0, 2.0), extended_metrics=extended, seed=0,
                threshold_mode=mode)

    jax_samples = []
    monkeypatch.setattr(jax_analyze, "segmentation_distribution",
                        recorder(jax_analyze.segmentation_distribution, jax_samples))
    ref = jax_analyze.analyze_model(JAX_MODEL, variables, jax_ds, jax_analyze.AnalyzeArgs(
        output_dir=str(tmp_path / "jax"), **args))

    # the port's own request on JAX's noise: the samples
    port_samples = []
    monkeypatch.setattr(analyze, "segmentation_distribution", recorder(
        with_eps(analyze.segmentation_distribution, jax_noise(0)), port_samples))
    analyze.analyze_model(model, port_ds, analyze.AnalyzeArgs(
        output_dir=str(tmp_path / "port_noise"), global_plots=False, **args), device="cpu")
    assert len(port_samples) == len(jax_samples) == 2
    crop = port_ds.get_image_and_mask("IDRiD_00")[0].shape[:2]
    assert crop == {(64, 64): (65, 65), (96, 80): (81, 81)}[hw]
    for ours, theirs in zip(port_samples, jax_samples):
        assert ours.shape == theirs.shape == (N, *crop, 1)
        np.testing.assert_allclose(ours, theirs, atol=2e-4)

    # the same stack on both sides: the CSV
    stacks = iter(jax_samples)
    monkeypatch.setattr(analyze, "segmentation_distribution", lambda *a, **k: (
        torch.from_numpy(next(stacks)), torch.zeros(D), torch.zeros(D)))
    report = {}
    ours = analyze.analyze_model(model, port_ds, analyze.AnalyzeArgs(
        output_dir=str(tmp_path / "port"), **args), device="cpu", report=report)

    columns = BASE_COLUMNS + (EXTENDED_COLUMNS if extended else [])
    out = f"EX_T1.0_N{N}"
    read = [pd.read_csv(tmp_path / side / out / "analysis_metrics.csv")
            for side in ("port", "jax")]
    assert list(read[0].columns) == list(read[1].columns) == list(ref.columns) == columns
    assert list(read[0]["img_id"]) == list(read[1]["img_id"]) == ["IDRiD_00", "IDRiD_01"]
    for frame in (read, (ours, ref)):
        a, b = frame[0][columns[1:]].to_numpy(), frame[1][columns[1:]].to_numpy()
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    names = [sorted(p.name for p in (tmp_path / side / out).iterdir())
             for side in ("port", "jax")]
    assert names[0] == names[1] and "temp_pixel_data" not in names[0]
    assert len(names[0]) == 9                        # the CSV and 8 PNGs
    assert [r["img_id"] for r in report["images"]] == ["IDRiD_00", "IDRiD_01"]
    assert report["global_s"] > 0


def test_device_error_propagates(tmp_root, tmp_path, monkeypatch):
    """A failure of the device call fails the run: no CSV row is dropped
    quietly, no CSV is written."""
    model, _ = resnet34_pair()
    _, port_ds = datasets(tmp_root, (64, 64))

    def fail(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(analyze, "segmentation_distribution", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        analyze.analyze_model(model, port_ds, analyze.AnalyzeArgs(
            output_dir=str(tmp_path), samples=N), device="cpu")
    assert not (tmp_path / f"EX_T1.0_N{N}" / "analysis_metrics.csv").exists()


class BrokenFirst:
    """A dataset whose first image file cannot be read."""

    def __init__(self, ds):
        self.ds = ds

    def unique_image_ids(self):
        return self.ds.unique_image_ids()

    def get_image_and_mask(self, img_id):
        if img_id == self.unique_image_ids()[0]:
            raise OSError(f"cannot identify image file {img_id}.jpg")
        return self.ds.get_image_and_mask(img_id)


def test_broken_image_is_skipped_as_in_jax(tmp_root, tmp_path, monkeypatch):
    model, variables = resnet34_pair()
    jax_ds, port_ds = datasets(tmp_root, (64, 64))
    args = dict(samples=N, global_plots=False, temp_values=(1.0,))
    ref = jax_analyze.analyze_model(JAX_MODEL, variables, BrokenFirst(jax_ds),
                                    jax_analyze.AnalyzeArgs(output_dir=str(tmp_path / "j"),
                                                            **args))
    monkeypatch.setattr(analyze, "segmentation_distribution",
                        with_eps(analyze.segmentation_distribution, jax_noise(0)))
    ours = analyze.analyze_model(model, BrokenFirst(port_ds), analyze.AnalyzeArgs(
        output_dir=str(tmp_path / "p"), **args), device="cpu")
    assert list(ours["img_id"]) == list(ref["img_id"]) == ["IDRiD_01"]
    # a host failure after the request skips the image too
    monkeypatch.setattr(analyze, "calculate_uncertainty_error_auc",
                        lambda *a: (_ for _ in ()).throw(ValueError("bad metric")))
    ours = analyze.analyze_model(model, port_ds, analyze.AnalyzeArgs(
        output_dir=str(tmp_path / "q"), keep_temp_data=True, **args), device="cpu")
    assert len(ours) == 0
    assert not list((tmp_path / "q" / f"EX_T1.0_N{N}" / "temp_pixel_data").iterdir())


def fundus(h, w, seed):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


@pytest.mark.parametrize("hw,small,patch", [((64, 64), (48, 48), None),
                                            ((96, 80), (80, 64), 64)])
@pytest.mark.parametrize("fusion", ["max", "mean"])
def test_fused_probability_matches_jax(monkeypatch, hw, small, patch, fusion):
    """Two members, the second at a smaller scale: its mean map is resized
    to the first's size (align_corners=False) before the fusion."""
    model, variables = resnet34_pair()
    big, little = fundus(*hw, 1), fundus(*small, 2)
    ref_fused, ref_stack = jax_ensemble.fused_probability(
        [(JAX_MODEL, variables, jnp.asarray(big)), (JAX_MODEL, variables, jnp.asarray(little))],
        jax.random.PRNGKey(3), num_samples=N, patch_size=patch, tile_batch=3, fusion=fusion)
    monkeypatch.setattr(ensemble, "segmentation_distribution",
                        with_eps(ensemble.segmentation_distribution, jax_noise(3)))
    fused, stack = ensemble.fused_probability([(model, big), (model, little)], None,
                                              num_samples=N, patch_size=patch, tile_batch=3,
                                              fusion=fusion, device="cpu")
    assert fused.shape == (*hw, 1) and stack.shape == (2, *hw, 1)
    np.testing.assert_allclose(stack.numpy(), np.asarray(ref_stack), atol=2e-4)
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref_fused), atol=2e-4)
    if fusion == "max":
        assert (fused >= stack).all()


def test_fused_probability_refuses_what_jax_refuses():
    model, _ = resnet34_pair()
    with pytest.raises(ValueError, match="fusion"):
        ensemble.fused_probability([(model, fundus(64, 64, 0))], None, fusion="min",
                                   device="cpu")
    with pytest.raises(ValueError, match="member"):
        ensemble.fused_probability([], None, device="cpu")


def sample_latents_on(noise):
    """The port's sample_latents taking the next JAX eps."""
    real = visualize.sample_latents

    def call(mu, logvar, generator, temperature, num_samples):
        return real(mu, logvar, generator, temperature, num_samples, eps=next(noise))
    return call


def returns_into(fn, out: list):
    def call(*args, **kw):
        res = fn(*args, **kw)
        out.append(np.array(res)[..., 0])
        return res
    return call


def assert_dice_agrees(ours: float, ref: float, ours_map, ref_map) -> None:
    """Equal Dice, or hard masks that differ only where p is within 2e-4
    of the 0.5 threshold."""
    flips = (ours_map > 0.5) != (ref_map > 0.5)
    if flips.any():
        assert (np.abs(ref_map[flips] - 0.5) < 2e-4).all()
    else:
        assert ours == pytest.approx(ref, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("hw,patch", [((64, 64), None), ((96, 80), 64)])
def test_generate_and_compare_ensemble_matches_jax(tmp_root, monkeypatch, hw, patch):
    model, variables = resnet34_pair()
    _, port_ds = datasets(tmp_root, hw)
    img, mask = port_ds.get_image_and_mask(port_ds.unique_image_ids()[0])
    temps = (0.5, 1.0, 2.0)

    ref_means, port_means = [], []
    monkeypatch.setattr(jax_visualize, "_mean_prediction_at_temperature", returns_into(
        jax_visualize._mean_prediction_at_temperature, ref_means))
    ref_fig, ref = jax_visualize.generate_and_compare_ensemble(
        JAX_MODEL, variables, img, mask, jax.random.PRNGKey(2), temperatures=temps,
        samples_per_temp=N, patch_size=patch, batch_size=3)

    monkeypatch.setattr(visualize, "sample_latents", sample_latents_on(jax_noise(2)))
    monkeypatch.setattr(visualize, "_mean_prediction_at_temperature", returns_into(
        visualize._mean_prediction_at_temperature, port_means))
    fig, ours = visualize.generate_and_compare_ensemble(
        model, img, mask, None, temperatures=temps, samples_per_temp=N, patch_size=patch,
        batch_size=3, device="cpu")

    assert list(ours) == list(ref) == [f"dice_T{t}" for t in temps] + ["dice_ensemble"]
    assert len(port_means) == len(ref_means) == len(temps)
    for t, ours_map, ref_map in zip(temps, port_means, ref_means):
        assert ours_map.shape == ref_map.shape == img.shape[:2]
        np.testing.assert_allclose(ours_map, ref_map, atol=2e-4)
        assert_dice_agrees(ours[f"dice_T{t}"], ref[f"dice_T{t}"], ours_map, ref_map)
    weights = np.asarray([1.0 / (abs(t - 1.0) + 0.5) for t in temps])
    weights = weights / weights.sum()
    assert_dice_agrees(ours["dice_ensemble"], ref["dice_ensemble"],
                       sum(w * m for w, m in zip(weights, port_means)),
                       sum(w * m for w, m in zip(weights, ref_means)))
    assert len(fig.axes) == len(ref_fig.axes)
