"""The port's host-side analysis functions against the JAX package's on the
same numpy inputs from a seed: every function of ``uncertainty.py``, the
global plots' returned scalars (``analysis/plots.py``), ``tensor_utils``
and ``expected_area_threshold``.  The port's side also takes torch tensors
(moved to the host first).  Bound: rtol 1e-6 (the code is a copy; only the
input's type differs).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from vaeunet_tpu import uncertainty as jax_unc  # noqa: E402
from vaeunet_tpu.analysis import plots as jax_plots  # noqa: E402
from vaeunet_tpu.inference.ensemble import (  # noqa: E402
    expected_area_threshold as jax_expected_area_threshold,
)
from vaeunet_tpu.utils import tensor_utils as jax_tu  # noqa: E402

from vaeunet_tpu_torch import uncertainty as unc  # noqa: E402
from vaeunet_tpu_torch.analysis import plots  # noqa: E402
from vaeunet_tpu_torch.inference import expected_area_threshold  # noqa: E402
from vaeunet_tpu_torch.utils import tensor_utils as tu  # noqa: E402

RTOL = 1e-6


def maps(seed: int = 0, hw=(48, 40)):
    """(mean prediction, std map, ground truth) of one image: a blob of
    lesion, a noisy prediction with errors on both sides, uncertainty
    larger where it errs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    gt = (((yy - 20) ** 2 + (xx - 18) ** 2) < 90).astype(np.float32)
    pred = np.clip(0.45 * gt + 0.55 * rng.rand(*hw), 0, 1).astype(np.float32)
    std = (0.05 + 0.2 * np.abs(pred - gt) * rng.rand(*hw)).astype(np.float32)
    return pred, std, gt


def as_kind(x, kind):
    return torch.from_numpy(np.ascontiguousarray(x)) if kind == "torch" else x


def close(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            close(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y)
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [0, 1])
def test_calibration_and_scores_match_jax(kind, seed):
    pred, std, gt = maps(seed)
    p, g = as_kind(pred, kind), as_kind(gt, kind)
    close(unc.calculate_expected_calibration_error(p, g),
          jax_unc.calculate_expected_calibration_error(pred, gt))
    close(unc.calculate_expected_calibration_error(p, g, num_bins=7),
          jax_unc.calculate_expected_calibration_error(pred, gt, num_bins=7))
    close(unc.brier_score(p, g), jax_unc.brier_score(pred, gt))
    close(unc.calculate_negative_log_likelihood(p, g),
          jax_unc.calculate_negative_log_likelihood(pred, gt))
    binary = (pred > 0.5).astype(np.float32)
    for thr in (0.1, 0.2):
        close(unc.calculate_uncertainty_error_dice(as_kind(std, kind), as_kind(binary, kind), g,
                                                   uncertainty_threshold=thr),
              jax_unc.calculate_uncertainty_error_dice(std, binary, gt,
                                                       uncertainty_threshold=thr))


def test_uncertainty_error_dice_empty_regions_match_jax():
    z = np.zeros((8, 8), np.float32)
    assert unc.calculate_uncertainty_error_dice(z, z, z) == \
        jax_unc.calculate_uncertainty_error_dice(z, z, z) == 1.0


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("batched", [False, True])
def test_sparsification_matches_jax(kind, batched):
    pred, std, gt = maps(2)
    if batched:
        p2, s2, g2 = maps(3)
        pred, std, gt = np.stack([pred, p2]), np.stack([std, s2]), np.stack([gt, g2])
    else:
        pred, std, gt = pred.reshape(-1), std.reshape(-1), gt.reshape(-1)
    ours = unc.calculate_sparsification_metrics(as_kind(pred, kind), as_kind(std, kind),
                                                as_kind(gt, kind), num_points=20)
    ref = jax_unc.calculate_sparsification_metrics(pred, std, gt, num_points=20)
    close(ours, ref)
    close(unc.sparsification_error(*ours), jax_unc.sparsification_error(*ref))
    _, se = unc.plot_sparsification_curve(*ours)
    _, ref_se = jax_unc.plot_sparsification_curve(*ref)
    plt.close("all")
    close(se, ref_se)


def test_sparsification_skips_a_constant_error_image_as_jax():
    pred = np.full((1, 64), 0.3, np.float32)
    gt = np.zeros((1, 64), np.float32)
    std = np.random.RandomState(4).rand(1, 64).astype(np.float32)
    close(unc.calculate_sparsification_metrics(pred, std, gt),
          jax_unc.calculate_sparsification_metrics(pred, std, gt))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_error_auc_and_segmentation_metrics_match_jax(kind):
    pred, std, gt = maps(5)
    close(unc.calculate_uncertainty_error_auc(as_kind(pred, kind), as_kind(gt, kind),
                                              as_kind(std, kind)),
          jax_unc.calculate_uncertainty_error_auc(pred, gt, std))
    for thr in (0.5, 0.3):
        close(unc.calculate_segmentation_metrics(as_kind(pred, kind), as_kind(gt, kind), thr),
              jax_unc.calculate_segmentation_metrics(pred, gt, thr))
    # no errors at all: the same undefined scores on both sides
    ours = unc.calculate_uncertainty_error_auc(np.zeros(16), np.zeros(16), np.ones(16))
    ref = jax_unc.calculate_uncertainty_error_auc(np.zeros(16), np.zeros(16), np.ones(16))
    assert np.isnan(ours[0]) and np.isnan(ref[0])
    close(ours, ref)


def spill(tmp_path, n: int = 2):
    """Per-image spill files of the analysis (analyze.py's names)."""
    ids = []
    for i in range(n):
        pred, std, gt = maps(10 + i)
        img_id = f"IDRiD_{i:02d}"
        binary = (pred > 0.5).astype(np.float32)
        np.save(tmp_path / f"{img_id}_pred_flat.npy", pred.reshape(-1))
        np.save(tmp_path / f"{img_id}_gt_flat.npy", np.round(gt).astype(int).reshape(-1))
        frac, err_r, err_u = jax_unc.calculate_sparsification_metrics(pred[None], std[None],
                                                                      gt[None])
        np.savez(tmp_path / f"{img_id}_sparsification.npz", frac_removed=frac,
                 err_random=err_r, err_uncertainty=err_u)
        correct = binary == gt
        np.savez(tmp_path / f"{img_id}_uncertainty_dist.npz",
                 uncertainties_correct=std[correct], uncertainties_incorrect=std[~correct])
        np.save(tmp_path / f"{img_id}_errors.npy", (binary != gt).astype(np.int32).reshape(-1))
        np.save(tmp_path / f"{img_id}_uncertainties.npy", std.reshape(-1))
        ids.append(img_id)
    return ids


@pytest.mark.parametrize("chunk,subsample", [(100000, 10000), (500, 1000)])
def test_chunked_segmentation_metrics_match_jax(tmp_path, chunk, subsample):
    ids = spill(tmp_path)
    np.random.seed(7)
    ours = unc.calculate_segmentation_metrics_chunked(ids + ["missing"], tmp_path,
                                                      chunk_size=chunk, subsample=subsample)
    np.random.seed(7)
    ref = jax_unc.calculate_segmentation_metrics_chunked(ids + ["missing"], tmp_path,
                                                         chunk_size=chunk, subsample=subsample)
    close(ours, ref)


def test_global_plots_match_jax(tmp_path):
    ids = spill(tmp_path)
    out_a, out_b = tmp_path / "ours", tmp_path / "jax"
    out_a.mkdir()
    out_b.mkdir()
    df = pd.DataFrame({"dice": [0.5, 0.7], "ece": [0.1, 0.2],
                       "sparsification_error": [0.05, 0.02],
                       "uncertainty_error_dice": [0.3, 0.4]})
    calls = [
        ("create_calibration_visualizations", (ids,), {}),
        ("perform_temperature_analysis", (ids,), {"temperatures": (0.5, 1.0, 2.0)}),
        ("plot_global_sparsification_curve", (ids,), {}),
        ("plot_global_uncertainty_distribution", (ids,), {}),
        ("plot_global_roc_pr", (ids,), {}),
        ("plot_segmentation_roc_pr", (ids,), {}),
    ]
    for name, args, kw in calls:
        np.random.seed(3)
        ours = getattr(plots, name)(*args, tmp_path, out_a, **kw)
        np.random.seed(3)
        ref = getattr(jax_plots, name)(*args, tmp_path, out_b, **kw)
        assert ours is not None, name
        close(ours, ref)
    plots.create_uncertainty_visualizations(df, out_a)
    jax_plots.create_uncertainty_visualizations(df, out_b)
    assert sorted(p.name for p in out_a.iterdir()) == sorted(p.name for p in out_b.iterdir())
    assert len(list(out_a.iterdir())) == 8


def test_reliability_diagram_draws_the_same_bars():
    pred, _, gt = maps(6)
    ece, accs, confs, counts = unc.calculate_expected_calibration_error(pred, gt)
    ax = unc.plot_reliability_diagram(accs, confs, counts)
    ref_ax = jax_unc.plot_reliability_diagram(accs, confs, counts)
    heights = [p.get_height() for p in ax.patches]
    ref_heights = [p.get_height() for p in ref_ax.patches]
    plt.close("all")
    close(heights, ref_heights)


@pytest.mark.parametrize("value", [
    3, 2.5, True, "EX", None,
    np.float32(0.25), np.int64(7), np.array(1.5), np.array([4.0]), np.arange(3.0),
    torch.tensor(0.75), torch.tensor([2]), torch.tensor(3, dtype=torch.int64),
    torch.arange(4, dtype=torch.float32), torch.tensor(1.0, requires_grad=True),
])
def test_to_python_scalar_matches_jax(value):
    ours = tu.to_python_scalar(value)
    ref_in = value.detach().numpy() if isinstance(value, torch.Tensor) else value
    ref = jax_tu.to_python_scalar(ref_in)
    assert type(ours) is type(ref)
    if isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(ours, ref)
    else:
        assert ours == ref


def test_dict_and_dataframe_helpers_match_jax():
    d = {"dice": torch.tensor(0.5), "n": np.int64(3), "id": "IDRiD_01", "v": np.array([2.0])}
    ref_d = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}
    assert tu.ensure_dict_python_scalars(d) == jax_tu.ensure_dict_python_scalars(ref_d)
    df = pd.DataFrame({"img_id": ["a", "b"], "dice": [torch.tensor(0.5), torch.tensor(0.25)],
                       "ece": ["0.1", "bad"]})
    ref_df = pd.DataFrame({"img_id": ["a", "b"], "dice": [np.array(0.5), np.array(0.25)],
                           "ece": ["0.1", "bad"]})
    pd.testing.assert_frame_equal(tu.fix_dataframe_tensors(df),
                                  jax_tu.fix_dataframe_tensors(ref_df))
    pd.testing.assert_frame_equal(tu.ensure_numeric_dataframe(df),
                                  jax_tu.ensure_numeric_dataframe(ref_df))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("factor", [0.5, 1.0, 2.0])
def test_expected_area_threshold_matches_jax(kind, factor):
    pred, _, _ = maps(8)
    ours = expected_area_threshold(as_kind(pred[..., None], kind), factor)
    ref = jax_expected_area_threshold(pred[..., None], factor)
    close(ours, ref)
    assert 0 < ours <= 1
    assert expected_area_threshold(np.zeros((4, 4))) == jax_expected_area_threshold(
        np.zeros((4, 4))) == 1.0


# ----- utils/sk_metrics.py against sklearn, utils/figures.py's renderer -------

def scores_and_labels(seed: int, n: int = 3000, ties: bool = False, kind=float):
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < 0.3).astype(kind)
    s = (rng.rand(n) * 0.6 + 0.4 * y).astype(np.float32)
    if ties:
        s = np.round(s * 20) / 20            # many equal scores
    return y, s


@pytest.mark.parametrize("seed,ties,kind", [(0, False, float), (1, True, int), (2, True, bool),
                                            (3, False, np.float32)])
def test_sk_metrics_match_sklearn(seed, ties, kind):
    from sklearn import calibration, metrics

    from vaeunet_tpu_torch.utils import sk_metrics

    y, s = scores_and_labels(seed, ties=ties, kind=kind)
    for ours, ref in ((sk_metrics.roc_curve(y, s), metrics.roc_curve(y, s)),
                      (sk_metrics.precision_recall_curve(y, s),
                       metrics.precision_recall_curve(y, s))):
        for a, b in zip(ours, ref):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert sk_metrics.roc_auc_score(y, s) == metrics.roc_auc_score(y, s)
    assert sk_metrics.average_precision_score(y, s) == metrics.average_precision_score(y, s)
    fpr, tpr, _ = metrics.roc_curve(y, s)
    assert sk_metrics.auc(fpr, tpr) == metrics.auc(fpr, tpr)
    assert sk_metrics.auc(fpr[::-1], tpr[::-1]) == metrics.auc(fpr[::-1], tpr[::-1])
    for bins in (10, 7):
        for a, b in zip(sk_metrics.calibration_curve(y, s, n_bins=bins),
                        calibration.calibration_curve(y, s, n_bins=bins, strategy="uniform")):
            np.testing.assert_array_equal(a, b)


def test_sk_metrics_one_class_and_refusals_match_sklearn():
    import warnings

    from sklearn import calibration, metrics

    from vaeunet_tpu_torch.utils import sk_metrics

    s = np.random.RandomState(4).rand(50)
    for y in (np.zeros(50), np.ones(50)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            refs = (metrics.roc_curve(y, s), metrics.precision_recall_curve(y, s),
                    metrics.average_precision_score(y, s), metrics.roc_auc_score(y, s))
        ours = (sk_metrics.roc_curve(y, s), sk_metrics.precision_recall_curve(y, s),
                sk_metrics.average_precision_score(y, s), sk_metrics.roc_auc_score(y, s))
        for a, b in zip(ours[:2], refs[:2]):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        np.testing.assert_array_equal(ours[2:], refs[2:])
    with pytest.raises(ValueError):
        sk_metrics.auc([0, 1, 0.5], [0, 1, 1])
    with pytest.raises(ValueError):
        metrics.auc([0, 1, 0.5], [0, 1, 1])
    for bad in (np.r_[s[:-1], 1.5], np.r_[s[:-1], -0.1]):
        with pytest.raises(ValueError, match="outside"):
            sk_metrics.calibration_curve(np.zeros(50), bad)
        with pytest.raises(ValueError, match="outside"):
            calibration.calibration_curve(np.zeros(50), bad)
    with pytest.raises(ValueError):
        sk_metrics.roc_curve(np.zeros(3), np.array([0.1, np.nan, 0.2]))


@pytest.fixture
def pil_renderer(monkeypatch):
    """The figures of a machine without matplotlib: the PIL renderer."""
    from vaeunet_tpu_torch.utils import figures

    monkeypatch.setattr(figures, "_matplotlib", lambda: None)
    return figures


def test_the_pil_renderer_draws_the_global_plots(tmp_path, pil_renderer):
    from PIL import Image

    ids = spill(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    assert plots.create_calibration_visualizations(ids, tmp_path, out) is not None
    assert plots.perform_temperature_analysis(ids, tmp_path, out, (0.5, 1.0, 2.0)) is not None
    assert plots.plot_global_sparsification_curve(ids, tmp_path, out) is not None
    assert plots.plot_global_uncertainty_distribution(ids, tmp_path, out) is not None
    assert plots.plot_global_roc_pr(ids, tmp_path, out) is not None
    assert plots.plot_segmentation_roc_pr(ids, tmp_path, out) is not None
    df = pd.DataFrame({"dice": [0.5, 0.7], "ece": [0.1, 0.2],
                       "sparsification_error": [0.05, 0.02],
                       "uncertainty_error_dice": [0.3, 0.4]})
    plots.create_uncertainty_visualizations(df, out)
    pred, std, gt = maps(6)
    _, accs, confs, counts = unc.calculate_expected_calibration_error(pred, gt)
    unc.plot_reliability_diagram(accs, confs, counts).figure.savefig(out / "reliability.png")
    ax, _ = unc.plot_sparsification_curve(*unc.calculate_sparsification_metrics(pred, std, gt))
    ax.figure.savefig(out / "sparsification.png", dpi=200)
    pngs = sorted(out.iterdir())
    assert len(pngs) == 10
    for png in pngs:
        img = np.asarray(Image.open(png).convert("RGB"))
        assert img.shape[0] >= 400 and img.shape[1] >= 500, png.name
        colored = (img.max(axis=-1) - img.min(axis=-1)) > 30     # drawn in color
        assert colored.mean() > 1e-3, png.name


@pytest.mark.parametrize("name,atol", [("gray", 1e-9), ("hot", 0.02), ("viridis", 0.03)])
def test_the_pil_renderers_colormaps_follow_matplotlibs(name, atol):
    from matplotlib import colormaps

    from vaeunet_tpu_torch.utils.figures import _Colormap

    v = np.linspace(0, 1, 301)
    ours = _Colormap(name)(v.reshape(-1, 1))
    assert ours.shape == (301, 1, 4)
    np.testing.assert_allclose(ours[:, 0], colormaps[name](v), atol=max(atol, 1 / 255))
