#!/usr/bin/env python
"""Tune an ensemble fusion operating point on the VAL split, then apply the
frozen point to the TEST split.  Port of ``scripts/tune_fusion.py``, a copy
of its numpy code with every one of its flags, dests, defaults and choices:

    python -m vaeunet_tpu_torch.cli.tune_fusion --val-dir MAPS/val \
        --test-dir MAPS/test --output-dir OUT [--threshold-modes fixed area]

The inputs are the cached per-member maps of ``cli.member_maps``
(``<label>_<img>.npy`` float32 [H,W] mean probability, ``<label>_<img>_mom.npy``
[2,H,W] sample sum and sum of squares, ``gt_<img>.npy`` uint8), one
directory per split.  Selection (greedy or exhaustive) picks a member
subset, a fusion rule (max, mean, median or noisy-or
``1 - prod((1 - p_m)^w)``) and a decision threshold, fixed or per-image
expected-area, scoring each candidate by its val Dice averaged over the
threshold's grid neighbours (plateaus beat knife edges).  The chosen point
is written as ``operating_point.json`` and applied unchanged to the test
maps, giving the reference-schema ``<output-dir>/<protocol>/analysis_metrics.csv``
(Dice from the tuned rule; calibration and uncertainty metrics from the
same fused map, std from the pooled member moments).

Differences from the script: the host metrics come from the port's
``uncertainty`` (``sparsification_error`` in place of the inline
``np.trapezoid``), and nothing here touches a device.
"""
import argparse
import itertools
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

THR_GRID = np.array([0.10, 0.15, 0.20, 0.25, 0.30, 0.35, 0.40,
                     0.45, 0.50, 0.55, 0.60])
# Area-matching mode: per-image threshold t s.t. |{p > t}| = w_a * sum(p).
# sum(p) is the calibration-consistent estimate of lesion area, so the rule
# adapts to under-confident images (low max-prob, but nonzero soft mass)
# without any per-image supervision; w_a is the only tuned parameter.
AREA_GRID = np.array([0.50, 0.65, 0.80, 0.90, 1.00, 1.10, 1.25, 1.50, 2.00])
METHODS = [("max", 1.0), ("mean", 1.0), ("median", 1.0),
           ("noisyor", 0.5), ("noisyor", 1.0), ("noisyor", 1.5),
           ("noisyor", 2.0)]
BINS = np.linspace(0.0, 1.0, 1001)


def fuse(stack: np.ndarray, method: str, w: float) -> np.ndarray:
    if method == "max":
        return stack.max(0)
    if method == "mean":
        return stack.mean(0)
    if method == "median":
        return np.median(stack, axis=0)
    return 1.0 - np.prod((1.0 - stack) ** w, axis=0)


def _hist_cumsums(prob: np.ndarray, gt: np.ndarray):
    """(cp, cn, g): counts of positive/negative pixels above each bin edge."""
    hp, _ = np.histogram(prob[gt], bins=BINS)
    hn, _ = np.histogram(prob[~gt], bins=BINS)
    cp = np.concatenate([hp[::-1].cumsum()[::-1], [0]])
    cn = np.concatenate([hn[::-1].cumsum()[::-1], [0]])
    return cp, cn, int(gt.sum())


def _dice_at(cp, cn, g, thr: np.ndarray) -> np.ndarray:
    idx = np.searchsorted(BINS, thr, side="left")
    tp = cp[idx]
    pp = cp[idx] + cn[idx]
    return 2.0 * tp / (pp + g + 1e-8)


def dice_at_thresholds(prob: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Dice at every THR_GRID point in one histogram pass."""
    cp, cn, g = _hist_cumsums(prob, gt)
    return _dice_at(cp, cn, g, THR_GRID)


def area_thresholds(prob: np.ndarray, cp, cn) -> np.ndarray:
    """Per-image thresholds for every AREA_GRID factor: smallest bin edge t
    where the predicted area |{p > t}| drops to w_a * sum(p)."""
    counts = cp + cn          # pixels above each bin edge (len BINS+ sentinel)
    soft_mass = float(prob.sum())
    thrs = np.empty_like(AREA_GRID)
    for j, wa in enumerate(AREA_GRID):
        target = wa * soft_mass
        # counts is non-increasing along bin edges; find first edge <= target
        k = np.searchsorted(-counts, -target, side="left")
        k = min(k, len(BINS) - 1)
        thrs[j] = BINS[k]
    return thrs


def dice_at_area_factors(prob: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Dice at every AREA_GRID factor with the per-image adaptive threshold."""
    cp, cn, g = _hist_cumsums(prob, gt)
    return _dice_at(cp, cn, g, area_thresholds(prob, cp, cn))


def smoothed(mean_by_thr: np.ndarray) -> np.ndarray:
    """Average each threshold with its grid neighbours (plateau preference)."""
    padded = np.pad(mean_by_thr, 1, mode="edge")
    return (padded[:-2] + padded[1:-1] + padded[2:]) / 3.0


class MapCache:
    def __init__(self, root: Path, keep_probs: bool = False, stride: int = 1):
        """keep_probs=True holds every loaded probability map in RAM —
        greedy selection re-reads each (label, image) map once per candidate
        per round, so disk re-loads dominate its runtime otherwise.
        stride>1 decimates maps spatially (a selection-time speedup; dice
        over a regular subsample tracks full-res dice — the frozen point is
        always APPLIED at full resolution)."""
        self.root = root
        self.stride = int(stride)
        self.img_ids = sorted(p.stem[3:] for p in root.glob("gt_*.npy"))
        self.labels = sorted({p.stem.rsplit("_IDRiD", 1)[0]
                              for p in root.glob("*_IDRiD_*.npy")
                              if not p.stem.endswith("_mom")
                              and not p.stem.startswith("gt_")})
        # keep only labels with complete coverage
        self.labels = [l for l in self.labels
                       if all((root / f"{l}_{i}.npy").exists()
                              for i in self.img_ids)]
        self._gt = {}
        self._probs = {} if keep_probs else None

    def gt(self, img):
        if img not in self._gt:
            g = np.load(self.root / f"gt_{img}.npy")
            self._gt[img] = g[::self.stride, ::self.stride].astype(bool)
        return self._gt[img]

    def prob(self, label, img):
        if self._probs is not None and (label, img) in self._probs:
            return self._probs[(label, img)]
        p = np.load(self.root / f"{label}_{img}.npy")
        p = np.clip(p[::self.stride, ::self.stride], 0.0, 1.0)
        if self._probs is not None:
            self._probs[(label, img)] = p
        return p

    def moments(self, label, img):
        return np.load(self.root / f"{label}_{img}_mom.npy")


_OBJECTIVES = {
    "mean": lambda a: a.mean(0),
    "min": lambda a: a.min(0),            # worst val image (robustness)
    "q25": lambda a: np.percentile(a, 25, axis=0),
    "meanmin": lambda a: 0.5 * (a.mean(0) + a.min(0)),
}


def eval_combo(cache: MapCache, combo, methods=METHODS, objective="mean",
               modes=("fixed",)):
    """Returns {(method, w, mode): smoothed-objective-dice-by-gridpoint}.
    mode "fixed" scores over THR_GRID; "area" over AREA_GRID."""
    keys = [(m, w, mode) for (m, w) in methods for mode in modes]
    per = {k: [] for k in keys}
    for img in cache.img_ids:
        gt = cache.gt(img)
        stack = np.stack([cache.prob(l, img) for l in combo])
        for m, w in methods:
            fused = fuse(stack, m, w)
            cp, cn, g = _hist_cumsums(fused, gt)
            if "fixed" in modes:
                per[(m, w, "fixed")].append(_dice_at(cp, cn, g, THR_GRID))
            if "area" in modes:
                per[(m, w, "area")].append(
                    _dice_at(cp, cn, g, area_thresholds(fused, cp, cn)))
    agg = _OBJECTIVES[objective]
    return {k: smoothed(agg(np.asarray(rows))) for k, rows in per.items()}


def _grid_value(mode: str, k: int) -> float:
    return float((THR_GRID if mode == "fixed" else AREA_GRID)[k])


def greedy_select(cache: MapCache, max_members: int, verbose=True,
                  objective="mean", modes=("fixed",)):
    """Greedy forward selection on smoothed val dice.  Each round adds the
    member whose addition (with fusion rule and threshold re-tuned) scores
    highest; stops when the gain over the running best drops under 1e-3
    once at least two members are chosen."""
    chosen: list = []
    best = (-1.0, None, None, None)  # score, combo, (method,w,mode), grid idx

    while len(chosen) < max_members:
        round_best = (-1.0, None, None, None)
        for cand in cache.labels:
            if cand in chosen:
                continue
            trial = chosen + [cand]
            table = eval_combo(cache, trial, objective=objective, modes=modes)
            for mk, scores in table.items():
                k = int(scores.argmax())
                if scores[k] > round_best[0]:
                    round_best = (float(scores[k]), tuple(trial), mk, k)
        if round_best[1] is None:
            break
        gain = round_best[0] - best[0]
        if gain <= 1e-3 and len(chosen) >= 2:
            if verbose:
                print(f"  stop: best addition gains {gain:+.4f}")
            break
        if round_best[0] > best[0]:
            best = round_best
        chosen = list(round_best[1])
        if verbose:
            m, w, mode = round_best[2]
            print(f"  +{chosen[-1]}: val {round_best[0]:.4f} "
                  f"({m} w={w} {mode}={_grid_value(mode, round_best[3]):.2f})")
    return best


def exhaustive_select(cache: MapCache, max_members: int, objective="mean",
                      modes=("fixed",)):
    best = (-1.0, None, None, None)
    for r in range(1, min(max_members, len(cache.labels)) + 1):
        for combo in itertools.combinations(cache.labels, r):
            table = eval_combo(cache, combo, objective=objective, modes=modes)
            for mk, scores in table.items():
                k = int(scores.argmax())
                if scores[k] > best[0]:
                    best = (float(scores[k]), combo, mk, k)
    return best


def apply_point(cache: MapCache, point, out_dir: Path, protocol: str,
                n_samples_per_member: int):
    """The frozen point on `cache`'s maps -> (mean Dice, per-image rows),
    and ``<out_dir>/<protocol>/analysis_metrics.csv``."""
    import pandas as pd

    from vaeunet_tpu_torch.uncertainty import (
        calculate_expected_calibration_error,
        calculate_sparsification_metrics,
        calculate_uncertainty_error_auc,
        calculate_uncertainty_error_dice,
        sparsification_error,
    )

    combo = point["members"]
    method, w, thr = point["fusion"], point["weight"], point["threshold"]
    mode = point.get("threshold_mode", "fixed")
    rows = []
    n_total = n_samples_per_member * len(combo)
    for img in cache.img_ids:
        gt = cache.gt(img).astype(np.float32)
        stack = np.stack([cache.prob(l, img) for l in combo])
        fused = fuse(stack, method, w)
        if mode == "area":
            # area target: the fused map's own soft mass, or the median of
            # per-member masses (protocol v2 — robust to members that spray
            # diffuse mass)
            if point.get("area_estimate", "fused") == "member_median":
                mass = float(np.median(stack.sum(axis=(1, 2))))
            else:
                mass = float(fused.sum())
            counts = np.concatenate(
                [np.histogram(fused, bins=BINS)[0][::-1].cumsum()[::-1], [0]])
            k = np.searchsorted(-counts, -(thr * mass), side="left")
            t_img = float(BINS[min(k, len(BINS) - 1)])
            print(f"  test {img}: adaptive thr {t_img:.3f}")
        else:
            t_img = thr
        pred = (fused > t_img).astype(np.float32)
        d = float(2 * (pred * gt).sum() / (pred.sum() + gt.sum() + 1e-8))
        s1 = np.sum([cache.moments(l, img)[0] for l in combo], axis=0)
        s2 = np.sum([cache.moments(l, img)[1] for l in combo], axis=0)
        var = np.maximum(s2 / n_total - (s1 / n_total) ** 2, 0.0)
        std = np.sqrt(var)
        fused_c = np.clip(fused, 0.0, 1.0)
        ece, *_ = calculate_expected_calibration_error(fused_c, gt)
        ue = calculate_uncertainty_error_dice(std, pred, gt)
        se = sparsification_error(*calculate_sparsification_metrics(
            fused_c[None], std[None], gt[None], num_points=20))
        auroc, auprc = calculate_uncertainty_error_auc(fused_c, gt, std)
        rows.append({"img_id": img, "dice": d, "ece": ece,
                     "sparsification_error": se,
                     "uncertainty_error_dice": ue,
                     "error_auroc": auroc, "error_auprc": auprc})
        print(f"  test {img}: dice {d:.4f}")
    out = out_dir / protocol
    out.mkdir(parents=True, exist_ok=True)
    df = pd.DataFrame(rows)
    df.to_csv(out / "analysis_metrics.csv", index=False)
    print(f"wrote {out}/analysis_metrics.csv mean dice {df['dice'].mean():.4f}")
    return float(df["dice"].mean()), rows


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--val-dir", required=True)
    p.add_argument("--test-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--protocol", default="EX_T1.0_N10",
                   help="Subdirectory name matching the reference's scheme")
    p.add_argument("--samples-per-member", type=int, default=10)
    p.add_argument("--max-members", type=int, default=5)
    p.add_argument("--strategy", choices=["greedy", "exhaustive"],
                   default="greedy")
    p.add_argument("--objective", choices=sorted(_OBJECTIVES),
                   default="mean",
                   help="Val aggregation the selection maximizes: mean, or "
                        "robustness-oriented min / q25 / meanmin")
    p.add_argument("--threshold-modes", nargs="+", default=["fixed"],
                   choices=["fixed", "area"],
                   help="Decision-rule families to search: fixed global "
                        "threshold, and/or per-image expected-area matching")
    p.add_argument("--cache-maps", action="store_true",
                   help="Hold all probability maps in RAM during selection")
    p.add_argument("--select-stride", type=int, default=1,
                   help="Decimate val maps by this stride during selection "
                        "(the frozen point is applied at full resolution)")
    p.add_argument("--members", nargs="*", default=None,
                   help="Restrict the candidate pool to these labels")
    p.add_argument("--point-json", default=None,
                   help="Skip tuning; apply this frozen operating point")
    p.add_argument("--protocol-free", action="store_true",
                   help="Skip tuning; apply the pre-registered parameter-"
                        "free protocol: EVERY member with complete test "
                        "coverage, mean fusion, per-image expected-area "
                        "threshold at w_a=1.0 with the member-median mass "
                        "estimate (protocol v2)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """-> {"point": the operating point, "mean_dice": the test mean Dice,
    "rows": the CSV's rows, "csv": its path}."""
    args = get_parser().parse_args(argv)

    test_cache = MapCache(Path(args.test_dir))
    out = Path(args.output_dir)
    if args.protocol_free:
        point = {
            "members": sorted(test_cache.labels),
            "fusion": "mean", "weight": 1.0,
            "threshold_mode": "area", "threshold": 1.0,
            "area_estimate": "member_median",
            "objective": ("none (parameter-free protocol v2: all members, "
                          "mean fusion, expected-area threshold at w_a=1.0, "
                          "member-median mass estimate)"),
        }
        out.mkdir(parents=True, exist_ok=True)
        (out / "operating_point.json").write_text(json.dumps(point, indent=2))
        print(f"protocol-free point: {json.dumps(point)}")
    elif args.point_json:
        point = json.loads(Path(args.point_json).read_text())
    else:
        val_cache = MapCache(Path(args.val_dir), keep_probs=args.cache_maps,
                             stride=args.select_stride)
        if args.members:
            val_cache.labels = [l for l in val_cache.labels
                                if l in args.members]
        # only members that also have test maps are eligible
        val_cache.labels = [l for l in val_cache.labels
                            if l in test_cache.labels]
        print(f"val: {len(val_cache.img_ids)} images, "
              f"candidates: {val_cache.labels}")
        modes = tuple(args.threshold_modes)
        sel = (greedy_select(val_cache, args.max_members,
                             objective=args.objective, modes=modes)
               if args.strategy == "greedy"
               else exhaustive_select(val_cache, args.max_members,
                                      objective=args.objective, modes=modes))
        score, combo, (method, w, mode), k = sel
        point = {"members": sorted(combo), "fusion": method, "weight": w,
                 "threshold_mode": mode,
                 "threshold": _grid_value(mode, k),
                 "objective": args.objective,
                 "val_dice_smoothed": score}
        print(f"frozen operating point: {json.dumps(point)}")
        out.mkdir(parents=True, exist_ok=True)
        (out / "operating_point.json").write_text(json.dumps(point, indent=2))

    mean_dice, rows = apply_point(test_cache, point, out, args.protocol,
                                  args.samples_per_member)
    return {"point": point, "mean_dice": mean_dice, "rows": rows,
            "csv": out / args.protocol / "analysis_metrics.csv"}


if __name__ == "__main__":
    main()
