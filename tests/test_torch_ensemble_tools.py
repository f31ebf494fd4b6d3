"""The ensemble protocol's tools in the port (``python -m vaeunet_tpu_torch.cli.
{member_maps,tune_fusion,scale_ensemble}``) against the JAX package's scripts
(``scripts/compute_member_maps.py``, ``tune_fusion.py``,
``eval_scale_ensemble.py``), on a synthetic IDRiD set and one seeded
resnet34 VAE-UNet saved as a reference ``.pth`` that both loaders read:

- each CLI's parser has every option, dest, default and choice of its
  script, plus ``--device`` (but the tuner's, which touches no device),
  ``--data-dir`` defaulting to ``./data``; the member parsers agree on
  every spec;
- member maps at T = 0 (z = mu in both): the ground truth equal, each map
  within 1.25e-4 of the script's (the logits bound 5e-4 times the sigmoid's
  largest slope, 1/4) and its moments within N times that; a second call
  writes nothing, a stale ``.tmp`` file is removed, ``mom[0] / N`` is the
  map;
- the scale ensemble at T = 0: every member's sample stack within 1.25e-4;
  at T > 0, with both scripts' ``segmentation_distribution`` patched to
  return the same seeded stacks (the RNG streams cannot match,
  docs/PARITY.md #17): the CSV rows within 1e-6, each Dice equal unless a
  fused pixel lies within 1e-4 of the threshold, the mixing sweep's Dice
  likewise;
- the tuner on shared cached maps: the same operating point and the same
  CSV (1e-6), greedy and exhaustive, fixed and area thresholds, a frozen
  point and the parameter-free protocol.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import vaeunet_tpu.inference.predict as jax_predict
import vaeunet_tpu_torch.inference.predict as port_predict
from tests.test_torch_model import resnet34_pair
from vaeunet_tpu_torch.cli import member_maps, scale_ensemble, tune_fusion

REPO = Path(__file__).resolve().parents[1]
PARAMS = {"lesion_type": "EX", "patch_size": 64, "img_scale": 1.0, "beta": 0.001,
          "free_bits": 1e-3, "kl_anneal_epochs": 20, "latent_injection": "all",
          "use_attention": True, "seed": 0, "model_type": "resnet"}
MAP_ATOL = 1.25e-4          # 5e-4 on the logits times max sigmoid'(x) = 1/4


def script(name: str):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_MAPS = script("compute_member_maps")
JAX_TUNE = script("tune_fusion")
JAX_SCALE = script("eval_scale_ensemble")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """tests/test_data.py's fundus set (a bright disk on black, lesion blobs),
    val and test splits of 2 images."""
    root = tmp_path_factory.mktemp("idrid_ens")
    rng = np.random.RandomState(0)
    for split in ("val", "test"):
        (root / "imgs" / split).mkdir(parents=True)
        (root / "masks" / split / "EX").mkdir(parents=True)
        for i in range(2):
            h, w = 96, 128
            img = np.zeros((h, w, 3), np.uint8)
            yy, xx = np.mgrid[0:h, 0:w]
            circle = (yy - h // 2) ** 2 + (xx - w // 2) ** 2 < (h // 2 - 4) ** 2
            img[circle] = rng.randint(60, 200, (circle.sum(), 3))
            mask = np.zeros((h, w), np.uint8)
            for _ in range(3):
                cy, cx = rng.randint(25, 70), rng.randint(35, 95)
                blob = (yy - cy) ** 2 + (xx - cx) ** 2 < 40
                img[blob & circle] = (230, 210, 90)
                mask[blob & circle] = 255
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray(mask).save(root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
    return root


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    model, _ = resnet34_pair()
    path = tmp_path_factory.mktemp("member") / "member.pth"
    torch.save({"model_state_dict": model.state_dict(), "params": PARAMS}, path)
    return str(path)


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("VAEUNET_CACHE_DIR", str(tmp_path / "cache"))


def script_parser(mod) -> argparse.ArgumentParser:
    """The parser a script's ``main`` builds, caught at ``parse_args``."""
    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught) as e:
            mod.main()
    return e.value.args[0]


def options(parser: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.nargs, a.required,
                                      type(a).__name__)
            for a in parser._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("name, port", [("compute_member_maps", member_maps),
                                        ("tune_fusion", tune_fusion),
                                        ("eval_scale_ensemble", scale_ensemble)])
def test_parser_has_every_script_option_plus_device(name, port):
    """The tuner is host numpy and takes no --device; the data directory
    defaults to ./data, as in every other CLI, where two scripts name their
    own host's directory."""
    ours = options(port.get_parser())
    theirs = options(script_parser(script(name)))
    if port is not tune_fusion:
        assert ours.pop(("--device",))[:2] == ("device", None)
    if ("--data-dir",) in ours:
        assert ours[("--data-dir",)][1] == "./data"
        ours[("--data-dir",)] = theirs[("--data-dir",)]
    assert ours == theirs


@pytest.mark.parametrize("spec", ["b05=ckpt/run@0.5", "f10F=a/b.pth@1.0:h", "g=x@0.25:v:c3",
                                  "m=dir@2:c1", "lab=odd=name@1.0"])
def test_member_specs_parse_as_the_script_does(spec):
    assert member_maps.parse_member(spec) == JAX_MAPS.parse_member(spec)
    path, scale = spec.split("=", 1)[1].split(":")[0].rsplit("@", 1)
    assert scale_ensemble.parse_member(f"{path}@{scale}") == JAX_SCALE.parse_member(
        f"{path}@{scale}")


def test_bad_member_specs_are_refused_as_the_script_does():
    with pytest.raises(ValueError, match="unknown member flag"):
        member_maps.parse_member("a=x@1.0:q")
    with pytest.raises(ValueError):
        JAX_MAPS.parse_member("a=x@1.0:q")
    with pytest.raises(argparse.ArgumentTypeError):
        scale_ensemble.parse_member("@0.5")
    with pytest.raises(argparse.ArgumentTypeError):
        JAX_SCALE.parse_member("@0.5")


def map_args(root, pth, outdir, temperature="0", samples=2):
    return ["--member", f"a={pth}@1.0", "--member", f"b={pth}@0.5:h", "--lesion-type", "EX",
            "--split", "test", "--outdir", str(outdir), "--data-dir", str(root),
            "--samples", str(samples), "--temperature", temperature, "--patch-size", "64"]


def test_member_maps_match_the_script_at_t0(synth_root, pth, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["compute_member_maps.py",
                                      *map_args(synth_root, pth, tmp_path / "jax")])
    JAX_MAPS.main()
    report = {}
    out = member_maps.main([*map_args(synth_root, pth, tmp_path / "port"), "--device", "cpu"],
                           report=report)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npy"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.npy"))
    assert len(names) == 2 * (1 + 2 * 2) and len(out["written"]) == 4 and not out["skipped"]
    # the tiled member (scale 1.0 is above the 64 patch) and the whole-image one
    assert {m["label"]: m["hw"][0] > 64 for m in report["maps"]} == {"a": True, "b": False}
    for name in names:
        ours, theirs = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, name
        if name.startswith("gt_"):
            np.testing.assert_array_equal(ours, theirs)
        elif name.endswith("_mom.npy"):
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=2 * 2 * MAP_ATOL)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=MAP_ATOL)


def test_member_maps_resume_and_moments(synth_root, pth, tmp_path):
    args = [*map_args(synth_root, pth, tmp_path, temperature="1", samples=3), "--device", "cpu",
            "--images", "IDRiD_01"]
    first = member_maps.main(args)
    assert [p.name for p in first["written"]] == ["a_IDRiD_01.npy", "b_IDRiD_01.npy"]
    for label in "ab":
        prob = np.load(tmp_path / f"{label}_IDRiD_01.npy")
        mom = np.load(tmp_path / f"{label}_IDRiD_01_mom.npy")
        assert prob.shape == mom.shape[1:] == np.load(tmp_path / "gt_IDRiD_01.npy").shape
        np.testing.assert_allclose(mom[0] / 3, prob, rtol=0, atol=1e-6)
        assert np.all(mom[1] >= mom[0] ** 2 / 3 - 1e-5)       # sum s^2 >= (sum s)^2 / N
    before = {p.name: p.stat().st_mtime_ns for p in tmp_path.glob("*.npy")}
    (tmp_path / ".tmp.a.IDRiD_01.npy").write_bytes(b"half")   # a kill mid-rename
    again = member_maps.main(args)
    assert again["written"] == [] and again["skipped"] == [("a", "IDRiD_01"), ("b", "IDRiD_01")]
    assert {p.name: p.stat().st_mtime_ns for p in tmp_path.glob("*.npy")} == before
    assert not list(tmp_path.glob(".tmp.*"))


def recorder(fn, store, to_numpy):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        store.append(to_numpy(out[0]))
        return out
    return wrapped


def scale_args(root, pth, temperature, fusion="max", out=None):
    args = ["--member", f"{pth}@1.0", "--member", f"{pth}@0.5", "--lesion-type", "EX",
            "--data-dir", str(root), "--samples", "2", "--temperature", temperature,
            "--patch-size", "64", "--fusion", fusion, "--fusion-weight", "1.5"]
    return args + (["--output-dir", str(out)] if out else [])


def test_scale_ensemble_matches_the_script_at_t0(synth_root, pth, tmp_path, monkeypatch):
    theirs, ours = [], []
    monkeypatch.setattr(jax_predict, "segmentation_distribution",
                        recorder(jax_predict.segmentation_distribution, theirs, np.asarray))
    monkeypatch.setattr(port_predict, "segmentation_distribution",
                        recorder(port_predict.segmentation_distribution, ours,
                                 lambda t: t.cpu().numpy()))
    monkeypatch.setattr(sys, "argv", ["eval_scale_ensemble.py",
                                      *scale_args(synth_root, pth, "0", out=tmp_path / "jax")])
    JAX_SCALE.main()
    out = scale_ensemble.main([*scale_args(synth_root, pth, "0", out=tmp_path / "port"),
                               "--device", "cpu"])
    assert len(ours) == len(theirs) == 4                 # 2 images x 2 members
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=MAP_ATOL)
    csv = pd.read_csv(out["csv"])
    ref = pd.read_csv(tmp_path / "jax" / "EX_T0.0_N2" / "analysis_metrics.csv")
    assert list(csv.columns) == list(ref.columns) and list(csv.img_id) == list(ref.img_id)
    assert len(out["weights"]) == 11 and all(len(r) == 11 for r in out["pair"].values())


def fixed_stacks(kind):
    """A segmentation_distribution of either package that returns the k-th
    call's seeded [N, h, w, 1] stack, and records the fused inputs."""
    calls = {"n": 0}

    def draw(image, num_samples):
        k = calls["n"]
        calls["n"] += 1
        h, w = image.shape[:2]
        return np.random.RandomState(k).rand(num_samples, h, w, 1).astype(np.float32)

    if kind == "jax":
        def fake(model, variables, image, rng, num_samples=5, temperature=1.0,
                 patch_size=None, **_):
            s = draw(image, num_samples)
            return jnp.asarray(s), jnp.zeros(32), jnp.zeros(32)
    else:
        def fake(model, image, generator=None, num_samples=5, temperature=1.0,
                 patch_size=None, device=None, **_):
            s = draw(image, num_samples)
            return torch.from_numpy(s), torch.zeros(32), torch.zeros(32)
    return fake


@pytest.mark.parametrize("fusion", ["max", "mean", "noisyor"])
def test_scale_ensemble_rows_match_the_script_on_shared_samples(synth_root, pth, tmp_path,
                                                                monkeypatch, capsys, fusion):
    monkeypatch.setattr(jax_predict, "segmentation_distribution", fixed_stacks("jax"))
    monkeypatch.setattr(port_predict, "segmentation_distribution", fixed_stacks("port"))
    monkeypatch.setattr(sys, "argv", ["eval_scale_ensemble.py",
                                      *scale_args(synth_root, pth, "1", fusion, tmp_path / "jax")])
    JAX_SCALE.main()
    jax_out = capsys.readouterr().out
    out = scale_ensemble.main([*scale_args(synth_root, pth, "1", fusion, tmp_path / "port"),
                               "--device", "cpu"])
    port_out = capsys.readouterr().out
    csv = pd.read_csv(out["csv"])
    ref = pd.read_csv(tmp_path / "jax" / "EX_T1.0_N2" / "analysis_metrics.csv")
    assert list(csv.columns) == list(ref.columns) and list(csv.img_id) == list(ref.img_id)
    assert len(csv) == 2
    cols = ["ece", "sparsification_error", "uncertainty_error_dice", "error_auroc",
            "error_auprc"]
    np.testing.assert_allclose(csv[cols].to_numpy(), ref[cols].to_numpy(), rtol=0, atol=1e-6)
    # the mixing sweep's and the fused Dice as the script printed them
    assert jax_out.splitlines()[-13:-1] == port_out.splitlines()[-13:-1]
    np.testing.assert_allclose(csv["dice"], ref["dice"], rtol=0, atol=1e-6)


def write_maps(root: Path, seed: int, labels=("a", "b", "c", "d"), n_img=3, hw=(48, 64),
               samples=4):
    """Cached maps as cli.member_maps writes them: members of different
    quality (a blurred, shifted or noisy copy of the truth)."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for i in range(n_img):
        img = f"IDRiD_{i:02d}"
        gt = np.zeros(hw, np.uint8)
        for _ in range(3):
            y, x = rng.randint(4, hw[0] - 8), rng.randint(4, hw[1] - 8)
            gt[y:y + rng.randint(2, 7), x:x + rng.randint(2, 9)] = 1
        np.save(root / f"gt_{img}.npy", gt)
        for j, label in enumerate(labels):
            base = gt * (0.2 + 0.1 * j) + rng.rand(*hw) * (0.65 - 0.05 * j)
            s = np.clip(base[None] + 0.1 * rng.randn(samples, *hw), 0, 1).astype(np.float32)
            np.save(root / f"{label}_{img}_mom.npy",
                    np.stack([s.sum(0), (s ** 2).sum(0)]).astype(np.float32))
            np.save(root / f"{label}_{img}.npy", s.mean(0).astype(np.float32))


@pytest.mark.parametrize("extra", [
    [],
    ["--threshold-modes", "fixed", "area"],
    ["--strategy", "exhaustive", "--max-members", "2", "--objective", "meanmin"],
    ["--threshold-modes", "area", "--objective", "min", "--cache-maps", "--select-stride", "2",
     "--members", "a", "b", "c"],
    ["--protocol-free"],
], ids=["greedy-fixed", "greedy-area", "exhaustive", "area-restricted", "protocol-free"])
def test_tune_fusion_picks_and_writes_what_the_script_does(tmp_path, monkeypatch, capsys,
                                                          extra):
    write_maps(tmp_path / "val", 0)
    write_maps(tmp_path / "test", 1)
    base = ["--val-dir", str(tmp_path / "val"), "--test-dir", str(tmp_path / "test"),
            "--samples-per-member", "4"]
    monkeypatch.setattr(sys, "argv", ["tune_fusion.py", *base, "--output-dir",
                                      str(tmp_path / "jax"), *extra])
    JAX_TUNE.main()
    jax_out = capsys.readouterr().out
    out = tune_fusion.main([*base, "--output-dir", str(tmp_path / "port"), *extra])
    assert capsys.readouterr().out.replace("port", "jax") == jax_out
    point = json.loads((tmp_path / "port" / "operating_point.json").read_text())
    assert point == out["point"] == json.loads(
        (tmp_path / "jax" / "operating_point.json").read_text())
    csv = pd.read_csv(out["csv"])
    ref = pd.read_csv(tmp_path / "jax" / "EX_T1.0_N10" / "analysis_metrics.csv")
    assert list(csv.columns) == list(ref.columns) and list(csv.img_id) == list(ref.img_id)
    np.testing.assert_allclose(csv.iloc[:, 1:].to_numpy(), ref.iloc[:, 1:].to_numpy(), rtol=0,
                               atol=1e-6)
    # the frozen point applied to the test maps alone gives the same CSV
    frozen = tune_fusion.main([*base, "--output-dir", str(tmp_path / "frozen"), "--point-json",
                               str(tmp_path / "port" / "operating_point.json")])
    assert pd.DataFrame(frozen["rows"]).equals(pd.DataFrame(out["rows"]))
    assert np.isfinite(csv.iloc[:, 1:].to_numpy()).all()
