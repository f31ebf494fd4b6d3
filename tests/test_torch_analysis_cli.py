"""The port's checkpoint loader (``compat/loading.py``) and its analysis
CLIs (``python -m vaeunet_tpu_torch.cli.{analyze,visualize,evaluate,predict}``):

- ``load_model`` on reference-format ``.pth`` files (the ResNet VAE-UNet,
  the plain UNet with ``bilinear`` both ways, a bare state dict with the
  milesial ``mask_values``) gives logits within 5e-4 of the JAX package's
  ``load_model_and_variables`` on the same file; on a run dir of the port
  it gives back the saved weights bit for bit; a JAX orbax run dir and a
  missing path are refused;
- the train CLI's ``--load`` takes a ``.pth``;
- each CLI's parser has every option, ``dest``, default and choice of its
  top-level script, plus ``--device``;
- each CLI runs with ``--device cpu`` on a tiny synthetic IDRiD set and
  writes its outputs, and refuses to run without CUDA unless asked.
"""

import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from vaeunet_tpu.compat.loading import load_model_and_variables
from vaeunet_tpu.models.unet import UNet as JaxUNet
from vaeunet_tpu.training.config import TrainConfig as JaxTrainConfig

import vaeunet_tpu_torch.training.loop as loop
from tests.test_torch_model import randomize_bn_stats, resnet34_pair
from vaeunet_tpu_torch.cli import analyze as analyze_cli
from vaeunet_tpu_torch.cli import evaluate as evaluate_cli
from vaeunet_tpu_torch.cli import predict as predict_cli
from vaeunet_tpu_torch.cli import train as train_cli
from vaeunet_tpu_torch.cli import visualize as visualize_cli
from vaeunet_tpu_torch.compat import load_model, load_state
from vaeunet_tpu_torch.models import UNet, UNetResNet, build_unet
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, save_checkpoint
from vaeunet_tpu_torch.vae_utils import to_nchw

REPO = Path(__file__).resolve().parents[1]
REFERENCE_PARAMS = {"lesion_type": "EX", "patch_size": 512, "img_scale": 0.5, "beta": 0.001,
                    "free_bits": 1e-3, "kl_anneal_epochs": 20, "latent_injection": "all",
                    "use_attention": True, "seed": 42, "model_type": "resnet"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def image(seed: int = 0, hw=(64, 64)) -> np.ndarray:
    return np.random.RandomState(seed).rand(1, *hw, 3).astype(np.float32)


def port_logits(model, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        xt = to_nchw(torch.from_numpy(x))
        out = model(xt, sample=False)[0] if isinstance(model, UNetResNet) else model(xt)
    return out.permute(0, 2, 3, 1).numpy()


def jax_logits(model, variables, x: np.ndarray) -> np.ndarray:
    if isinstance(model, JaxUNet):
        return np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    return np.asarray(model.apply(variables, jnp.asarray(x), train=False, sample=False)[0])


def test_load_model_reads_a_reference_resnet_checkpoint_as_jax_does(tmp_path):
    model, _ = resnet34_pair()
    path = tmp_path / "best_model.pth"
    torch.save({"model_state_dict": model.state_dict(), "params": REFERENCE_PARAMS,
                "epoch": 3}, path)
    ours, config = load_model(str(path), device="cpu")
    ref_model, variables, ref_config = load_model_and_variables(str(path))
    assert isinstance(ours, UNetResNet) and not ours.training
    assert (config.model_type, config.img_scale, config.patch_size, config.seed) == (
        ref_config.model_type, ref_config.img_scale, ref_config.patch_size,
        ref_config.seed) == ("resnet", 0.5, 512, 42)
    sd = ours.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    x = image(1)
    np.testing.assert_allclose(port_logits(ours, x), jax_logits(ref_model, variables, x),
                               atol=5e-4)


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("bare", [False, True])
def test_load_model_reads_a_reference_unet_checkpoint_as_jax_does(tmp_path, bilinear, bare):
    """The plain UNet's ``bilinear`` comes from its state dict: no
    transposed-conv ``.up.weight`` keys.  A bare state dict (the milesial
    format) carries ``mask_values``, which is dropped."""
    unet = build_unet(3, 1, bilinear=bilinear, seed=2, device="cpu")
    randomize_bn_stats(unet, seed=3)
    path = tmp_path / "unet.pth"
    sd = unet.state_dict()
    torch.save({**sd, "mask_values": [0, 1]} if bare else
               {"model_state_dict": sd, "params": {"model_type": "basic", "seed": 1}}, path)
    ours, config = load_model(str(path), device="cpu")
    # the JAX loader leaves bilinear to its overrides
    ref_model, variables, ref_config = load_model_and_variables(
        str(path), overrides={"bilinear": bilinear})
    assert isinstance(ours, UNet) and isinstance(ref_model, JaxUNet)
    assert config.model_type == ref_config.model_type == "basic"
    assert config.bilinear == ref_model.bilinear == bilinear
    x = image(2)
    np.testing.assert_allclose(port_logits(ours, x), jax_logits(ref_model, variables, x),
                               atol=5e-4)


def small_config(tmp_path, **kw) -> TrainConfig:
    return TrainConfig(model_type="resnet", backbone="resnet18", latent_dim=8, batch_size=2,
                       gradient_accumulation_steps=1, amp=False, patch_size=32,
                       checkpoint_dir=str(tmp_path / "ckpt"), **kw)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run dir of the port: a resnet18 VAE-UNet, latent 8."""
    tmp = tmp_path_factory.mktemp("run")
    config = small_config(tmp, latent_injection="first")
    state = create_train_state(config, seed=5, device="cpu")
    randomize_bn_stats(state.model, seed=6)
    path = config.checkpoint_path()
    save_checkpoint(path, state, config)
    return path, state.model.state_dict(), config


def test_load_model_reads_a_run_dir_of_the_port(run_dir):
    path, saved, config = run_dir
    model, got = load_model(path, overrides={"latent_injection": "all"}, device="cpu")
    assert got == config and model.latent_injection == "first"     # the run dir wins
    sd = model.state_dict()
    assert sd.keys() == saved.keys() and all(torch.equal(sd[k], saved[k]) for k in saved)
    state, got = load_state(path)
    assert got == config and all(torch.equal(state[k], saved[k]) for k in saved)


def test_load_refuses_a_jax_run_dir_and_a_missing_path(tmp_path):
    run = tmp_path / "EX_resnet_attn_scale1_patch512"
    (run / "best" / "default").mkdir(parents=True)
    (run / "best" / "_CHECKPOINT_METADATA").write_text("{}")
    (run / "config.json").write_text(JaxTrainConfig().to_json())
    with pytest.raises(NotImplementedError, match="jax"):
        load_model(str(run), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "no_such.pth"), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_state(str(tmp_path / "no_such_run_dir"))


def test_train_cli_loads_a_reference_pth(tmp_path, monkeypatch):
    """``--load x.pth`` hands the checkpoint's weights to the loop."""
    unet = build_unet(3, 1, seed=4, device="cpu")
    path = tmp_path / "weights.pth"
    torch.save({"model_state_dict": unet.state_dict(), "params": {"model_type": "basic"}},
               path)
    got = {}
    monkeypatch.setattr(loop, "train_model", lambda config, model_state=None, **kw:
                        got.update(config=config, state=model_state, **kw) or "trained")
    assert train_cli.main(["--load", str(path), "--model-type", "basic", "--device", "cpu",
                           "--epochs", "1"]) == "trained"
    sd = unet.state_dict()
    assert got["state"].keys() == sd.keys()
    assert all(torch.equal(got["state"][k], v) for k, v in sd.items())
    assert got["config"].model_type == "basic" and got["resume_from"] is None
    with pytest.raises(NotImplementedError, match="jax"):
        train_cli.main(["--load", str(tmp_path), "--device", "cpu"])


# ----- parsers ---------------------------------------------------------------

class _Caught(Exception):
    pass


def reference_parser(monkeypatch, script: str, entry: str) -> argparse.ArgumentParser:
    """The parser a top-level script builds, caught as it parses."""
    spec = importlib.util.spec_from_file_location(f"_reference_{Path(script).stem}",
                                                  REPO / script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    caught = {}

    def catch(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Caught

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Caught):
        getattr(module, entry)()
    monkeypatch.undo()
    return caught["parser"]


def table(parser):
    return {a.dest: (tuple(sorted(a.option_strings)), a.default, a.choices, a.nargs,
                     a.required, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("script,entry,cli,argv", [
    ("analyze_model.py", "get_args", analyze_cli,
     ["--lesion_type", "MA", "--patch_size", "64", "--temp_values", "0.5", "2",
      "--no-attention", "--extended-metrics", "--threshold-mode", "area", "-m", "x.pth"]),
    ("visualize_vae.py", "get_args", visualize_cli,
     ["-n", "3", "-t", "0.5", "-p", "128", "--ensemble", "--unweighted", "--temperatures",
      "1", "2", "--latent-injection", "last"]),
    ("evaluate.py", "main", evaluate_cli,
     ["-m", "x.pth", "--split", "test", "--patch-size", "none", "--fixed-threshold",
      "--batch-size", "3"]),
    ("predict.py", "get_args", predict_cli,
     ["-i", "a.png", "b.png", "-o", "a_out.png", "-v", "-n", "-t", "0.3", "-s", "0.25",
      "--model-type", "resnet"]),
])
def test_parser_has_every_flag_and_default_of_its_script(monkeypatch, script, entry, cli, argv):
    theirs = reference_parser(monkeypatch, script, entry)
    ours = cli.get_parser()
    mine, ref = table(ours), table(theirs)
    assert set(mine) - set(ref) == {"device"}
    for dest, row in ref.items():
        assert mine[dest] == row, dest
    a, b = vars(ours.parse_args(argv)), vars(theirs.parse_args(argv))
    assert a.pop("device") is None
    assert a == b


# ----- the CLIs on the CPU ----------------------------------------------------

@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """IDRiD's layout at 64x64: 2 train, 1 val, 2 test fundus JPGs + EX TIFs."""
    root = tmp_path_factory.mktemp("idrid_analysis_cli")
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:64, 0:64]
    disk = (yy - 32) ** 2 + (xx - 32) ** 2 < 31 ** 2
    for split, n in (("train", 2), ("val", 1), ("test", 2)):
        (root / "imgs" / split).mkdir(parents=True)
        (root / "masks" / split / "EX").mkdir(parents=True)
        for i in range(n):
            lesion = (yy - rng.randint(20, 44)) ** 2 + (xx - rng.randint(20, 44)) ** 2 < 60
            img = np.zeros((64, 64, 3), np.uint8)
            img[disk] = (rng.randint(-20, 21, (int(disk.sum()), 3)) + [150, 70, 30]).clip(0, 255)
            img[lesion & disk] = (230, 210, 90)
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray(((lesion & disk) * 255).astype(np.uint8)).save(
                root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
    return root


@pytest.fixture(params=["matplotlib", "pil"])
def renderer(request, monkeypatch):
    """Figures by matplotlib, and by the PIL renderer of a machine without it."""
    from vaeunet_tpu_torch.utils import figures

    if request.param == "pil":
        monkeypatch.setattr(figures, "_matplotlib", lambda: None)
    return request.param


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                        # the tracker writes ./runs
    monkeypatch.setenv("VAEUNET_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path


def test_analyze_cli_writes_the_analysis_on_the_cpu(synth_root, run_dir, in_tmp, renderer):
    report = {}
    df = analyze_cli.main(["--model", run_dir[0], "--lesion_type", "EX", "--samples", "2",
                           "--data-dir", str(synth_root), "--output_dir", "out",
                           "--temp_values", "0.5", "1.0", "--extended-metrics",
                           "--device", "cpu"], report=report)
    out = in_tmp / "out" / "EX_T1.0_N2"
    csv = pd.read_csv(out / "analysis_metrics.csv")
    assert len(df) == len(csv) == 2 and len(csv.columns) == 13
    assert np.isfinite(csv.drop(columns="img_id").to_numpy()).all()
    assert len(list(out.glob("*.png"))) == 8 and not (out / "temp_pixel_data").exists()
    assert len(report["images"]) == 2
    # the tracker (offline: PNGs here) got the four panels of each image and,
    # in full-image mode, the attention maps of its four gates
    images = [p.name for p in (in_tmp / "runs").glob("*/images/*.png")]
    assert sum(n.startswith("visualizations_") for n in images) == 8, images
    assert sum(n.startswith("attention_") for n in images) == 8, images


def test_visualize_cli_writes_its_figures_on_the_cpu(synth_root, run_dir, in_tmp, renderer):
    written = visualize_cli.main(["--model", run_dir[0], "--samples", "2", "--patch_size",
                                  "48", "--compare_temperatures", "--ensemble",
                                  "--temperatures", "0.5", "1.0", "--max_images", "1",
                                  "--data-dir", str(synth_root), "--output_dir", "figs",
                                  "--device", "cpu"])
    out = in_tmp / "figs" / Path(run_dir[0]).stem / "EX" / "p48" / "T1.0" / "N2"
    assert [p.resolve().parent for p in written] == [out] * 3
    assert all(p.exists() for p in written)
    panel, temps, ens = (p.name for p in written)
    assert panel.startswith("IDRiD_00_") and temps == panel[:-4] + "_temps.png" \
        and ens == panel[:-4] + "_ensemble.png"


def test_evaluate_cli_gives_finite_metrics_on_the_cpu(synth_root, run_dir, in_tmp):
    metrics = evaluate_cli.main(["--model", run_dir[0], "--split", "val", "--patch-size",
                                 "32", "--batch-size", "4", "--data-dir", str(synth_root),
                                 "--device", "cpu"])
    assert {"dice", "iou"} <= set(metrics) and all(np.isfinite(list(metrics.values())))


def test_predict_cli_writes_masks_at_the_input_size_on_the_cpu(tmp_path, renderer):
    unet = build_unet(3, 1, seed=7, device="cpu")
    randomize_bn_stats(unet, seed=8)
    model_path = tmp_path / "unet.pth"
    torch.save(unet.state_dict(), model_path)
    img = (np.random.RandomState(9).rand(40, 56, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "fundus.png")
    written = predict_cli.main(["--model", str(model_path), "--input",
                                str(tmp_path / "fundus.png"), "--scale", "0.5", "--viz",
                                "--device", "cpu"])
    assert written == [str(tmp_path / "fundus_OUT.png")]
    mask = np.asarray(Image.open(written[0]))
    assert mask.shape == (40, 56) and set(np.unique(mask)) <= {0, 255}
    assert (tmp_path / "fundus_OUT.viz.png").exists()
    # the mask is predict_img's: predict_image at --scale, resized, thresholded
    expected = predict_cli.predict_img(unet, Image.open(tmp_path / "fundus.png").convert("RGB"),
                                       0.5, 0.5, device="cpu")
    assert np.array_equal(mask > 0, expected)


@pytest.mark.parametrize("cli,argv", [
    (analyze_cli, ["--lesion_type", "EX"]),
    (visualize_cli, []),
    (evaluate_cli, ["--model", "x.pth"]),
    (predict_cli, ["--input", "x.png"]),
])
def test_cli_refuses_the_cpu_unless_asked(monkeypatch, cli, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
