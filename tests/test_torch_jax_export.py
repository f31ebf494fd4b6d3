"""JAX run dirs and JAX pretrained-encoder dirs into the port, through
``scripts/export_jax_checkpoint.py`` (JAX side: restore as the JAX CLIs do,
write the flax tree as an ``.npz`` of '/'-joined names) and the port's
``compat/loading.py`` (numpy in, no jax):

- a run dir written by the JAX package's ``save_checkpoint``, exported,
  then loaded by the ``load_model`` that ``cli.predict`` calls: logits
  within 5e-4, mu and logvar within 1e-4 of the JAX package's
  ``load_model_and_variables`` on the same dir, for the resnet34 VAE-UNet
  and the plain UNet (both ``bilinear`` settings);
- an encoder dir written as ``scripts/pretrain_encoder.py`` writes it,
  exported, then given to ``cli.train --pretrained-encoder``: the state it
  trains from equals the JAX package's ``transplant_encoder`` tree, entry
  for entry;
- a JAX run dir or encoder dir that was not exported is refused with the
  export command in the message.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from PIL import Image

import vaeunet_tpu.compat.loading as jax_loading
from vaeunet_tpu.compat.torch_weights import (
    convert_unet_resnet_state_dict,
    convert_unet_state_dict,
)
from vaeunet_tpu.models.unet import UNet as JaxUNet
from vaeunet_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from vaeunet_tpu.training.config import TrainConfig as JaxTrainConfig
from vaeunet_tpu.training.pretrain import (
    MaskedReconstructor,
    encoder_subtree,
    transplant_encoder,
)
from vaeunet_tpu.training.state import create_train_state as jax_create_train_state

import vaeunet_tpu_torch.training.loop as loop
from tests.test_torch_model import randomize_bn_stats, resnet34_pair
from vaeunet_tpu_torch.cli import predict as predict_cli
from vaeunet_tpu_torch.cli import train as train_cli
from vaeunet_tpu_torch.compat.loading import load_encoder_state, load_model
from vaeunet_tpu_torch.models import UNet, UNetResNet, build_unet
from vaeunet_tpu_torch.training import build_model
from vaeunet_tpu_torch.vae_utils import to_nchw

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("_script_export",
                                               REPO / "scripts" / "export_jax_checkpoint.py")
EXPORT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(EXPORT)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_run_dir(path: Path, config: JaxTrainConfig, variables) -> str:
    """A run dir as the JAX training loop writes it: orbax ``best/`` and
    ``config.json``."""
    state = jax_create_train_state(config, jax.random.PRNGKey(0),
                                   variables=jax.tree.map(jnp.asarray, variables))
    jax_save_checkpoint(str(path), state, config, block=True)
    return str(path)


def export(run: str, monkeypatch) -> tuple:
    """The export script on `run`; -> what its ``load_model_and_variables``
    (the JAX CLIs' loader) restored, the JAX side of every comparison."""
    restored = []

    def recorded(*a, **k):
        restored.append(load(*a, **k))
        return restored[-1]

    load = jax_loading.load_model_and_variables
    monkeypatch.setattr(jax_loading, "load_model_and_variables", recorded)
    assert EXPORT.main([run]) == [Path(run) / "jax_variables.npz"]
    return restored[0]


def image(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(1, 64, 64, 3).astype(np.float32)


def test_an_exported_vae_unet_run_dir_loads_as_in_jax(tmp_path, monkeypatch):
    model, variables = resnet34_pair()
    run = jax_run_dir(tmp_path / "run", JaxTrainConfig(model_type="resnet", patch_size=64),
                      variables)
    ref_model, ref_vars, ref_config = export(run, monkeypatch)
    ours, config = load_model(run, device="cpu")
    assert isinstance(ours, UNetResNet) and not ours.training
    assert (config.model_type, config.backbone, config.latent_dim, config.patch_size) == (
        ref_config.model_type, ref_config.backbone, ref_config.latent_dim,
        ref_config.patch_size) == ("resnet", "resnet34", 32, 64)
    sd = ours.state_dict()
    for k, v in model.state_dict().items():      # the weights went round unchanged
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k
    x = image(1)
    with torch.no_grad():
        logits, mu, logvar = ours(to_nchw(torch.from_numpy(x)), sample=False)
    ref = ref_model.apply(ref_vars, jnp.asarray(x), train=False, sample=False)
    np.testing.assert_allclose(logits.permute(0, 2, 3, 1).numpy(), np.asarray(ref[0]),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref[1]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(ref[2]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("bilinear", [False, True])
def test_an_exported_unet_run_dir_predicts_as_in_jax(tmp_path, monkeypatch, bilinear):
    """The plain UNet, through the predict CLI itself: its mask equals the
    JAX model's probabilities on the same weights, resized and thresholded."""
    unet = build_unet(3, 1, bilinear=bilinear, seed=2, device="cpu")
    randomize_bn_stats(unet, seed=3)
    variables = convert_unet_state_dict(unet.state_dict(), bilinear=bilinear)
    run = jax_run_dir(tmp_path / "run",
                      JaxTrainConfig(model_type="basic", bilinear=bilinear, patch_size=64),
                      variables)
    ref_model, ref_vars, _ = export(run, monkeypatch)
    ours, config = load_model(run, device="cpu")
    assert isinstance(ours, UNet) and isinstance(ref_model, JaxUNet)
    assert config.model_type == "basic" and config.bilinear == bilinear
    x = image(2)
    with torch.no_grad():
        logits = ours(to_nchw(torch.from_numpy(x))).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(ref_model.apply(ref_vars, jnp.asarray(x), train=False))
    np.testing.assert_allclose(logits, ref, rtol=0, atol=5e-4)

    png = tmp_path / "in.png"
    Image.fromarray((x[0] * 255).astype(np.uint8)).save(png)
    [mask_file] = predict_cli.main(["--model", run, "--input", str(png), "--scale", "1",
                                    "--device", "cpu"])
    arr = np.asarray(Image.open(png).convert("RGB"), np.float32)[None] / 255.0
    p = jax.nn.sigmoid(ref_model.apply(ref_vars, jnp.asarray(arr), train=False))[0, ..., 0]
    p = np.asarray(p)
    mask = np.asarray(Image.open(mask_file)) > 0
    near = np.abs(p - 0.5) < 1e-4
    assert mask.shape == p.shape and np.array_equal(mask[~near], (p > 0.5)[~near])


def jax_encoder_dir(path: Path) -> dict:
    """``scripts/pretrain_encoder.py``'s output: ``encoder_subtree`` of a
    masked-reconstruction model saved with orbax to ``path/encoder``; its
    BN statistics randomized so that a mix-up of mean and var shows."""
    model = MaskedReconstructor(backbone="resnet34")
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), train=False))(
        jax.random.PRNGKey(5))
    rng = np.random.RandomState(6)
    stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 2.0, a.shape), jnp.float32),
                         v["batch_stats"])
    enc = encoder_subtree({"params": v["params"], "batch_stats": stats})
    path.mkdir()
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path.absolute() / "encoder", enc)
    return enc


def test_an_exported_encoder_dir_starts_the_train_cli_as_in_jax(tmp_path, monkeypatch):
    enc = jax_encoder_dir(tmp_path / "ssl")
    assert EXPORT.main(["--encoder", str(tmp_path / "ssl")]) == [
        (tmp_path / "ssl" / "encoder.npz").absolute()]
    got = {}

    def capture(config, model_state=None, **kw):
        got.update(config=config, state=model_state)

    monkeypatch.setattr(loop, "train_model", capture)
    monkeypatch.chdir(tmp_path)
    train_cli.main(["--epochs", "1", "--no-amp", "--device", "cpu", "--pretrained-encoder",
                    str(tmp_path / "ssl")])
    # JAX: the same seeded init, its encoder replaced by the restored tree
    init = build_model(got["config"], seed=got["config"].seed, device="cpu").state_dict()
    ref = transplant_encoder(jax.tree.map(jnp.asarray, convert_unet_resnet_state_dict(init)),
                             enc)
    ours = convert_unet_resnet_state_dict(got["state"])
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_ours = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert len(flat_ref) == len(flat_ours)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_ours[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    # the encoder moved, the rest is the seeded init
    assert not torch.equal(got["state"]["encoder.conv1.weight"], init["encoder.conv1.weight"])
    assert torch.equal(got["state"]["final_conv.weight"], init["final_conv.weight"])
    assert set(load_encoder_state(str(tmp_path / "ssl"))) == {
        k for k in init if k.startswith("encoder.")}


def test_unexported_jax_dirs_are_refused_with_the_command(tmp_path):
    run = tmp_path / "run"
    (run / "best" / "default").mkdir(parents=True)
    (run / "config.json").write_text(JaxTrainConfig().to_json())
    with pytest.raises(NotImplementedError, match="export_jax_checkpoint.py .*run"):
        load_model(str(run), device="cpu")
    (tmp_path / "ssl" / "encoder").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="export_jax_checkpoint.py --encoder"):
        load_encoder_state(str(tmp_path / "ssl"))
