"""The port's contrastive pretext (``ContrastiveProjector``, ``ntxent_loss``,
``make_contrastive_step``) against the JAX package on the CPU, and the
pretrain CLI (``python -m vaeunet_tpu_torch.cli.pretrain``): its parser
against ``scripts/pretrain_encoder.py``'s, a run on the synthetic set whose
encoder the train CLI's ``--pretrained-encoder`` then starts from, and the
refusal of a JAX (orbax) encoder directory.

Weights: a seeded flax init of JAX's ``ContrastiveProjector`` (resnet18,
64^2, compiled by ``jax.jit``) with randomized BN statistics, carried into
the port by ``convert_jax_pretrain`` (``proj1``/``proj2`` as transposed
Linears).  The two views are fed to both sides: JAX's ``augment_sample``
patched for the test to two fixed transforms, the port's ``views=``.
Bounds: NT-Xent 1e-6; the eval projection atol 1e-5; the step's loss rtol
2e-3 (JAX's training-mode BN rounding, as ``tests/test_torch_pretrain.py``
measures it), parameters 2 lr (+ 1e-6), running statistics 1e-4 + 1e-3
|ref|.
"""

import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import vaeunet_tpu.data.augment as jax_augment
import vaeunet_tpu.training.pretrain as jax_pretrain

from vaeunet_tpu_torch.cli import pretrain as pretrain_cli
from vaeunet_tpu_torch.cli import train as train_cli
from vaeunet_tpu_torch.compat import convert_jax_pretrain
from vaeunet_tpu_torch.compat.loading import load_encoder_state
from vaeunet_tpu_torch.training.pretrain import (
    ContrastiveProjector,
    build_pretrain_model,
    create_pretrain_state,
    make_contrastive_step,
    ntxent_loss,
)
from tests.test_torch_pretrain import randomized

HW, B, LR = 64, 4, 1e-3
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_ntxent_exact_value_and_order():
    """JAX ``test_ntxent_loss_prefers_aligned_pairs``: the orthogonal-pair
    value, and misaligned positives score worse."""
    e = torch.eye(4)
    t = 0.5
    expect = -np.log(np.exp(1 / t) / (np.exp(1 / t) + 2.0))
    got = ntxent_loss(e[:2], e[:2], temperature=t).item()
    assert abs(got - expect) < 1e-5
    assert ntxent_loss(e[:2], e[:2].flip(0), temperature=t).item() > got + 0.1


@pytest.mark.parametrize("temperature", [0.1, 0.2, 1.0])
def test_ntxent_matches_jax(temperature):
    rng = np.random.RandomState(int(temperature * 10))
    z = rng.randn(2, 6, 16).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    ref = float(jax_pretrain.ntxent_loss(jnp.asarray(z[0]), jnp.asarray(z[1]), temperature))
    got = ntxent_loss(torch.from_numpy(z[0]), torch.from_numpy(z[1]), temperature).item()
    assert got == pytest.approx(ref, abs=1e-6)


@pytest.fixture(scope="module")
def projector_pair():
    jmodel = jax_pretrain.ContrastiveProjector(backbone="resnet18")
    init = jax.jit(lambda k: jmodel.init({"params": k}, jnp.zeros((1, HW, HW, 3)), train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 3)
    return jmodel, variables


def _port(variables) -> ContrastiveProjector:
    model = ContrastiveProjector(backbone="resnet18").to(memory_format=torch.channels_last)
    model.load_state_dict(convert_jax_pretrain(variables))
    return model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(5).rand(B, HW, HW, 3).astype(np.float32)


def test_contrastive_projector_matches_jax(projector_pair, images):
    """Eval mode: the pooled encoder, the projection head, unit norm."""
    jmodel, variables = projector_pair
    ref = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(images),
                                  train=False))
    model = _port(variables).eval()
    with torch.no_grad():
        z = model(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    assert z.dtype == torch.float32 and z.shape == ref.shape == (B, 128)
    np.testing.assert_allclose(z.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(z.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_contrastive_step_matches_jax(projector_pair, images, monkeypatch):
    jmodel, variables = projector_pair
    order = []

    def fixed_view(key, img, mask):
        """First call: a contrast change; second: a vertical flip."""
        order.append(len(order))
        return (img * 0.8 + 0.1 if order[-1] == 0 else img[::-1]), mask

    monkeypatch.setattr(jax_augment, "augment_sample", fixed_view)
    tx, jstep = jax_pretrain.make_contrastive_step(jmodel, LR, amp=False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    params, stats, _, _, ref_loss, _ = jstep(params, stats, tx.init(params), jnp.asarray(images),
                                             jax.random.PRNGKey(1))
    assert order == [0, 1]
    ref = convert_jax_pretrain({"params": jax.tree.map(np.asarray, params),
                                "batch_stats": jax.tree.map(np.asarray, stats)})

    model = _port(variables)
    state = create_pretrain_state(model, LR)
    views = (images * 0.8 + 0.1, images[:, ::-1].copy())
    state, loss, same = make_contrastive_step(model, amp=False)(state, images, views=views)
    assert torch.equal(loss, same) and state.step == 1
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=2e-3)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            torch.testing.assert_close(v, ref[k], atol=1e-4, rtol=1e-3, msg=k)
        else:
            torch.testing.assert_close(v, ref[k], atol=2 * LR + 1e-6, rtol=0, msg=k)


def test_contrastive_views_come_from_the_augmentation(images):
    """Without ``views`` the two views are drawn by ``augment_batch`` from
    the state's generator: one seed repeats the step, another does not."""
    losses = []
    for seed in (3, 3, 4):
        model = build_pretrain_model("contrastive", "resnet18", seed=0, device="cpu")
        state = create_pretrain_state(model, LR, seed=seed)
        losses.append(make_contrastive_step(model, amp=False)(state, images)[1].item())
    assert losses[0] == losses[1] != losses[2]


def script_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser ``scripts/pretrain_encoder.py`` builds, caught as it parses."""
    spec = importlib.util.spec_from_file_location("pretrain_encoder_script",
                                                  REPO / "scripts" / "pretrain_encoder.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    caught = {}

    class Caught(Exception):
        pass

    def catch(self, args=None, namespace=None):
        caught["parser"] = self
        raise Caught

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught):
        script.main()
    monkeypatch.undo()
    return caught["parser"]


def test_parser_has_every_flag_and_default_of_the_script(monkeypatch):
    theirs = script_parser(monkeypatch)

    def table(parser):
        return {a.dest: (tuple(sorted(a.option_strings)), a.default, a.choices)
                for a in parser._actions if a.dest != "help"}

    mine, ref = table(pretrain_cli.get_parser()), table(theirs)
    assert len(ref) == 13
    for dest, entry in ref.items():
        assert mine.get(dest) == entry, dest
    assert set(mine) - set(ref) == {"device"}
    argv = ["--scale", "0.5", "--patch-size", "64", "--no-amp", "--pretext", "contrastive",
            "--temperature", "0.3", "--epochs", "2", "--backbone", "resnet18"]
    a = vars(pretrain_cli.get_parser().parse_args(argv))
    a.pop("device")
    assert a == vars(theirs.parse_args(argv))


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("idrid_pretrain")
    rng = np.random.RandomState(2)
    for split, n in (("train", 2), ("val", 1)):
        (root / "imgs" / split).mkdir(parents=True)
        (root / "masks" / split / "EX").mkdir(parents=True)
        for i in range(n):
            yy, xx = np.mgrid[0:128, 0:128]
            blob = (yy - rng.randint(40, 88)) ** 2 + (xx - rng.randint(40, 88)) ** 2 < 200
            img = np.full((128, 128, 3), 40, np.uint8)
            img[blob] = 220
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray((blob * 255).astype(np.uint8)).save(
                root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
    return root


@pytest.mark.parametrize("pretext", ["masked", "contrastive"])
def test_cli_pretrains_and_the_train_cli_starts_from_it(pretext, synth_root, tmp_path,
                                                        monkeypatch):
    """One epoch of ``cli.pretrain`` writes ``<out>/encoder.pt`` (the
    encoder entries only, moved by training); ``cli.train
    --pretrained-encoder <out>`` then starts from them bit for bit."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("VAEUNET_CACHE_DIR", str(tmp_path / "cache"))
    out = tmp_path / "ssl"
    path = pretrain_cli.main(["--data-dir", str(synth_root), "--patch-size", "64",
                              "--batch-size", "2", "--epochs", "1", "--no-amp",
                              "--pretext", pretext, "--out", str(out), "--device", "cpu"])
    assert path == out / "encoder.pt"
    enc = load_encoder_state(str(out))
    fresh = build_pretrain_model(pretext, "resnet34", seed=0, device="cpu").state_dict()
    assert enc and set(enc) == {k for k in fresh if k.startswith("encoder.")}
    assert not all(torch.equal(enc[k], fresh[k]) for k in enc)
    state = train_cli.main(["--data-dir", str(synth_root), "--patch-size", "64",
                            "--batch-size", "2", "--epochs", "0", "--no-amp",
                            "--checkpoint-dir", str(tmp_path / "ckpt"), "--device", "cpu",
                            "--pretrained-encoder", str(out)])
    got = state.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in enc.items())


def test_a_jax_encoder_directory_is_refused(tmp_path):
    (tmp_path / "encoder").mkdir()
    with pytest.raises(NotImplementedError, match="jax"):
        load_encoder_state(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_encoder_state(str(tmp_path / "missing"))
