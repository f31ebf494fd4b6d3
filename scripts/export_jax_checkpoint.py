#!/usr/bin/env python
"""Export a JAX run dir (and a JAX pretrained encoder dir) to numpy files
that the PyTorch port reads without jax.

    python scripts/export_jax_checkpoint.py checkpoints/EX_...      # a run dir
    python scripts/export_jax_checkpoint.py --encoder checkpoints/encoder_ssl

A run dir of ``vaeunet_tpu`` holds an orbax checkpoint (``best/``) beside
its ``config.json``; orbax needs jax, which ``vaeunet_tpu_torch`` never
imports.  This script restores the run's weights as every JAX CLI does
(``vaeunet_tpu.compat.loading.load_model_and_variables``), flattens the
``{'params', 'batch_stats'}`` tree into '/'-joined names and writes them as
``jax_variables.npz`` beside ``config.json``; ``vaeunet_tpu_torch.compat.
load_model`` then loads the run dir (converting with
``compat/jax_weights.py``).  With ``--encoder DIR`` it restores ``DIR/encoder``
(``scripts/pretrain_encoder.py``'s output) as ``train.py
--pretrained-encoder`` does and writes ``DIR/encoder.npz``, which the port's
``cli.train --pretrained-encoder DIR`` reads.  Nothing else is written or
changed.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

JAX_VARIABLES = "jax_variables.npz"
JAX_ENCODER = "encoder.npz"


def flatten(tree, prefix: str = "") -> dict:
    """A nested mapping of arrays -> {'a/b/c': numpy array}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if hasattr(value, "items"):
            out.update(flatten(value, name + "/"))
        else:
            out[name] = np.asarray(value)
    return out


def export_run(run_dir: str) -> Path:
    """``run_dir``'s restored variables -> ``run_dir/jax_variables.npz``."""
    from vaeunet_tpu.compat.loading import load_model_and_variables

    run = Path(run_dir)
    if not (run / "config.json").is_file():
        raise FileNotFoundError(f"{run} has no config.json: not a JAX run dir")
    _, variables, _ = load_model_and_variables(str(run))
    out = run / JAX_VARIABLES
    np.savez(out, **flatten({"params": variables["params"],
                             "batch_stats": variables["batch_stats"]}))
    return out


def export_encoder(enc_dir: str) -> Path:
    """``enc_dir/encoder`` (orbax) -> ``enc_dir/encoder.npz``."""
    import orbax.checkpoint as ocp

    d = Path(enc_dir).absolute()
    with ocp.PyTreeCheckpointer() as ckptr:
        enc = ckptr.restore(d / "encoder")
    out = d / JAX_ENCODER
    np.savez(out, **flatten(enc))
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", nargs="?", default=None,
                   help="A JAX run dir (orbax best/ and config.json)")
    p.add_argument("--encoder", default=None, metavar="DIR",
                   help="A JAX pretrained-encoder dir (DIR/encoder, orbax)")
    args = p.parse_args(argv)
    if args.run_dir is None and args.encoder is None:
        p.error("give a run dir, --encoder DIR, or both")
    written = []
    if args.run_dir is not None:
        written.append(export_run(args.run_dir))
    if args.encoder is not None:
        written.append(export_encoder(args.encoder))
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
