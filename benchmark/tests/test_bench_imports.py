"""Nothing the card runs brings JAX or the JAX package into the process:
top-level module names compared whole (``vaeunet_tpu_torch`` begins with
``vaeunet_tpu``)."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.harness.guard import forbidden_modules
from benchmark.tests.tiny import ROOT

PROBE = r"""
import json, sys
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(2)
from benchmark import run, calibrate
from benchmark.harness.guard import forbidden_modules
from benchmark.harness.registry import Registry
from benchmark.tests.tiny import tiny_registry
import tempfile
reg = tiny_registry(tempfile.mkdtemp())
for w in reg.spec["workloads"]:
    reg.config_module(w["config"])
    reg.driver(reg.traffic(w["traffic"])["kind"])
for m in reg.spec["per_layer"]:
    reg.reader(m["name"])
rc = run.main(["--workload", "vaeunet_r34-predict-carvana", "--seed", "5", "--seconds", "0.1",
               "--trace", "0"], device="cpu", registry=reg)
print(json.dumps({"rc": rc, "forbidden": forbidden_modules(),
                  "port": "vaeunet_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_the_port_and_no_jax():
    out = subprocess.run([sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + PROBE],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"rc": 0, "forbidden": [], "port": True}, out.stderr[-2000:]


def test_names_are_compared_whole():
    names = ["vaeunet_tpu_torch", "vaeunet_tpu_torch.ops", "jaxtyping", "flaxen",
             "vaeunet_tpu", "vaeunet_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]
    assert forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib", "vaeunet_tpu",
                                        "vaeunet_tpu.models"]


def test_a_run_refuses_when_jax_is_loaded(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", sys)
    rc = run.main(["--workload", "vaeunet_r34-train-b16", "--seed", "1", "--seconds", "1"])
    assert rc == 3
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err
