#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell,
on the card, at the cell's own size (not part of a benchmark run):

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 [--controls 3]

For each seed it builds the cell's system under test as a run does and
reads the numbers a run compares: for a training cell after the checked
steps of set-up, for a serving cell on the answers a run keeps.  On the
first ``--controls`` seeds it also reads them for the control, the
reference put in the program's place one precision below the
configuration's (fp8 for a bf16 step, TF32 for a float32 request), and for
a training cell for a planted fault: half of each batch left out, the mean
taken over the rest.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL = {"bf16": "fp8", "fp16": "fp8", "fp32": "tf32"}


def look(prog: dict, ref: dict) -> dict:
    """Where a training number's gap sits: its three worst leaves (the
    program's norm, the reference's, the gap over max(leaf, median leaf)),
    the median leaf's gap, and the gap of the global norm."""
    from benchmark.harness.stats import median, percentile

    out = {"loss_step_gaps": [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]}
    for key in ("grad", "change"):
        p, r = prog[key], ref[key]
        floor = median(list(r.values()))
        gaps = {n: abs(p[n] - r[n]) / max(r[n], floor) for n in r}
        worst = sorted(gaps, key=lambda n: -gaps[n])[:3]
        total_p = sum(v * v for v in p.values()) ** 0.5
        total_r = sum(v * v for v in r.values()) ** 0.5
        out[key] = {"worst": [[n, p[n], r[n], gaps[n]] for n in worst],
                    "worst_leaf_gap": gaps[worst[0]],
                    "median_leaf_gap": median(list(gaps.values())),
                    "leaf_gap_quantiles": {q: percentile(list(gaps.values()), q)
                                           for q in (25, 75, 90)},
                    "global_gap": abs(total_p - total_r) / total_r}
    return out


def train_readings(d, controls: bool) -> dict:
    """The program's numbers; with `controls`, the fp8 control's, the
    half-batch fault's and the bf16 witness's (the reference with its
    operands in the configuration's own precision)."""
    from benchmark.harness.compare import train_numbers

    d.setup()
    d.release()
    ref = d.follow_reference()
    out = {"program": train_numbers(d.program, ref), "look": look(d.program, ref)}
    if controls:
        import torch

        quant = CONTROL[d.hp["precision"]]
        variants = {"control_" + quant: d.follow_reference(quant=quant),
                    "half_batch": d.follow_reference(half_batch=True),
                    "witness_" + d.hp["precision"]: d.follow_reference(quant=d.hp["precision"])}
        if d.hp["precision"] == "bf16":     # the reference wholly in bf16, and the program in fp32
            variants["witness_bf16_model"] = d.follow_reference(dtype=torch.bfloat16)
            cfg = {**d.cfg, "train": {**d.hp, "amp": False}}
            fp32 = type(d)(cfg, d.mod, d.traffic, d.seed, d.device)
            fp32.setup()
            fp32.release()
            variants["program_fp32"] = fp32.program
            del fp32
        for name, read in variants.items():
            out[name] = train_numbers(read, ref)
            out["look_" + name] = look(read, ref)
    return out


def serving_readings(d, controls: bool) -> dict:
    from benchmark.reference.layers import set_quant

    d.setup()
    for i in sorted(d.keep):
        d.kept[i] = d._timed(i)[0]
    d.release()
    out = {"program": d.check()}
    if controls:
        quant = CONTROL[d.cfg["serve"]["precision"]]
        ref = d.reference()
        d.kept = {i: d.reference_answer(set_quant(ref, quant), i) for i in sorted(d.keep)}
        out["control_" + quant] = d.check()
    return out


def main(argv=None) -> int:
    import torch

    from benchmark.harness.registry import Registry

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    reg = Registry.from_file(ROOT / "BENCHMARK.json")
    cell = reg.workload(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    mod = reg.config_module(cell["config"])
    driver = reg.driver(traffic["kind"]).Driver
    device = torch.device("cuda", 0)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        d = driver(cfg, mod, traffic, seed, device)
        read = train_readings if traffic["kind"] == "train" else serving_readings
        out = read(d, n < args.controls)
        del d
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
