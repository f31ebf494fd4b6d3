#!/usr/bin/env python3
"""One run of one cell of ``BENCHMARK.json``, on the machine it starts on:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  It builds the cell's system under test from
``vaeunet_tpu_torch`` (set-up: the kernels' build or load, seeded data and
weights made on the card, the checked steps or the warm requests), drives
it for ``--seconds`` (the measured window), and with ``--trace 1`` then
traces a short segment for the per-layer metrics.  Once the window has
closed and the program is freed, the plain reference recomputes what the
program produced and each number compared is printed beside its limit.
The last line of standard output is the result's JSON object.

It exits with 2 and prints no result without a CUDA card (or with fewer
than the cell asks for), and with 3 where JAX or the JAX package is in
``sys.modules``, at the start or once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.guard import forbidden_modules  # noqa: E402

BREAKDOWN_ENTRIES = 10


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def refuse_forbidden(when: str) -> bool:
    found = forbidden_modules()
    if found:
        print(f"refused {when}: sys.modules holds {', '.join(found)}", file=sys.stderr)
    return bool(found)


def main(argv=None, device=None, registry=None) -> int:
    """`device` and `registry` stand in for the look for a chip and for
    ``BENCHMARK.json`` (the tests' way in, on the CPU)."""
    t_zero = time.perf_counter() - process_age_s()
    args = parse(argv)
    if refuse_forbidden("at the start"):
        return 3
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    # one host thread for torch's CPU operators: the host-bound step's rate
    # then spreads less from run to run
    os.environ["OMP_NUM_THREADS"] = "1"

    import torch

    from benchmark.harness.compare import judge
    from benchmark.harness.device import sync
    from benchmark.harness.registry import Registry
    from benchmark.harness.trace import Tracer

    registry = registry or Registry.from_file(ROOT / "BENCHMARK.json")
    cell = registry.workload(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.set_num_threads(1)

    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(cell["name"])
    driver = registry.driver(traffic["kind"]).Driver(
        cfg, registry.config_module(cell["config"]), traffic, args.seed, device)

    driver.setup()
    sync(device)
    setup_s = time.perf_counter() - t_zero
    print(f"setup: {setup_s:.3f} s, of which " + ", ".join(
        f"{k} {v:.3f}" for k, v in driver.phases.items()), file=sys.stderr)
    end_to_end = dict(driver.window(args.seconds), setup_s=setup_s)
    if getattr(driver, "slices", None):
        print(f"window: {driver.slices}", file=sys.stderr)
    tracer = None
    if args.trace:
        from vaeunet_tpu_torch.ops._ext import launch_counts

        tracer = Tracer()
        driver.traced(tracer, launch_counts)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    driver.release()
    if refuse_forbidden("once the window closed"):
        return 3

    if args.trace:
        driver.count()
    correct, checks = judge(driver.check(), limits)

    if args.trace:
        metrics = {}
        for m in registry.per_layer(cell["name"]):
            value = registry.read(m, driver.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in registry.end_to_end(cell["name"])}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(driver.attempted),
              "failed": int(driver.failed), "metrics": metrics, "device": dev}
    if tracer is not None:
        dev["busy_s"] = tracer.busy_s()
        dev["window_s"] = tracer.window_s
        ops = sorted(tracer.seconds_by_name().items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in ops[:BREAKDOWN_ENTRIES]],
            "idle_gaps": [[n, s] for n, s in tracer.idle_gaps()[:BREAKDOWN_ENTRIES]]}
        fams = sorted(tracer.seconds_by_family().items(), key=lambda kv: -kv[1])
        print(f"trace: clocks aligned {tracer.aligned()}, {len(tracer.kernels())} kernels in "
              f"{driver.readings.traced_items} items, families "
              + ", ".join(f"{f} {s:.6f} s" for f, s in fams), file=sys.stderr)
        print(f"trace: launch counts {driver.readings.counters}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}

    if refuse_forbidden("before the result"):
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
