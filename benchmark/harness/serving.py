"""The closed loop of the serving kinds: one caller sends a request, waits
for its answer (a ``torch.cuda.synchronize()``), then sends the next, as
``cli.analyze`` and ``cli.bench_tiled`` drive the port.

A driver subclasses :class:`ServingDriver` with its request
(``_inputs(i)``, ``_call(inputs, tracer)`` -> the answer), its reference
answer and its end-to-end metrics.  Request i's inputs come from the seed
and i alone, so the reference remakes them.  The answers of a sample of
requests, drawn from the seed among the first ``check_among``, are kept on
the device until the window has closed and the program is freed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import seeds, weights
from benchmark.harness.device import free, sync
from benchmark.harness.readings import Readings

WARM_STREAM = 1 << 40           # request indices of the warm-up, apart from the window's


class ServingDriver:
    kind = ""

    def __init__(self, cfg: Dict, cfgmod, traffic: Dict, seed: int, device):
        self.cfg, self.mod, self.traffic = cfg, cfgmod, traffic
        self.seed, self.device = seed, torch.device(device)
        self.readings = Readings(kind=self.kind, precision=cfg["serve"]["precision"])
        rng = np.random.default_rng(seeds.derive(seed, seeds.CHECK))
        self.keep = set(rng.choice(traffic["check_among"], traffic["check_requests"],
                                   replace=False).tolist())
        self.kept: Dict[int, object] = {}
        self.latency: List[float] = []
        self.attempted = self.failed = 0

    def _generator(self, i: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            seeds.derive(self.seed, seeds.DATA, i))

    def _weights(self):
        with torch.device("meta"):
            ref = self.mod.reference_model(self.cfg)
        return weights.make(ref, seeds.derive(self.seed, seeds.WEIGHTS), self.device,
                            serving=True)

    def _timed(self, i: int, tracer=None):
        inputs = self._inputs(i)
        t0 = time.perf_counter()
        out = self._call(inputs, tracer)
        sync(self.device)
        return out, time.perf_counter() - t0

    def _span(self, tracer, name: str):
        return tracer.span(name) if tracer is not None else contextlib.nullcontext()

    def setup(self) -> None:
        mark = time.perf_counter()
        self.model = self.mod.program_serving(self.cfg, self.device)
        weights.load(self.model, self._weights())
        sync(self.device)
        self.phases = {"build_s": time.perf_counter() - mark}
        for k in range(self.traffic["warm_requests"]):
            self.phases[f"warm_{k}_s"] = self._timed(WARM_STREAM + k)[1]

    def window(self, seconds: float) -> Dict[str, float]:
        nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)
        i = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            out, dt = self._timed(i)
            self.latency.append(dt)
            nonfinite += self._nonfinite(out)
            if i in self.keep:
                self.kept[i] = out
            i += 1
        self.attempted = i
        self.failed = int(nonfinite)
        self.next = i
        self.readings.items, self.readings.work_s = i, sum(self.latency)
        return self.metrics()

    def traced(self, tracer, counters) -> None:
        k = self.traffic["trace_requests"]
        before = counters()
        with tracer.window():
            for j in range(k):
                self._timed(self.next + j, tracer)
        after = counters()
        self.readings.tracer, self.readings.traced_items = tracer, k
        self.readings.counters = {c: after[c] - before.get(c, 0) for c in after}

    def release(self) -> None:
        del self.model
        free(self.device)

    def reference(self):
        """The reference model on the device, with the run's weights, in
        float32 with TF32 off."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.device(self.device):
            ref = self.mod.reference_model(self.cfg)
        return weights.load(ref, self._weights()).eval()
