"""Tiled prediction requests: ``predict_with_patches`` on one image with
the latent z = 0, one decode of every tile.

Traffic parameters: ``image_hw``; ``patch``, ``overlap`` (null: the
adaptive one), ``tile_batch``; ``warm_requests``, ``trace_requests``,
``check_requests`` among the first ``check_among``, ``ref_tile_batch``, as
for the ``uq`` kind.  The configuration's module gives
``reference_model(cfg)`` and ``program_serving(cfg, device)``.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness import compare, flops
from benchmark.harness.serving import ServingDriver
from benchmark.harness.stats import percentile
from benchmark.reference import tiled


class Driver(ServingDriver):
    kind = "predict"

    def _inputs(self, i: int):
        h, w = self.traffic["image_hw"]
        return torch.rand((h, w, 3), generator=self._generator(i), device=self.device)

    def _call(self, image, tracer):
        from vaeunet_tpu_torch.inference.tiled import predict_with_patches

        t = self.traffic
        z = torch.zeros((1, self.cfg["latent_dim"]), device=self.device)
        with self._span(tracer, "predict"):
            return predict_with_patches(self.model, image, z, t["patch"], overlap=t["overlap"],
                                        batch_size=t["tile_batch"], device=self.device)

    def _nonfinite(self, out) -> torch.Tensor:
        return (~torch.isfinite(out)).any()

    def metrics(self) -> Dict[str, float]:
        ms = [s * 1e3 for s in self.latency]
        return {"predict_p50_ms": percentile(ms, 50), "predict_p95_ms": percentile(ms, 95)}

    def reference_answer(self, ref, i: int):
        t = self.traffic
        z = torch.zeros((self.cfg["latent_dim"],), device=self.device)
        return tiled.predict(ref, self._inputs(i), z, t["patch"], t["overlap"],
                             t["ref_tile_batch"])

    def check(self) -> Dict[str, float]:
        ref = self.reference()
        gap = float("inf") if not self.kept else 0.0
        for i, probs in sorted(self.kept.items()):
            gap = max(gap, compare.widest_gap(probs, self.reference_answer(ref, i)))
        return {"probs_gap": gap}

    def count(self) -> None:
        t = self.traffic
        h, w = t["image_hw"]
        with torch.device("meta"):
            ref = self.mod.reference_model(self.cfg)
            image = torch.empty((h, w, 3))
            z = torch.empty((self.cfg["latent_dim"],))
        self.readings.flops_per_item = flops.count(
            lambda: tiled.predict(ref, image, z, t["patch"], t["overlap"], t["ref_tile_batch"]))
