"""Uncertainty requests: ``segmentation_distribution`` + ``uncertainty_maps``
on one full-resolution image, N latent samples decoded on every tile.

Traffic parameters: ``image_hw``; ``patch``, ``overlap`` (null: the
adaptive one), ``tile_batch``; ``samples`` (N) and ``temperature``; the
noise goes in through the call's ``eps``.  ``warm_requests`` in set-up,
``trace_requests`` in a traced run; ``check_requests`` answers, drawn from
the first ``check_among``, are compared with the reference's, which tiles
``ref_tile_batch`` at a time.  The configuration's module gives
``reference_model(cfg)`` and ``program_serving(cfg, device)``.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness import compare, flops
from benchmark.harness.serving import ServingDriver
from benchmark.reference import tiled


class Driver(ServingDriver):
    kind = "uq"

    def _inputs(self, i: int):
        h, w = self.traffic["image_hw"]
        g = self._generator(i)
        image = torch.rand((h, w, 3), generator=g, device=self.device)
        eps = torch.randn((self.traffic["samples"], 1, self.cfg["latent_dim"]), generator=g,
                          device=self.device)
        return image, eps

    def _call(self, inputs, tracer):
        from vaeunet_tpu_torch import segmentation_distribution, uncertainty_maps

        image, eps = inputs
        t = self.traffic
        with self._span(tracer, "distribution"):
            samples, _, _ = segmentation_distribution(
                self.model, image, num_samples=t["samples"], temperature=t["temperature"],
                patch_size=t["patch"], tile_batch=t["tile_batch"], overlap=t["overlap"],
                eps=eps, device=self.device)
        with self._span(tracer, "maps"):
            maps = uncertainty_maps(samples)
        return samples, maps

    def _nonfinite(self, out) -> torch.Tensor:
        samples, maps = out
        return (~torch.isfinite(samples)).any() | (~torch.isfinite(maps["mean"])).any()

    def metrics(self) -> Dict[str, float]:
        return {"uq_request_s": sum(self.latency) / len(self.latency)}

    def reference_answer(self, ref, i: int):
        image, eps = self._inputs(i)
        t = self.traffic
        return tiled.uq_request(ref, image, eps[:, 0], t["patch"], t["overlap"],
                                t["ref_tile_batch"], t["temperature"])

    def check(self) -> Dict[str, float]:
        ref = self.reference()
        samples_gap = maps_gap = float("inf") if not self.kept else 0.0
        for i, (samples, maps) in sorted(self.kept.items()):
            ref_samples, ref_maps = self.reference_answer(ref, i)
            samples_gap = max(samples_gap, compare.widest_gap(samples, ref_samples))
            maps_gap = max(maps_gap, max(compare.widest_gap(maps[k], ref_maps[k])
                                         for k in ref_maps))
        return {"samples_gap": samples_gap, "maps_gap": maps_gap}

    def count(self) -> None:
        t = self.traffic
        h, w = t["image_hw"]
        with torch.device("meta"):
            ref = self.mod.reference_model(self.cfg)
            image = torch.empty((h, w, 3))
            eps = torch.empty((t["samples"], self.cfg["latent_dim"]))
        self.readings.flops_per_item = flops.count(
            lambda: tiled.uq_request(ref, image, eps, t["patch"], t["overlap"],
                                     t["ref_tile_batch"], t["temperature"]))
