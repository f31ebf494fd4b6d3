"""Training traffic: the step that ``training/loop.py`` runs, driven back to
back with no synchronize between steps, as the loop drives it.

Traffic parameters (``benchmark/traffic/<name>.json``): ``hw`` and
``batch`` of a step; ``pool``, the number of seeded uint8 patches held on
the device, from which each step gathers its batch by index (the device
cache's layout); ``lesion_threshold``, where the smooth noise of the masks
is cut into lesions; ``check_steps``, the steps set-up drives through the
window's own call on rows that all differ and that the reference follows;
``trace_steps`` and ``enqueue_steps`` of a traced run.

The configuration's module gives ``reference_model(cfg)``,
``program_train(cfg, traffic, device) -> (state, step)`` and
``HAS_LATENT``; the latent noise goes in through the step's ``eps``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import compare, flops, seeds, weights
from benchmark.harness.device import free, sync
from benchmark.harness.readings import Readings
from benchmark.reference.train import follow, loss_of

NOISE_TABLE = 64        # latent noise draws kept on the device; steps reuse them in turn
INDEX_TABLE = 8192      # batches of indices drawn on the host; a window longer wraps


class Driver:
    def __init__(self, cfg: Dict, cfgmod, traffic: Dict, seed: int, device):
        self.cfg, self.mod, self.traffic = cfg, cfgmod, traffic
        self.seed, self.device = seed, torch.device(device)
        self.hp = cfg["train"]
        self.batch, self.hw = traffic["batch"], traffic["hw"]
        self.checks = traffic["check_steps"]
        self.latent = cfg["latent_dim"] if cfgmod.HAS_LATENT else None
        self.readings = Readings(kind="train", precision=self.hp["precision"])
        self.attempted = self.failed = 0

    # ----- inputs, from the seed ------------------------------------------

    def _data(self) -> None:
        t, dev = self.traffic, self.device
        g = torch.Generator(device=dev).manual_seed(seeds.derive(self.seed, seeds.DATA))
        n, hw = t["pool"], self.hw
        self.images = torch.randint(0, 256, (n, hw, hw, 3), generator=g, device=dev,
                                    dtype=torch.uint8)
        blobs = torch.rand((n, 1, hw // 32, hw // 32), generator=g, device=dev)
        blobs = F.interpolate(blobs, size=(hw, hw), mode="bilinear", align_corners=False)
        self.masks = (blobs > t["lesion_threshold"]).to(torch.uint8).permute(0, 2, 3, 1)
        self.masks = self.masks.contiguous()
        del blobs
        rng = np.random.default_rng(seeds.derive(self.seed, seeds.INDEX))
        check = rng.permutation(n)[:self.checks * self.batch].reshape(self.checks, self.batch)
        rest = rng.integers(0, n, size=(INDEX_TABLE - self.checks, self.batch))
        self.index = np.concatenate([check, rest]).astype(np.int64)
        self.noise = None
        if self.latent is not None:
            gn = torch.Generator(device=dev).manual_seed(seeds.derive(self.seed, seeds.NOISE))
            self.noise = torch.randn((NOISE_TABLE, 1, self.batch, self.latent), generator=gn,
                                     device=dev)

    def _eps(self, k: int):
        return None if self.noise is None else self.noise[k % NOISE_TABLE]

    def _step(self, k: int) -> None:
        self.state, _ = self.step(self.state, self.images, self.masks,
                                  self.index[k % INDEX_TABLE], self.hp["beta"], eps=self._eps(k))

    def _weights(self):
        with torch.device("meta"):
            ref = self.mod.reference_model(self.cfg)
        return weights.make(ref, seeds.derive(self.seed, seeds.WEIGHTS), self.device,
                            serving=False)

    # ----- phases -----------------------------------------------------------

    def setup(self) -> None:
        mark = time.perf_counter()
        self._data()
        sync(self.device)
        self.phases = {"data_s": time.perf_counter() - mark}
        mark = time.perf_counter()
        self.state, self.step = self.mod.program_train(self.cfg, self.traffic, self.device)
        model = self.state.model
        weights.load(model, self._weights())
        sync(self.device)
        self.phases["build_s"] = time.perf_counter() - mark
        mark = time.perf_counter()
        named = list(model.named_parameters())
        adam = self.state.optimizer.adamw
        losses, grad = [], None
        for k in range(self.checks):
            self.state, aux = self.step(self.state, self.images, self.masks, self.index[k],
                                        self.hp["beta"], eps=self._eps(k))
            losses.append(aux["loss"].detach())
            if k == 0:       # the clipped gradient, from AdamW's first moment: (1 - b1) g
                b1 = adam.param_groups[0]["betas"][0]
                grad = torch.stack([adam.state[p]["exp_avg"].norm() / (1 - b1)
                                    if "exp_avg" in adam.state[p] else p.new_zeros(())
                                    for _, p in named])
        start = self._weights()
        with torch.no_grad():
            change = torch.stack([(p - start[n]).norm() for n, p in named])
        del start
        sync(self.device)
        self.phases["checked_steps_s"] = time.perf_counter() - mark
        names = [n for n, _ in named]
        self.program = {"loss": torch.stack(losses).tolist(),
                        "grad": dict(zip(names, grad.tolist())),
                        "change": dict(zip(names, change.tolist()))}

    def window(self, seconds: float) -> Dict[str, float]:
        n = 0
        t0 = time.perf_counter()
        issued = []
        while time.perf_counter() - t0 < seconds:
            self._step(self.checks + n)
            n += 1
            issued.append(time.perf_counter() - t0)
        sync(self.device)
        dt = time.perf_counter() - t0
        self.slices = {f"steps_issued_by_{s}s": sum(t <= s for t in issued)
                       for s in range(5, int(seconds) + 1, 5)}
        self.next = self.checks + n
        self.attempted = n
        self.readings.items, self.readings.work_s = n, dt
        return {"train_img_per_s": n * self.batch / dt}

    def traced(self, tracer, counters) -> None:
        """The enqueue steps (before the profiler first attaches), then the
        traced steps."""
        for _ in range(self.traffic["enqueue_steps"]):
            sync(self.device)
            t0 = time.perf_counter()
            self._step(self.next)
            self.readings.enqueue_s.append(time.perf_counter() - t0)
            self.next += 1
        k = self.traffic["trace_steps"]
        before = counters()
        with tracer.window():
            for i in range(k):
                with tracer.span("step"):
                    self._step(self.next + i)
        self.next += k
        after = counters()
        self.readings.tracer, self.readings.traced_items = tracer, k
        self.readings.counters = {c: after[c] - before.get(c, 0) for c in after}

    def release(self) -> None:
        del self.state, self.step
        free(self.device)

    def count(self) -> None:
        """FLOPs of a step and the 3x3 sites, on the reference at the
        cell's shapes (meta device: nothing is computed)."""
        with torch.device("meta"):
            ref = self.mod.reference_model(self.cfg)
            x = torch.empty((self.batch, self.hw, self.hw, 3))
            m = torch.empty((self.batch, self.hw, self.hw, 1))
            eps = None if self.latent is None else torch.empty((self.batch, self.latent))
        ref.train()
        args = (ref, x, m, eps, self.hp["beta"], self.hp["free_bits"])
        self.readings.flops_per_item = flops.count(lambda: loss_of(*args).backward())
        self.readings.conv3x3_sites = flops.conv3x3_sites(ref, lambda: loss_of(*args))

    def check(self) -> Dict[str, float]:
        return compare.train_numbers(self.program, self.follow_reference())

    def follow_reference(self, quant=None, half_batch: bool = False,
                         dtype=torch.float32) -> Dict:
        """The reference (or, with `quant`, a control) through the checked
        steps, on the same rows and noise, in float32 with TF32 off (or,
        as a witness of a precision, wholly in `dtype`)."""
        from benchmark.reference.layers import set_quant

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.device(self.device):
            ref = self.mod.reference_model(self.cfg)
        weights.load(ref, self._weights())
        set_quant(ref.to(dtype), quant)
        div = torch.tensor(255.0, device=self.device)
        batches = []
        for k in range(self.checks):
            idx = torch.as_tensor(self.index[k], device=self.device)
            eps = self._eps(k)
            batches.append(((self.images[idx].float() / div).to(dtype), self.masks[idx].float(),
                            None if eps is None else eps[0].to(dtype)))
        hp = self.hp
        out = follow(ref, batches, hp["beta"], hp["free_bits"], hp["learning_rate"],
                     hp["weight_decay"], hp["gradient_clipping"], half_batch=half_batch)
        del ref, batches
        free(self.device)
        return out
