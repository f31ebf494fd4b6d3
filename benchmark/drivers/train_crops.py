"""Training traffic on crops of whole images: the step that
``training/loop.py`` runs on an ``ImageDeviceCache``, with the on-device
augmentation (``make_train_step(indexed=True, augment=True)``), driven back
to back as ``drivers/train.py`` drives the patch pool, whose ``Driver`` this
one extends.

Traffic parameters (``benchmark/traffic/<name>.json``): ``images`` seeded
uint8 images of ``image_hw`` (the training scale's size) with seeded masks,
held in an ``ImageDeviceCache``; the records are the dataset's
50 %-overlap grid of ``hw`` crops (stride ``hw // 2``, as
``data/dataset.py`` lays it out, every crop kept), and each step gathers
``batch`` of them by record, crops them on the device and runs the
augmentation policy on them; ``lesion_threshold``, ``check_steps``,
``trace_steps`` and ``enqueue_steps`` as for ``train``.

The checked steps hand the reference the batch that the program's policy
produced: before each, the state's generator is saved; after it, the
program's gather and ``augment_batch`` are run again from that state on
the same records, which draws what the step drew.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.drivers.train import INDEX_TABLE, NOISE_TABLE
from benchmark.drivers.train import Driver as TrainDriver
from benchmark.harness import seeds, weights
from benchmark.harness.device import free, sync
from benchmark.reference.train import follow


class SeededImages:
    """The seeded images and masks, with what ``ImageDeviceCache`` reads of
    a dataset: the patch index of the full 50 %-overlap grid, the sizes, the
    uint8 planes of an image."""

    is_full_image = False

    def __init__(self, images: np.ndarray, masks: np.ndarray, patch: int):
        self.images, self.masks, self.patch_size = images, masks, patch
        n, h, w = images.shape[:3]
        self.meta = {i: {"h": h, "w": w} for i in range(n)}
        stride = patch // 2
        self.patch_index = [(i, y, x, False) for i in range(n)
                            for y in range(0, h - patch + 1, stride)
                            for x in range(0, w - patch + 1, stride)]

    def _image_arrays_u8(self, i: int):
        return self.images[i], self.masks[i]


def train_config(cfg: Dict, traffic: Dict):
    """The loop's ``TrainConfig`` of a VAE-UNet configuration at the
    traffic's batch."""
    from vaeunet_tpu_torch.training import TrainConfig

    t = cfg["train"]
    return TrainConfig(
        model_type="resnet", n_channels=cfg["n_channels"], n_classes=cfg["n_classes"],
        backbone=cfg["backbone"], latent_dim=cfg["latent_dim"],
        latent_injection=cfg["latent_injection"], use_attention=cfg["use_attention"],
        use_skip=cfg["use_skip"], deep_supervision=cfg.get("deep_supervision", False),
        batch_size=traffic["batch"], gradient_accumulation_steps=1, patch_size=traffic["hw"],
        amp=t["amp"], learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
        gradient_clipping=t["gradient_clipping"], beta=t["beta"], free_bits=t["free_bits"])


class Driver(TrainDriver):

    def _data(self) -> None:
        from vaeunet_tpu_torch.data.device_cache import ImageDeviceCache

        t, dev = self.traffic, self.device
        g = torch.Generator(device=dev).manual_seed(seeds.derive(self.seed, seeds.DATA))
        n, (h, w) = t["images"], t["image_hw"]
        images = torch.randint(0, 256, (n, h, w, 3), generator=g, device=dev, dtype=torch.uint8)
        blobs = torch.rand((n, 1, h // 32, w // 32), generator=g, device=dev)
        blobs = F.interpolate(blobs, size=(h, w), mode="bilinear", align_corners=False)
        masks = (blobs[:, 0] > t["lesion_threshold"]).to(torch.uint8)
        del blobs
        seeded = SeededImages(images.cpu().numpy(), masks.cpu().numpy(), self.hw)
        del images, masks
        self.cache = ImageDeviceCache(seeded, device=dev)
        self.images, self.masks = self.cache.images, self.cache.masks
        records = self.cache.records
        rng = np.random.default_rng(seeds.derive(self.seed, seeds.INDEX))
        r = len(records)
        check = rng.permutation(r)[:self.checks * self.batch].reshape(self.checks, self.batch)
        rest = rng.integers(0, r, size=(INDEX_TABLE - self.checks, self.batch))
        # the index table holds each step's records, [B, 3] (image, y, x)
        self.index = records[np.concatenate([check, rest])]
        self.noise = None
        if self.latent is not None:
            gn = torch.Generator(device=dev).manual_seed(seeds.derive(self.seed, seeds.NOISE))
            self.noise = torch.randn((NOISE_TABLE, 1, self.batch, self.latent), generator=gn,
                                     device=dev)

    def _augmented(self, generator_state: torch.Tensor, records: np.ndarray):
        """The batch the program's step made of `records` from the generator
        at `generator_state`: its gather, then ``augment_batch``."""
        from vaeunet_tpu_torch.data.augment import augment_batch

        g = torch.Generator().set_state(generator_state)
        rec = torch.as_tensor(records, device=self.device)
        with torch.no_grad():
            images, masks = self.cache.make_gather()(self.images, self.masks, rec)
            return augment_batch(g, images, masks)

    def setup(self) -> None:
        from vaeunet_tpu_torch.training import make_train_step

        mark = time.perf_counter()
        self._data()
        sync(self.device)
        self.phases = {"data_s": time.perf_counter() - mark}
        mark = time.perf_counter()
        self.state, _ = self.mod.program_train(self.cfg, self.traffic, self.device)
        model = self.state.model
        self.step = make_train_step(train_config(self.cfg, self.traffic), model, augment=True,
                                    indexed=True, gather=self.cache.make_gather())
        weights.load(model, self._weights())
        sync(self.device)
        self.phases["build_s"] = time.perf_counter() - mark
        mark = time.perf_counter()
        named = list(model.named_parameters())
        adam = self.state.optimizer.adamw
        losses, grad = [], None
        self.batches: List = []
        for k in range(self.checks):
            before = self.state.generator.get_state()
            self.state, aux = self.step(self.state, self.images, self.masks, self.index[k],
                                        self.hp["beta"], eps=self._eps(k))
            losses.append(aux["loss"].detach())
            if k == 0:       # the clipped gradient, from AdamW's first moment: (1 - b1) g
                b1 = adam.param_groups[0]["betas"][0]
                grad = torch.stack([adam.state[p]["exp_avg"].norm() / (1 - b1)
                                    if "exp_avg" in adam.state[p] else p.new_zeros(())
                                    for _, p in named])
            self.batches.append(self._augmented(before, self.index[k]))
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

    def release(self) -> None:
        del self.cache, self.images, self.masks
        super().release()

    def follow_reference(self, quant=None, half_batch: bool = False,
                         dtype=torch.float32) -> Dict:
        """The reference (or a control) through the checked steps on the
        program's augmented batches and noise, in float32 with TF32 off (or
        wholly in `dtype`)."""
        from benchmark.reference.layers import set_quant

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.device(self.device):
            ref = self.mod.reference_model(self.cfg)
        weights.load(ref, self._weights())
        set_quant(ref.to(dtype), quant)
        batches = []
        for k, (images, masks) in enumerate(self.batches):
            eps = self._eps(k)
            batches.append((images.to(dtype), masks.float(),
                            None if eps is None else eps[0].to(dtype)))
        hp = self.hp
        out = follow(ref, batches, hp["beta"], hp["free_bits"], hp["learning_rate"],
                     hp["weight_decay"], hp["gradient_clipping"], half_batch=half_batch)
        del ref, batches
        free(self.device)
        return out
