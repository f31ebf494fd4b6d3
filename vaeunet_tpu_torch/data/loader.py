"""Batch assembly + device feed.  A copy of ``vaeunet_tpu/data/loader.py``.

Replaces the reference's DataLoader(num_workers=6, pin_memory, ...)
(train.py:239-259): batches are collated in numpy on the host (the patch
cache is already decoded — see dataset.py), optionally prefetched by a
background thread, and handed to the train step as NHWC arrays.  Heavy
augmentation runs on the device (vaeunet_tpu_torch.data.augment), so the
host loop is just slicing and stacking.

Fixed shapes: the train iterator drops the final partial batch (shuffled
each epoch, so no sample is systematically skipped); eval pads the final
batch by repeating samples and reports the true count for correct
averaging.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _collate(samples) -> Dict[str, np.ndarray]:
    images = np.stack([s["image"] for s in samples]).astype(np.float32)
    masks = np.stack([s["mask"] for s in samples]).astype(np.float32)
    return {"image": images, "mask": masks,
            "img_id": [s["img_id"] for s in samples]}


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: Optional[bool] = None,
                 prefetch: int = 2, index_only: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        # index_only: device-resident data mode — batches carry only the
        # sample indices; pixels never cross the host boundary.
        self.index_only = index_only

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        b = self.batch_size
        n_full = len(idx) // b
        for i in range(n_full):
            yield idx[i * b:(i + 1) * b], b
        rem = len(idx) - n_full * b
        if rem and not self.drop_last:
            tail = idx[n_full * b:]
            pad = np.resize(tail, b)  # repeat to fixed shape
            yield pad, rem

    def _make_batch(self, batch_idx, true_count) -> Dict:
        if self.index_only:
            return {"idx": batch_idx.astype(np.int32), "count": true_count}
        # native C++ thread-parallel gather when the dataset supports it
        # (patch mode + uint8 cache); python fallback otherwise
        batch = None
        gather = getattr(self.dataset, "gather_batch", None)
        if gather is not None:
            batch = gather(batch_idx)
        if batch is None:
            batch = _collate([self.dataset[int(i)] for i in batch_idx])
        batch["count"] = true_count
        return batch

    def __iter__(self) -> Iterator[Dict]:
        def produce(out_q):
            try:
                for batch_idx, true_count in self._index_batches():
                    out_q.put(self._make_batch(batch_idx, true_count))
            finally:
                out_q.put(None)

        if self.prefetch <= 0:
            for batch_idx, true_count in self._index_batches():
                yield self._make_batch(batch_idx, true_count)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
