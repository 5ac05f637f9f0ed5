"""Batches of numpy samples, built by host threads (port of `sar_yolo_tpu/data/build.py`).

Training: the sample order of an epoch is `np.random.default_rng(seed + epoch)`'s
shuffle and the last partial batch is dropped. Evaluation (`shuffle=False,
drop_last=False, pad_last=True`): samples in order, the tail batch padded with
copies of its last sample and every batch carrying `_pad`, the count of those
copies, for the metrics to skip. Images stay uint8: they are normalized on the
device by the consumer. With `rank` and `world` (data parallelism, `parallel/`) each rank
builds only its contiguous `batch_size / world` rows of every global batch: the batch order
and each sample's draws (keyed by seed, epoch and index) stay the single process's.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def collate(items: list[dict]) -> dict:
    """Stack per-sample dicts into batch arrays."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


PREFETCH = 2  # batches in flight beyond the one being consumed


class DataLoader:
    """Epoch iterator over a dataset in batches; `workers` threads build samples (this
    rank's rows of each batch)."""

    def __init__(self, dataset, batch_size=16, workers=4, seed=0, shuffle=True, drop_last=True,
                 pad_last=False, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"batch {batch_size} does not split over {world} ranks")
        self.dataset, self.batch_size = dataset, batch_size
        self.workers, self.seed = max(1, workers), seed
        self.shuffle, self.drop_last, self.pad_last = shuffle, drop_last, pad_last
        self.rank, self.world = rank, world
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """The epoch of the shuffle, and of the dataset's per-sample augmentation draws."""
        self.epoch = epoch
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch

    def batch_indices(self) -> list[np.ndarray]:
        """The sample indices of each batch of the current epoch, before padding."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

    def __iter__(self):
        todo = deque(self.batch_indices())
        pool = ThreadPoolExecutor(self.workers, thread_name_prefix="dataloader")
        pending = deque()
        try:
            while todo or pending:
                while todo and len(pending) <= PREFETCH:
                    b = todo.popleft()
                    npad = self.batch_size - len(b) if self.pad_last else 0
                    b = np.concatenate([b, np.repeat(b[-1:], npad)])
                    per = len(b) // self.world
                    b = b[self.rank * per:(self.rank + 1) * per]
                    pending.append(([pool.submit(self.dataset.__getitem__, int(j)) for j in b],
                                    npad))
                futures, npad = pending.popleft()
                batch = collate([f.result() for f in futures])
                if self.pad_last:
                    batch["_pad"] = npad  # trailing copies, skipped by the metrics
                yield batch
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
