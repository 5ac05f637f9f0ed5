"""Batches of numpy samples, built by host threads (port of `sar_yolo_tpu/data/build.py`).

The sample order of an epoch is `np.random.default_rng(seed + epoch)`'s
shuffle, the last partial batch is dropped, and images stay uint8: they are
normalized on the device by the consumer.
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
    """Epoch iterator over a dataset in shuffled, full batches; `workers` threads build samples."""

    def __init__(self, dataset, batch_size=16, workers=4, seed=0):
        self.dataset, self.batch_size = dataset, batch_size
        self.workers, self.seed = max(1, workers), seed
        self.epoch = 0

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def batch_indices(self) -> list[np.ndarray]:
        """The sample indices of each batch of the current epoch."""
        idx = np.arange(len(self.dataset))
        np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

    def __iter__(self):
        todo = deque(self.batch_indices())
        pool = ThreadPoolExecutor(self.workers, thread_name_prefix="dataloader")
        pending = deque()
        try:
            while todo or pending:
                while todo and len(pending) <= PREFETCH:
                    pending.append([pool.submit(self.dataset.__getitem__, int(j))
                                    for j in todo.popleft()])
                yield collate([f.result() for f in pending.popleft()])
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
