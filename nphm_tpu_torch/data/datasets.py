"""Batching for the training datasets (the ``_BatchedDataset`` part of
``nphm_tpu/data/datasets.py``).

Items load in a thread pool and batches are prefetched one step ahead; each
item draws from its own generator, seeded from the batch seed, so a batch is
the same whichever thread loads it.  Shapes are static.
"""

from __future__ import annotations

import concurrent.futures as futures
from typing import Dict, Iterator

import numpy as np


class _BatchedDataset:
    """Shared batching/prefetch machinery. Subclasses implement _load_item."""

    batch_size: int = 32
    n_threads: int = 8

    def __len__(self):
        raise NotImplementedError

    def _load_item(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def batch_iter(
        self, seed: int = 0, shuffle: bool = True, drop_remainder: bool = False
    ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        bs = self.batch_size
        batches = [order[i : i + bs] for i in range(0, len(order), bs)]
        if drop_remainder:
            batches = [b for b in batches if len(b) == bs]
        if not batches:
            return

        pool = futures.ThreadPoolExecutor(self.n_threads)

        def assemble(idx_batch, batch_seed):
            seeds = np.random.SeedSequence(batch_seed).spawn(len(idx_batch))
            items = list(
                pool.map(
                    lambda a: self._load_item(a[0], np.random.default_rng(a[1])),
                    zip(idx_batch, seeds),
                )
            )
            return {
                k: np.stack([it[k] for it in items]) for k in items[0]
            }

        try:
            nxt = pool.submit(assemble, batches[0], rng.integers(2**31))
            for i in range(len(batches)):
                cur = nxt.result()
                if i + 1 < len(batches):
                    nxt = pool.submit(assemble, batches[i + 1], rng.integers(2**31))
                yield cur
        finally:
            pool.shutdown(wait=False)
