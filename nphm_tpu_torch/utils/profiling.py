"""Step timing (counterpart of ``StepTimer`` in ``nphm_tpu/utils/profiling.py``).

PyTorch returns before the GPU finishes, so a host clock alone measures the
enqueue: on a CUDA device the timer synchronises before the step starts and
after it ends, and a step's time is the device work it queued plus its host
time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class StepTimer:
    """Rolling step-rate tracker: ``with timer.step(): ...`` then read stats.

    device: where the timed work runs; CUDA devices are synchronised.
    """

    def __init__(self, device, window: int = 100):
        self.device = torch.device(device)
        self.window = window
        self.times = []
        self.count = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def step(self):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self.count += 1
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def steps_per_s(self) -> float:
        m = self.mean_s
        return 1.0 / m if m > 0 else 0.0

    def metrics(self, prefix: str = "") -> Dict[str, float]:
        return {
            f"{prefix}step_time_s": self.mean_s,
            f"{prefix}steps_per_s": self.steps_per_s,
        }
