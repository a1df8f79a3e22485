"""Metrics logging to stdout and a JSONL file (counterpart of
``nphm_tpu/utils/logging_utils.py``, without its optional wandb hook)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, quiet: bool = False):
        self.quiet = quiet
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {k: float(v) for k, v in metrics.items()}
        if step is not None:
            rec["step"] = step
        rec["t"] = time.time()
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def print(self, msg: str):
        if not self.quiet:
            print(msg, flush=True)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
