"""Machine paths (the part of ``nphm_tpu/env_paths.py`` the port uses).

Paths come from the same environment variables (NPHM_*) with the same
defaults as the JAX package, so both read one data layout.
"""

from __future__ import annotations

import os

_DEF_ROOT = os.environ.get("NPHM_ROOT", os.path.expanduser("~/nphm_data"))

ASSETS = os.environ.get("NPHM_ASSETS", os.path.join(_DEF_ROOT, "assets"))
EXPERIMENT_DIR = os.environ.get(
    "NPHM_EXPERIMENT_DIR", os.path.join(_DEF_ROOT, "experiments")
)
ANCHOR_MEAN_PATH = os.path.join(ASSETS, "anchors_39.npy")
