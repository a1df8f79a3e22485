"""Machine paths, dataset splits and curation metadata (counterpart of
``nphm_tpu/env_paths.py``).

Paths come from the same environment variables (NPHM_*) with the same
defaults as the JAX package, so both read one data layout; they are read
once, at import.  The split lists and per-scan curation tables are facts
about the published NPHM dataset: which subjects form the eval and test
splits, which scans are corrupted, which expression of a subject is its
neutral one.
"""

from __future__ import annotations

import json
import os

_DEF_ROOT = os.environ.get("NPHM_ROOT", os.path.expanduser("~/nphm_data"))

ASSETS = os.environ.get("NPHM_ASSETS", os.path.join(_DEF_ROOT, "assets"))
DATA = os.environ.get("NPHM_DATA", os.path.join(_DEF_ROOT, "dataset"))
DATA_SINGLE_VIEW = os.environ.get(
    "NPHM_DATA_SINGLE_VIEW", os.path.join(_DEF_ROOT, "single_view")
)
SUPERVISION_IDENTITY = os.environ.get(
    "NPHM_SUPERVISION_IDENTITY", os.path.join(_DEF_ROOT, "supervision_identity")
)
SUPERVISION_DEFORMATION_OPEN = os.environ.get(
    "NPHM_SUPERVISION_DEFORMATION", os.path.join(_DEF_ROOT, "supervision_deformation")
)
EXPERIMENT_DIR = os.environ.get(
    "NPHM_EXPERIMENT_DIR", os.path.join(_DEF_ROOT, "experiments")
)
FITTING_DIR = os.environ.get("NPHM_FITTING_DIR", os.path.join(_DEF_ROOT, "fitting"))
DUMMY_DATA = os.environ.get("NPHM_DUMMY_DATA", os.path.join(_DEF_ROOT, "dummy_data"))

ANCHOR_MEAN_PATH = os.path.join(ASSETS, "anchors_39.npy")

# supervision chunks per scan: identity surface samples, deformation
# correspondences
NUM_SPLITS = int(os.environ.get("NPHM_NUM_SPLITS", "200"))
NUM_SPLITS_EXPR = int(os.environ.get("NPHM_NUM_SPLITS_EXPR", "100"))

subjects_eval = [199, 286, 290, 291, 292, 293, 294, 295, 297, 298]

subjects_test = [
    99, 283, 143, 38, 241, 236, 276, 202, 98, 254, 204, 163,
    267, 194, 20, 23, 209, 105, 186, 343, 341, 363, 350,
]

# expressions excluded from test-time evaluation (failed FLAME fits, hair
# changes, broken scans, per the dataset release notes)
invalid_expressions_test = {
    143: [0, 1, 5],
    163: [6],
    38: [1, 5, 8, 9, 10, 11, 15, 16, 17, 18, 19],
    236: [8],
    202: [24],
    98: [0],
    254: [1],
    204: [16],
    267: [0, 7, 13, 22],
    194: [0, 1, 2, 3, 9, 11, 14, 18, 22],
    20: [17, 6, 11, 13],
    209: [7, 8, 9, 10, 15, 20],
    105: list(range(16)),
    186: [7, 8, 9, 11, 21],
    343: [9, 11],
    363: [1, 11, 12, 14],
    350: [4],
}
for _s in subjects_test:
    invalid_expressions_test.setdefault(_s, [])

# scans too corrupted to train on
bad_scans = {
    261: [19],
    88: [19],
    79: [16, 17, 18, 19, 20],
    100: [0],
    125: [1, 4, 5],
    106: [20],
    362: [20],
    363: [1],
    345: [12],
    360: [6, 14],
    85: [2],
    292: [9],
    298: [23, 24, 25, 26],
}


def _load_neutrals(name: str):
    """Per-subject neutral-expression indices, shipped with the dataset as
    JSON next to it (or under NPHM_ROOT or NPHM_DATASET_META)."""
    candidates = [
        os.path.join(DATA, "..", name),
        os.path.join(_DEF_ROOT, name),
        os.path.join(os.environ.get("NPHM_DATASET_META", ""), name),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            with open(c) as f:
                return {int(k): v for k, v in json.load(f).items()}
    return {}


neutrals = _load_neutrals("neutrals_open.json")
neutrals_closed = _load_neutrals("neutrals_closed.json")
