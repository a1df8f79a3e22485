"""Dataset filesystem API, the part the fitting uses (counterpart of
``nphm_tpu/data/manager.py``'s ``DataManager``).

Subject and expression enumeration with the test split's curation,
mesh and single-view point-cloud loading, the throat-plane cut through
three FLAME template vertices, and the nphm <-> flame <-> raw coordinate
transforms.  Pure host logic over numpy and the port's PLY reader.
"""

from __future__ import annotations

import os
from typing import Dict, List, Literal, Optional, Union

import numpy as np

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.utils.mesh_io import Mesh, load_mesh

# FLAME template vertices spanning the throat-cut plane (reference manager.py:267-270)
THROAT_PLANE_VERTS = (3276, 3207, 3310)

CoordSystem = Literal["raw", "flame", "nphm"]


class DataManager:
    def __init__(self, dummy_path: Optional[str] = None):
        self.data_dir = env_paths.DATA
        self.single_view_dir = env_paths.DATA_SINGLE_VIEW
        if dummy_path is not None:
            self.data_dir = os.path.join(dummy_path, "dataset")
            self.single_view_dir = os.path.join(dummy_path, "single_view")

    # enumeration

    def get_expressions(self, subject: int, testing: bool = False,
                        exclude_bad_scans: bool = True) -> List[int]:
        expressions = sorted(int(f) for f in os.listdir(self.get_subject_dir(subject)))
        if testing:
            invalid = env_paths.invalid_expressions_test.get(subject, [])
            expressions = [e for e in expressions if e not in invalid]
        if exclude_bad_scans:
            bad = env_paths.bad_scans.get(subject, [])
            expressions = [e for e in expressions if e not in bad]
        return expressions

    # paths

    def get_subject_dir(self, subject: int) -> str:
        return os.path.join(self.data_dir, f"{subject:03d}")

    def get_scan_dir(self, subject: int, expression: int) -> str:
        return os.path.join(self.data_dir, f"{subject:03d}", f"{expression:03d}")

    def get_flame_path(self, subject: int, expression: int) -> str:
        return os.path.join(self.get_scan_dir(subject, expression), "flame.ply")

    def get_single_view_dir(self, subject: int, expression: int) -> str:
        return os.path.join(self.single_view_dir, f"{subject:03d}", f"{expression}")

    def get_single_view_path(self, subject: int, expression: int,
                             full_depth_map: bool = False, is_back: bool = False) -> str:
        name = ("full_obs" if full_depth_map else "obs") + ("_back" if is_back else "")
        return os.path.join(self.get_single_view_dir(subject, expression), f"{name}.npy")

    # meshes

    def _load(self, path: str, coordinate_system: CoordSystem, subject, expression):
        mesh = load_mesh(path)
        if coordinate_system == "flame":
            mesh = self.transform_nphm_2_flame(mesh)
        elif coordinate_system == "raw":
            mesh = self.transform_nphm_2_raw(mesh, subject, expression)
        return mesh

    def get_flame_mesh(self, subject: int, expression: int,
                       coordinate_system: CoordSystem = "nphm", **_) -> Mesh:
        return self._load(self.get_flame_path(subject, expression), coordinate_system,
                          subject, expression)

    # observations

    def get_single_view_obs(self, subject: int, expression: int, include_back: bool = True,
                            coordinate_system: CoordSystem = "nphm",
                            disable_cut_throat: bool = False,
                            full_obs: bool = False) -> np.ndarray:
        points = np.load(self.get_single_view_path(subject, expression,
                                                   full_depth_map=full_obs))
        if include_back:
            back_path = self.get_single_view_path(subject, expression,
                                                  full_depth_map=full_obs, is_back=True)
            if os.path.exists(back_path):
                points = np.concatenate([points, np.load(back_path)], axis=0)
            else:
                print("WARNING: observation from back not available!")
        if not disable_cut_throat:
            points = points[self.cut_throat(points, subject, expression), :]
        if coordinate_system == "flame":
            points = self.transform_nphm_2_flame(points)
        elif coordinate_system == "raw":
            points = self.transform_nphm_2_raw(points, subject, expression)
        return points

    def cut_throat(self, points: np.ndarray, subject: int, expression: int,
                   coordinate_system: CoordSystem = "nphm",
                   margin: float = 0.0) -> np.ndarray:
        """Boolean mask of the points above the FLAME throat plane
        (reference manager.py:259-281)."""
        template = self.get_flame_mesh(subject, expression,
                                       coordinate_system=coordinate_system)
        v1, v2, v3 = (template.vertices[i, :] for i in THROAT_PLANE_VERTS)
        normal = np.cross(v2 - v1, v3 - v1)
        return np.sum(normal * (points - v1), axis=-1) > margin

    # coordinate transforms

    def get_transform_from_metric(self, subject: int, expression: int) -> Dict[str, np.ndarray]:
        d = self.get_scan_dir(subject, expression)
        return {k: np.load(os.path.join(d, f"{k}.npy")) for k in ("s", "R", "t")}

    def transform_nphm_2_flame(self, obj: Union[Mesh, np.ndarray]):
        if isinstance(obj, np.ndarray):
            return obj / 4
        obj.vertices = obj.vertices / 4
        return obj

    def transform_nphm_2_raw(self, obj: Union[Mesh, np.ndarray], subject: int,
                             expression: int):
        tr = self.get_transform_from_metric(subject, expression)

        def f(x):
            return 1 / tr["s"] * (x - tr["t"]) @ tr["R"]

        if isinstance(obj, np.ndarray):
            return f(obj)
        obj.vertices = f(obj.vertices)
        return obj
