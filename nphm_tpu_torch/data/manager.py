"""Dataset filesystem API (counterpart of ``nphm_tpu/data/manager.py``'s
``DataManager``).

Subject and expression enumeration with the splits' curation, loading of
the raw scans, FLAME and registration meshes and single-view point clouds,
landmarks and facial anchors from registration vertices, the throat-plane
cut through three FLAME template vertices, the nphm <-> flame <-> raw
coordinate transforms, and the supervision files' path scheme with random
chunk selection.  Pure host logic over numpy and the port's PLY reader.

The vertex index lists are dataset constants: which vertices of the
upsampled FLAME registration topology serve as the 68 + extra landmarks
and as the 39 facial anchors (reference manager.py:19-30).
"""

from __future__ import annotations

import os
from typing import Dict, List, Literal, Optional, Union

import numpy as np

from nphm_tpu_torch import env_paths
from nphm_tpu_torch.utils.mesh_io import Mesh, load_mesh

LM_INDS_UPSAMPLED = np.array([
    2212, 3060, 3485, 3384, 3386, 3389, 3418, 3395, 3414, 3598, 3637,
    3587, 3582, 3580, 3756, 2012, 730, 1984, 3157, 335, 3705, 3684,
    3851, 3863, 16, 2138, 571, 3553, 3561, 3501, 3526, 2748, 2792,
    3556, 1675, 1612, 2437, 2383, 2494, 3632, 2278, 2296, 3833, 1343,
    1034, 1175, 884, 829, 2715, 2813, 2774, 3543, 1657, 1696, 1579,
    1795, 1865, 3503, 2948, 2898, 2845, 2785, 3533, 1668, 1730, 1669,
    3509, 2786,
])

ANCHOR_INDICES = np.array([
    2712, 1579, 3485, 3756, 3430, 3659, 2711, 1575, 338, 27, 3631,
    3832, 2437, 1175, 3092, 2057, 3422, 3649, 3162, 2143, 617, 67,
    3172, 2160, 2966, 1888, 1470, 2607, 1896, 2981, 3332, 3231, 3494,
    3526, 3506, 3543, 3516, 3786, 3404,
])

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
        self.lm_inds_upsampled = LM_INDS_UPSAMPLED
        self.anchor_indices = ANCHOR_INDICES

    # enumeration

    def get_all_subjects(self) -> List[int]:
        return sorted(int(pid) for pid in os.listdir(self.data_dir) if pid.isdigit())

    def get_train_subjects(self, neutral_type: Literal["open", "closed"] = "open",
                           exclude_missing_neutral: bool = True) -> List[int]:
        non_train = set(env_paths.subjects_test + env_paths.subjects_eval)
        subjects = [s for s in self.get_all_subjects() if s not in non_train]
        if exclude_missing_neutral:
            subjects = [s for s in subjects
                        if self.get_neutral_expression(s, neutral_type) is not None]
        return subjects

    def get_eval_subjects(self, neutral_type: Literal["open", "closed"] = "open",
                          exclude_missing_neutral: bool = True) -> List[int]:
        subjects = list(env_paths.subjects_eval)
        if exclude_missing_neutral:
            subjects = [s for s in subjects
                        if self.get_neutral_expression(s, neutral_type) is not None]
        return subjects

    def get_test_subjects(self) -> List[int]:
        return list(env_paths.subjects_test)

    def get_neutral_expression(self, subject: int,
                               neutral_type: Literal["open", "closed"] = "open"
                               ) -> Optional[int]:
        if neutral_type not in ("open", "closed"):
            raise TypeError(f"Unknown neutral type {neutral_type}")
        table = env_paths.neutrals if neutral_type == "open" else env_paths.neutrals_closed
        neutral = table.get(subject)
        return neutral if neutral is not None and neutral >= 0 else None

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

    def get_raw_path(self, subject: int, expression: int) -> str:
        return os.path.join(self.get_scan_dir(subject, expression), "scan.ply")

    def get_registration_path(self, subject: int, expression: int) -> str:
        return os.path.join(self.get_scan_dir(subject, expression), "registration.ply")

    def get_train_dir_identity(self, subject: int) -> str:
        return os.path.join(env_paths.SUPERVISION_IDENTITY, f"{subject:03d}")

    def get_train_path_identity_face(self, subject: int, expression: int,
                                     rnd_file: Optional[int] = None) -> str:
        if rnd_file is None:
            rnd_file = np.random.randint(0, env_paths.NUM_SPLITS)
        return os.path.join(self.get_train_dir_identity(subject),
                            f"{expression}_{rnd_file}_face.npy")

    def get_train_path_identity_non_face(self, subject: int, expression: int,
                                         rnd_file: Optional[int] = None) -> str:
        if rnd_file is None:
            rnd_file = np.random.randint(0, env_paths.NUM_SPLITS)
        return os.path.join(self.get_train_dir_identity(subject),
                            f"{expression}_{rnd_file}_non_face.npy")

    def get_train_dir_deformation(self, subject: int, expression: int) -> str:
        return os.path.join(env_paths.SUPERVISION_DEFORMATION_OPEN, f"{subject:03d}",
                            f"{expression:03d}")

    def get_train_path_deformation(self, subject: int, expression: int,
                                   rnd_file: Optional[int] = None) -> str:
        if rnd_file is None:
            rnd_file = np.random.randint(0, env_paths.NUM_SPLITS_EXPR)
        return os.path.join(self.get_train_dir_deformation(subject, expression),
                            f"corresp_{rnd_file}.npy")

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

    def get_raw_mesh(self, subject: int, expression: int,
                     coordinate_system: CoordSystem = "nphm", **_) -> Mesh:
        return self._load(self.get_raw_path(subject, expression), coordinate_system,
                          subject, expression)

    def get_flame_mesh(self, subject: int, expression: int,
                       coordinate_system: CoordSystem = "nphm", **_) -> Mesh:
        return self._load(self.get_flame_path(subject, expression), coordinate_system,
                          subject, expression)

    def get_registration_mesh(self, subject: int, expression: int,
                              coordinate_system: CoordSystem = "nphm", **_) -> Mesh:
        return self._load(self.get_registration_path(subject, expression),
                          coordinate_system, subject, expression)

    # landmarks and anchors

    def get_landmarks(self, subject: int, expression: int,
                      coordinate_system: CoordSystem = "nphm") -> np.ndarray:
        mesh = self.get_registration_mesh(subject, expression, coordinate_system)
        return mesh.vertices[self.lm_inds_upsampled, :]

    def get_facial_anchors(self, subject: int, expression: int,
                           coordinate_system: CoordSystem = "nphm") -> np.ndarray:
        mesh = self.get_registration_mesh(subject, expression, coordinate_system)
        return np.array(mesh.vertices[self.anchor_indices, :])

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
