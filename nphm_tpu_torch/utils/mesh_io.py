"""Triangle-mesh container and PLY export (the part of
``nphm_tpu/utils/mesh_io.py`` the port uses; same PLY bytes)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # [V, 3] float
    faces: np.ndarray  # [F, 3] int
    vertex_colors: Optional[np.ndarray] = None  # [V, 3 or 4] uint8

    def export(self, path: str):
        write_ply(path, self.vertices, self.faces, colors=self.vertex_colors)


def write_ply(path, vertices, faces=None, normals=None, colors=None, binary=True):
    vertices = np.asarray(vertices, np.float32)
    n_v = len(vertices)
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append("comment nphm_tpu")
    header.append(f"element vertex {n_v}")
    header += ["property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        names = ["red", "green", "blue", "alpha"][: colors.shape[1]]
        header += [f"property uchar {n}" for n in names]
    if faces is not None:
        faces = np.asarray(faces, np.int32)
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            cols = [vertices]
            if normals is not None:
                cols.append(np.asarray(normals, np.float32))
            fields = [("v", "<f4", 3)]
            if normals is not None:
                fields.append(("n", "<f4", 3))
            if colors is not None:
                fields.append(("c", "<u1", colors.shape[1]))
            rec = np.zeros(n_v, np.dtype(fields))
            rec["v"] = vertices
            if normals is not None:
                rec["n"] = np.asarray(normals, np.float32)
            if colors is not None:
                rec["c"] = colors
            f.write(rec.tobytes())
            if faces is not None:
                frec = np.zeros(
                    len(faces), np.dtype([("n", "<u1"), ("idx", "<i4", 3)])
                )
                frec["n"] = 3
                frec["idx"] = faces
                f.write(frec.tobytes())
        else:
            for i in range(n_v):
                row = list(vertices[i])
                if normals is not None:
                    row += list(np.asarray(normals[i], np.float32))
                txt = " ".join(f"{x:.8g}" for x in row)
                if colors is not None:
                    txt += " " + " ".join(str(int(c)) for c in colors[i])
                f.write((txt + "\n").encode("ascii"))
            if faces is not None:
                for fa in faces:
                    f.write(f"3 {fa[0]} {fa[1]} {fa[2]}\n".encode("ascii"))
