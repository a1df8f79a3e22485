"""Triangle-mesh container and PLY IO (counterpart of
``nphm_tpu/utils/mesh_io.py``; same PLY bytes): the container with its
vertex normals, face areas and vertex-mask submeshes, ``read_ply`` /
``load_mesh`` for the formats of the NPHM dataset and assets (ascii and
binary_little_endian, float/uchar properties, uchar-count int-index face
lists, polygons fan-triangulated) and ``write_ply``.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Optional

import numpy as np

_PLY_DTYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("<u1", 1), "uint8": ("<u1", 1),
    "char": ("<i1", 1), "int8": ("<i1", 1),
    "ushort": ("<u2", 2), "uint16": ("<u2", 2),
    "short": ("<i2", 2), "int16": ("<i2", 2),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
    "int": ("<i4", 4), "int32": ("<i4", 4),
}


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # [V, 3] float
    faces: np.ndarray  # [F, 3] int
    vertex_colors: Optional[np.ndarray] = None  # [V, 3 or 4] uint8
    vertex_normals_: Optional[np.ndarray] = None

    def _cross(self) -> np.ndarray:
        v, f = self.vertices, self.faces
        return np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])

    @property
    def face_areas(self) -> np.ndarray:
        return 0.5 * np.linalg.norm(self._cross(), axis=-1)

    @property
    def vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals."""
        if self.vertex_normals_ is not None:
            return self.vertex_normals_
        fn = self._cross()
        vn = np.zeros_like(self.vertices)
        for k in range(3):
            np.add.at(vn, self.faces[:, k], fn)
        vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)
        self.vertex_normals_ = vn
        return vn

    def export(self, path: str):
        write_ply(path, self.vertices, self.faces, colors=self.vertex_colors)

    def submesh_by_vertex_mask(self, keep: np.ndarray) -> "Mesh":
        """Drop faces touching any masked-out vertex and reindex."""
        keep = np.asarray(keep, bool)
        face_ok = keep[self.faces].all(axis=1)
        new_idx = np.full(len(self.vertices), -1, np.int64)
        new_idx[keep] = np.arange(keep.sum())
        faces = new_idx[self.faces[face_ok]]
        colors = self.vertex_colors[keep] if self.vertex_colors is not None else None
        return Mesh(self.vertices[keep], faces, colors)


def _parse_header(f):
    if f.readline().decode("ascii").strip() != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop, type) or ("list", count_t, item_t, name)])
    while True:
        line = f.readline().decode("ascii").strip()
        if line == "end_header":
            break
        parts = line.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))
    return fmt, elements


def _read_ascii(f, elements):
    tokens = iter(f.read().split())
    data = {}
    for name, count, props in elements:
        if any(p[0] == "list" for p in props):
            rows = []
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        n = int(next(tokens))
                        rows.append([int(next(tokens)) for _ in range(n)])
                    else:
                        next(tokens)
            data[name] = {"list": rows}
        else:
            cols = [p[0] for p in props]
            vals = np.array([float(next(tokens)) for _ in range(count * len(cols))])
            vals = vals.reshape(count, len(cols))
            data[name] = {c: vals[:, i] for i, c in enumerate(cols)}
    return data


def _read_binary(f, elements):
    data = {}
    for name, count, props in elements:
        if not any(p[0] == "list" for p in props):
            dtype = np.dtype([(p[0], _PLY_DTYPES[p[1]][0]) for p in props])
            arr = np.frombuffer(f.read(count * dtype.itemsize), dtype, count)
            data[name] = {p[0]: arr[p[0]] for p in props}
            continue
        if len(props) != 1:
            raise ValueError("mixed list/scalar element not supported")
        _, ct, it, _name = props[0]
        ct_np, ct_sz = _PLY_DTYPES[ct]
        it_np, it_sz = _PLY_DTYPES[it]
        buf = f.read()
        off = 0
        # uniform list length (triangles, quads): one structured array
        if count:
            n0 = int(np.frombuffer(buf, ct_np, 1, 0)[0])
            rec_sz = ct_sz + n0 * it_sz
            if n0 >= 1 and len(buf) >= count * rec_sz:
                arr = np.frombuffer(buf, np.dtype([("n", ct_np), ("idx", it_np, (n0,))]),
                                    count)
                if (arr["n"] == n0).all():
                    data[name] = {"uniform": arr["idx"].reshape(count, n0).astype(np.int64)}
                    off = count * rec_sz
        if name not in data:
            rows = []
            for _ in range(count):
                n = int(np.frombuffer(buf, ct_np, 1, off)[0])
                off += ct_sz
                rows.append(np.frombuffer(buf, it_np, n, off).astype(np.int64))
                off += it_sz * n
            data[name] = {"list": rows}
        f = io.BytesIO(buf[off:])  # any further element follows the list
    return data


def read_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        if fmt == "ascii":
            data = _read_ascii(f, elements)
        elif fmt == "binary_little_endian":
            data = _read_binary(f, elements)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    v = data["vertex"]
    vertices = np.stack([np.asarray(v[c]) for c in "xyz"], axis=-1).astype(np.float32)
    colors = None
    if "red" in v:
        chans = ["red", "green", "blue"] + (["alpha"] if "alpha" in v else [])
        colors = np.stack([np.asarray(v[c]) for c in chans], axis=-1).astype(np.uint8)
    normals = None
    if "nx" in v:
        normals = np.stack([np.asarray(v[c]) for c in ("nx", "ny", "nz")],
                           axis=-1).astype(np.float32)

    faces = np.zeros((0, 3), np.int64)
    face = data.get("face", {})
    if face.get("uniform") is not None:
        idx = face["uniform"]
        faces = idx if idx.shape[1] == 3 else np.concatenate(
            [np.stack([idx[:, 0], idx[:, k], idx[:, k + 1]], axis=-1)
             for k in range(1, idx.shape[1] - 1)], axis=0)
    elif face.get("list"):
        tri = [[r[0], r[k], r[k + 1]] for r in face["list"] for k in range(1, len(r) - 1)]
        faces = np.asarray(tri, np.int64)
    return Mesh(vertices, faces, colors, normals)


def load_mesh(path: str) -> Mesh:
    if not path.endswith(".ply"):
        raise ValueError(f"only PLY meshes are supported, got {path}")
    return read_ply(path)


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
