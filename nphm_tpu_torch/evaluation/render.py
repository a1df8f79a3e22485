"""Render-based surface sampling for evaluation and observation generation
(counterpart of ``nphm_tpu/evaluation/render.py``).

Behavioral spec: reference ``src/NPHM/evaluation/render_utils.py``:
- ``fibonacci_sphere`` camera distribution (:150-166),
- ``look_at`` camera poses (m3dLookAt, :134-147),
- ``gen_render_samples`` (:169-201): render a mesh from N views, back-project
  visible pixels to world-space points+normals, remove back-facing samples —
  the "fair" sampler behind Chamfer/F-score evaluation.

The GL renderer + GLSL normal shader + unprojection are replaced by the
port's copy of the native C++ z-buffer rasterizer
(``csrc/host/rasterizer.cpp``, loaded by ``ops.native``), which returns
world-space points and face normals per pixel directly.  Its output does not
depend on the thread count (``NPHM_RASTER_THREADS``): every pixel keeps the
first face, in face order, of those at its least depth.  Everything here
runs on the host.
"""

from __future__ import annotations

import ctypes
import math
import struct
import threading
import zlib

import numpy as np

from nphm_tpu_torch.ops.native import get_lib
from nphm_tpu_torch.utils.mesh_io import Mesh

# reference camera intrinsics for eval sampling (render_utils.py:8-11)
KK = np.array(
    [[2440.0, 0.0, 480.0], [0.0, 2440.0, 640.0], [0.0, 0.0, 1.0]], np.float32
)


def fibonacci_sphere(samples: int = 1000):
    points = []
    phi = math.pi * (math.sqrt(5.0) - 1.0)
    for i in range(samples):
        y = 1 - (i / float(samples - 1)) * 2
        radius = math.sqrt(1 - y * y)
        theta = phi * i
        points.append((math.cos(theta) * radius, y, math.sin(theta) * radius))
    return points


def look_at(eye, target, up):
    """OpenGL-style camera-to-world pose (camera looks along local -z)."""
    eye = np.asarray(eye, np.float64)
    mz = eye - np.asarray(target, np.float64)
    mz = mz / np.linalg.norm(mz)
    mx = np.cross(np.asarray(up, np.float64), mz)
    mx = mx / np.linalg.norm(mx)
    my = np.cross(mz, mx)
    my = my / np.linalg.norm(my)
    out = np.eye(4)
    out[:3, 0] = mx
    out[:3, 1] = my
    out[:3, 2] = mz
    out[:3, 3] = eye
    return out


def rasterize(
    mesh: Mesh,
    K: np.ndarray,
    Rt: np.ndarray,
    rend_size=(1280, 960),
    znear: float = 0.1,
    zfar: float = 2.0,
    face_normals: np.ndarray | None = None,
):
    """Render depth/points/normals from a pinhole camera.

    rend_size: (height, width).  face_normals: precomputed [F,3] unit face
    normals — pass them when rendering the same mesh from many views (they
    are view-independent); None computes them natively per call.  Returns
    dict with 'depth' [h,w] (view depth, inf at misses), 'points' [h,w,3]
    world, 'normals' [h,w,3] world face normals, 'mask' [h,w] bool.
    """
    h, w = int(rend_size[0]), int(rend_size[1])
    verts = np.ascontiguousarray(mesh.vertices, np.float32)
    faces = np.ascontiguousarray(mesh.faces, np.int32)
    K = np.ascontiguousarray(K, np.float32)
    Rt = np.ascontiguousarray(Rt, np.float32)

    depth = np.empty((h, w), np.float32)
    points = np.empty((h, w, 3), np.float32)
    normals = np.empty((h, w, 3), np.float32)
    mask = np.empty((h, w), np.uint8)

    lib = get_lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    if face_normals is not None:
        face_normals = np.ascontiguousarray(face_normals, np.float32)
        fn_arg = face_normals.ctypes.data_as(f32p)
    else:
        fn_arg = None
    rc = lib.nphm_rasterize(
        verts.ctypes.data_as(f32p), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        fn_arg,
        K.ctypes.data_as(f32p), Rt.ctypes.data_as(f32p),
        h, w, ctypes.c_float(znear), ctypes.c_float(zfar),
        depth.ctypes.data_as(f32p), points.ctypes.data_as(f32p),
        normals.ctypes.data_as(f32p),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f"rasterize failed with code {rc}")
    return {
        "depth": depth,
        "points": points,
        "normals": normals,
        "mask": mask.astype(bool),
    }


def render_view_points(
    mesh: Mesh, K, Rt, rend_size=(1280, 960), znear=0.1, zfar=2.0,
    face_normals=None,
):
    """Visible world-space surface samples + normals for one view."""
    out = rasterize(mesh, K, Rt, rend_size, znear, zfar, face_normals)
    m = out["mask"].reshape(-1)
    return out["points"].reshape(-1, 3)[m], out["normals"].reshape(-1, 3)[m]


def render_visible_points(
    mesh: Mesh, K, Rt, rend_size=(1280, 960), znear=0.1, zfar=2.0,
    face_normals=None, cos_thresh=0.01,
):
    """Front-facing visible surface samples + normals for one view, compacted
    natively (row-major pixel order — identical to masking the full-image
    rasterize() buffers, without materializing them)."""
    h, w = int(rend_size[0]), int(rend_size[1])
    verts = np.ascontiguousarray(mesh.vertices, np.float32)
    faces = np.ascontiguousarray(mesh.faces, np.int32)
    K = np.ascontiguousarray(K, np.float32)
    Rt = np.ascontiguousarray(Rt, np.float32)
    points = np.empty((h * w, 3), np.float32)
    normals = np.empty((h * w, 3), np.float32)
    count = ctypes.c_int64(0)

    lib = get_lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    if face_normals is not None:
        face_normals = np.ascontiguousarray(face_normals, np.float32)
        fn_arg = face_normals.ctypes.data_as(f32p)
    else:
        fn_arg = None
    rc = lib.nphm_render_visible(
        verts.ctypes.data_as(f32p), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        fn_arg,
        K.ctypes.data_as(f32p), Rt.ctypes.data_as(f32p),
        h, w, ctypes.c_float(znear), ctypes.c_float(zfar),
        ctypes.c_float(cos_thresh),
        points.ctypes.data_as(f32p), normals.ctypes.data_as(f32p),
        ctypes.byref(count),
    )
    if rc != 0:
        raise RuntimeError(f"render_visible failed with code {rc}")
    n = count.value
    return points[:n], normals[:n]


def native_face_normals(mesh: Mesh) -> np.ndarray:
    """Unit face normals via the threaded C++ helper — same formula as
    ``Mesh.face_normals`` (n / max(|n|, 1e-20)) without the numpy cross/norm
    chain's fresh [F,3] temporaries (~0.9 s -> ~0.05 s on a 1.7M-face
    marching-cubes mesh)."""
    verts = np.ascontiguousarray(mesh.vertices, np.float32)
    faces = np.ascontiguousarray(mesh.faces, np.int32)
    out = np.empty((len(faces), 3), np.float32)
    lib = get_lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.nphm_face_normals(
        verts.ctypes.data_as(f32p), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        out.ctypes.data_as(f32p),
    )
    if rc != 0:
        raise RuntimeError(f"face_normals failed with code {rc}")
    return out


# Per-thread sample accumulation buffers for gen_render_samples: allocated
# once per (thread, capacity) and reused, so repeated evaluation calls touch
# already-faulted pages instead of paying first-touch cost on ~300 MB of
# fresh allocations per mesh (np.empty reserves address space lazily — only
# rows actually written are ever materialized).
_WS = threading.local()


def _sample_workspace(capacity: int):
    ws = getattr(_WS, "buffers", None)
    if ws is None or len(ws[0]) < capacity:
        ws = (
            np.empty((capacity, 3), np.float32),
            np.empty((capacity, 3), np.float32),
        )
        _WS.buffers = ws
    return ws


def _render_visible_into(
    mesh: Mesh, K, Rt, rend_size, face_normals, pts_buf, nrm_buf, offset,
    znear=0.1, zfar=2.0, cos_thresh=0.01,
) -> int:
    """render_visible_points writing compacted samples at row `offset` of the
    caller-owned buffers; returns the number of rows written.  The buffers
    must have at least h*w rows of remaining capacity."""
    h, w = int(rend_size[0]), int(rend_size[1])
    if len(pts_buf) - offset < h * w:
        raise ValueError("insufficient sample-buffer capacity")
    verts = np.ascontiguousarray(mesh.vertices, np.float32)
    faces = np.ascontiguousarray(mesh.faces, np.int32)
    K = np.ascontiguousarray(K, np.float32)
    Rt = np.ascontiguousarray(Rt, np.float32)
    count = ctypes.c_int64(0)
    lib = get_lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.nphm_render_visible(
        verts.ctypes.data_as(f32p), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        np.ascontiguousarray(face_normals, np.float32).ctypes.data_as(f32p),
        K.ctypes.data_as(f32p), Rt.ctypes.data_as(f32p),
        h, w, ctypes.c_float(znear), ctypes.c_float(zfar),
        ctypes.c_float(cos_thresh),
        pts_buf[offset:].ctypes.data_as(f32p),
        nrm_buf[offset:].ctypes.data_as(f32p),
        ctypes.byref(count),
    )
    if rc != 0:
        raise RuntimeError(f"render_visible failed with code {rc}")
    return count.value


def render_screenshot(
    mesh: Mesh,
    path: str,
    rend_size=(640, 480),
    scale: float = 4.0,
    eye=(0.0, 0.0, 0.6),
):
    """Shaded frontal screenshot of a mesh, saved as PNG.

    Parity for the reference's pyvista screenshots of sampled/fitted heads
    (``scripts/fitting/fitting_pointclouds.py:222`` saves a plotter
    screenshot per sample): one frontal render through the native C++
    rasterizer, headlight Lambertian shading from the face normals, white
    background, written by ``write_png`` (no imaging library needed)."""
    m = Mesh(mesh.vertices / scale, mesh.faces)
    E = look_at(np.asarray(eye, np.float64), np.zeros(3), np.array([0, 1, 0]))
    h, w = int(rend_size[0]), int(rend_size[1])
    # scale the eval intrinsics to the screenshot resolution
    K = KK * np.float32(h / 1280.0)
    K[2, 2] = 1.0
    out = rasterize(m, K, E, (h, w))
    view_dir = np.asarray(eye, np.float32)
    view_dir = view_dir / np.linalg.norm(view_dir)
    lambert = np.abs(out["normals"] @ view_dir)  # double-sided headlight
    shade = (0.15 + 0.85 * lambert)[..., None] * np.array(
        [0.82, 0.80, 0.78], np.float32
    )
    img = np.where(out["mask"][..., None], shade, 1.0)
    img8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    write_png(path, img8)


def write_png(path: str, rgb: np.ndarray):
    """Save an [h, w, 3] uint8 image as an 8-bit RGB PNG: one IHDR, one
    zlib-compressed IDAT of rows each led by filter byte 0, one IEND."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes [h, w, 3] RGB, got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def gen_render_samples(mesh: Mesh, n_views: int, scale: float = 4.0):
    """Multi-view visible-surface sampling with backface removal
    (reference render_utils.py:169-201).

    The returned arrays are views into a per-thread scratch buffer that the
    NEXT gen_render_samples call on the same thread overwrites — consume (or
    copy) them before rendering another mesh.  Evaluation draws its sample
    subsets immediately, so this zero-copy contract saves two full passes
    over the ~150 MB of visible samples a production mesh produces."""
    # Convert to the rasterizer's layout ONCE: load_mesh yields int64 faces,
    # and the per-view ascontiguousarray(faces, int32) otherwise re-copies
    # ~24 MB per view on a production 2M-face mesh (10x per mesh).  After
    # this, every downstream ascontiguousarray call is a no-op view.
    m = Mesh(
        np.ascontiguousarray(mesh.vertices / scale, np.float32),
        np.ascontiguousarray(mesh.faces, np.int32),
    )
    # face normals are view-independent (and invariant to the uniform
    # scale): compute once for all n_views renders
    fn = native_face_normals(m)
    h, w = 1280, 960
    pts_buf, nrm_buf = _sample_workspace(n_views * h * w)
    cams = fibonacci_sphere(n_views + 2)[1:-1]
    cams.reverse()
    total = 0
    for cam_origin in cams:
        eye = np.asarray(cam_origin) * 0.6
        E = look_at(eye, np.zeros(3), np.array([0, 1, 0]))
        total += _render_visible_into(
            m, KK, E, (h, w), fn, pts_buf, nrm_buf, total
        )
    pts = pts_buf[:total]
    pts *= scale  # in place: skip a second ~72 MB pass over the samples
    return pts, nrm_buf[:total]
