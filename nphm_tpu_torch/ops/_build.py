"""Build and load the package's CUDA kernels (``nphm_tpu_torch/csrc/*.cu``).

Every source compiles with its own ``nvcc`` process, all started together,
and the objects link into one shared library with a plain C interface, at
first use, into ``nphm_tpu_torch/_build/`` (git-ignored), and again whenever
a source is newer than the library.  No library beyond the CUDA runtime is
linked: every kernel's TMA descriptors come from ``cuTensorMapEncodeTiled``,
reached through the runtime's entry-point query.  The library is loaded with
``ctypes``: every pointer and the stream travel as ``c_void_p``, every entry
point returns ``cudaGetLastError()`` and ``check`` raises on a non-zero code.
Nothing is downloaded; the only inputs are the sources in the package.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libnphm_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
MAX_LAYERS = 12  # csrc/mlp_tile.cuh kMaxLayers
MAX_HEAD = 4  # csrc/mlp_tile.cuh kMaxHead

_LOCK = threading.Lock()
_LIB = None

_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_i32 = ctypes.c_int
_f32 = ctypes.c_float


class Trunk(ctypes.Structure):
    """Host mirror of ``nphm::Trunk`` (csrc/mlp_tile.cuh); all fields 8 bytes."""

    _fields_ = [
        ("n_layers", _i64),
        ("skip", _i64),
        ("row_len", _i64),
        ("beta", ctypes.c_double),
        ("n_in", _i64 * MAX_LAYERS),
        ("n_out", _i64 * MAX_LAYERS),
        ("ldw", _i64 * MAX_LAYERS),
        ("w_ms", _i64 * MAX_LAYERS),
        ("ldwt", _i64 * MAX_LAYERS),
        ("wt_ms", _i64 * MAX_LAYERS),
        ("b_ms", _i64 * MAX_LAYERS),
        ("b_rs", _i64 * MAX_LAYERS),
        ("wp_ms", _i64),
        ("w", _vp * MAX_LAYERS),
        ("wt", _vp * MAX_LAYERS),
        ("b", _vp * MAX_LAYERS),
        ("wp", _vp),
    ]


_SIGNATURES = {
    "nphm_ensemble_sdf": [
        ctypes.POINTER(Trunk), _vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _f32, _f32,
        _vp,
    ],
    "nphm_broyden_search": [
        ctypes.POINTER(Trunk), _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64,
        _i64, _i64, _i32, _f32, _f32, _f32, _vp,
    ],
    "nphm_fit_fwd": [
        ctypes.POINTER(Trunk), _vp, _vp, _vp, _i64, _i32, _i32, _i32, _vp,
    ],
    "nphm_fit_bwd": [
        ctypes.POINTER(Trunk), _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64,
        _i32, _i32, _i32, _i32, _vp,
    ],
    "nphm_train_fwd": [
        ctypes.POINTER(Trunk), _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _vp,
    ],
    "nphm_train_bwd": [
        ctypes.POINTER(Trunk), _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64,
        _i32, _i32, _i32, _i32, _i32, _i32, _i32, _vp,
    ],
    "nphm_trunk_layer": [
        _vp, _vp, _i32, _i32, _vp, _vp, _i32, _vp, _i32, _vp, _vp, _vp, _vp, _i32,
        _i32, _i64, _f32, _vp,
    ],
    "nphm_trunk_head": [_vp, _vp, _vp, _vp, _i32, _i32, _vp, _i32, _i64, _vp],
    "nphm_fit_occupancy": [ctypes.POINTER(Trunk), _i32, _i32, _i32, _vp],
    "nphm_train_occupancy": [ctypes.POINTER(Trunk), _i32, _i32, _i32, _vp],
    "nphm_ensemble_points_per_block": [],
    "nphm_search_lanes_per_block": [],
    "nphm_fit_lanes_per_block": [],
    "nphm_train_fwd_lanes_per_block": [],
    "nphm_train_lanes_per_block": [],
    "nphm_train_split_k": [],
    "nphm_trunk_tile": [],
}


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def build() -> tuple[float, str]:
    """Compile every ``csrc/*.cu`` (one nvcc process each, in parallel) and
    link the objects into the library.

    Returns (seconds taken, the compiler's ``-Xptxas -v`` report of each
    kernel's registers, shared memory and spills).
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, "-Xptxas=-v", *NVCC_FLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    outs = [p.communicate()[0] for p in procs]
    try:
        failed = [o for p, o in zip(procs, outs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}"
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return time.perf_counter() - t0, "".join(outs)


def sass_mma_counts() -> dict[str, int]:
    """Tensor-core instructions (``HGMMA``, ``HMMA``) per kernel in the built
    library's SASS (``cuobjdump --dump-sass``), keyed by mangled name."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", LIB_PATH], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = 0
        elif name is not None and ("HGMMA" in line or "HMMA" in line):
            counts[name] += 1
    return counts


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _stale():
            build()
        handle = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = _i32
        _LIB = handle
        return _LIB


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_f32(*tensors, dtypes=(torch.float32,)):
    """Raise unless every tensor is a contiguous CUDA tensor of one of
    ``dtypes`` (float32 alone by default)."""
    dev = tensors[0].device
    for t in tensors:
        if not (t.is_cuda and t.dtype in dtypes and t.is_contiguous()):
            raise ValueError(f"kernel inputs must be contiguous {'/'.join(map(str, dtypes))} "
                             "CUDA tensors")
        if t.device != dev:
            raise ValueError("kernel inputs must share one device")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")


def require_mask(active, shape, device):
    """Raise unless a cull mask is a contiguous int32 tensor of ``shape`` on
    ``device``."""
    if not (active.device == device and active.dtype == torch.int32
            and active.is_contiguous() and tuple(active.shape) == tuple(shape)):
        raise ValueError(f"cull mask must be contiguous int32 {tuple(shape)} on {device}")


def padded(w: torch.Tensor, cols: int) -> torch.Tensor:
    """[..., n] -> contiguous [..., cols] with zero columns appended."""
    n = w.shape[-1]
    if n == cols:
        return w.contiguous()
    out = w.new_zeros(w.shape[:-1] + (cols,))
    out[..., :n] = w
    return out


def round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def make_trunk(*, n_layers, skip, row_len, beta, layers, wp=None, wp_ms=0):
    """Fill a ``Trunk`` from per-layer dicts.

    layers[i]: dict(n_in, n_out, w, ldw, w_ms, b=None, b_ms=0, b_rs=0,
    wt=None, ldwt=0, wt_ms=0) with tensors for w/b/wt.  The caller keeps
    the tensors alive for as long as the kernel may read them.
    """
    if n_layers > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers")
    tr = Trunk()
    tr.n_layers, tr.skip, tr.row_len, tr.beta = n_layers, skip, row_len, beta
    for i, lay in enumerate(layers):
        tr.n_in[i], tr.n_out[i] = lay["n_in"], lay["n_out"]
        tr.w[i], tr.ldw[i], tr.w_ms[i] = lay["w"].data_ptr(), lay["ldw"], lay["w_ms"]
        if lay.get("b") is not None:
            tr.b[i] = lay["b"].data_ptr()
            tr.b_ms[i], tr.b_rs[i] = lay.get("b_ms", 0), lay.get("b_rs", 0)
        if lay.get("wt") is not None:
            tr.wt[i] = lay["wt"].data_ptr()
            tr.ldwt[i], tr.wt_ms[i] = lay["ldwt"], lay["wt_ms"]
    if wp is not None:
        tr.wp, tr.wp_ms = wp.data_ptr(), wp_ms
    return tr
