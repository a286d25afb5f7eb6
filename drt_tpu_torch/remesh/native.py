"""ctypes binding for the native remeshing core (native/remesh.cpp), the
port's own copy of drt_tpu/remesh/native.py.

Builds the shared library at first use with g++ into build/drt_tpu_torch/
beside the package (rebuilt when the source is newer). If the toolchain is
unavailable `load_native` returns None and `isotropic_remesh` takes its
numpy route.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "remesh.cpp")
_LIB_DIR = os.path.join(_ROOT, "build", "drt_tpu_torch")
_LIB = os.path.join(_LIB_DIR, "libdrtremesh.so")

_lib = None


def _build() -> str:
    os.makedirs(_LIB_DIR, exist_ok=True)
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        # built under a name of this process's own, then moved into place:
        # several test workers may build at once
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-std=c++17", _SRC, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, _LIB)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return _LIB


def load_native():
    """Returns the loaded library or None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return None
    lib.remesh_iteration.restype = ctypes.c_int
    lib.remesh_iteration.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def native_remesh_iteration(vertices: np.ndarray, faces: np.ndarray,
                            target_len: float, smooth_lambda: float = 0.5,
                            orig_vertices: np.ndarray | None = None,
                            orig_faces: np.ndarray | None = None,
                            max_surf_dist: float = 0.0):
    """One split/collapse/flip/smooth iteration via the C++ core.
    When `orig_vertices/orig_faces` and `max_surf_dist > 0` are given, every
    collapse/flip is rejected if it would deviate more than `max_surf_dist`
    from that original surface (meshlabserver CheckSurfDist/MaxSurfDist,
    reference optim.py MLX script).
    Returns (vertices, faces) or raises RuntimeError if the library is
    unavailable."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native remesh library unavailable")

    v = np.ascontiguousarray(vertices, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    if orig_vertices is None or max_surf_dist <= 0:
        ov, of = v[:0], f[:0]
        max_surf_dist = 0.0
    else:
        ov = np.ascontiguousarray(orig_vertices, dtype=np.float64)
        of = np.ascontiguousarray(orig_faces, dtype=np.int32)

    # capacity estimate: splits can triple counts at coarse->fine targets
    cap_v = max(4 * len(v) + 4 * len(f), 4096)
    cap_f = max(8 * len(f), 8192)
    for _ in range(4):
        v_out = np.empty((cap_v, 3), dtype=np.float64)
        f_out = np.empty((cap_f, 3), dtype=np.int32)
        nv_out = ctypes.c_int64(0)
        nf_out = ctypes.c_int64(0)
        rc = lib.remesh_iteration(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(f),
            ctypes.c_double(target_len), ctypes.c_double(smooth_lambda),
            ov.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ov),
            of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(of),
            ctypes.c_double(max_surf_dist),
            v_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap_v,
            ctypes.byref(nv_out),
            f_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap_f,
            ctypes.byref(nf_out))
        if rc == 0:
            return (v_out[: nv_out.value].copy(),
                    f_out[: nf_out.value].astype(np.int64))
        cap_v *= 4
        cap_f *= 4
    raise RuntimeError("native remesh capacity negotiation failed")
