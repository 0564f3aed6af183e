"""ctypes binding for the native BVH mesh-distance library.

The port's own copy of flobaroid_tpu/native_meshdist.py. The native
library (native/meshdist/meshdist.cpp) is the exact triangle-level
narrowphase — the role C++ FCL plays for the reference
(identification/collision.py:19-267). It is a host library, not a device
kernel: it is compiled on first use with g++ into
`build/flobaroid_tpu_torch/libmeshdist.so` under the repository root
(`ops/_build.py`, rebuilt when the source changes). Where the source or
the compiler is missing, `available()` returns False and callers keep the
convex-hull tier, which is conservative.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from .ops import _build

_SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / "meshdist" / "meshdist.cpp"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False


def _build_lib() -> ctypes.CDLL | None:
    if not _SOURCE.exists():
        return None
    try:
        return ctypes.CDLL(str(_build.build_host_library("meshdist", _SOURCE)))
    except (OSError, RuntimeError):
        return None


def _lib() -> ctypes.CDLL | None:
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is None and not _LIB_FAILED:
            _LIB = _build_lib()
            if _LIB is None:
                _LIB_FAILED = True
            else:
                _LIB.md_build.restype = ctypes.c_void_p
                _LIB.md_build.argtypes = [
                    ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ]
                _LIB.md_free.restype = None
                _LIB.md_free.argtypes = [ctypes.c_void_p]
                _LIB.md_num_tris.restype = ctypes.c_int
                _LIB.md_num_tris.argtypes = [ctypes.c_void_p]
                for f in ("md_distance", "md_distance_brute"):
                    fn = getattr(_LIB, f)
                    fn.restype = ctypes.c_double
                    fn.argtypes = [
                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                    ]
                _LIB.md_inside.restype = ctypes.c_int
                _LIB.md_inside.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
                ]
        return _LIB


def available() -> bool:
    return _lib() is not None


class NativeMesh:
    """BVH over a triangle mesh; query with 4x4 rigid world transforms."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native meshdist library unavailable")
        self._lib = lib
        # an actual surface vertex (mesh frame): guaranteed to lie inside
        # any mesh that fully contains this one (containment queries)
        self.surface_point = np.asarray(vertices, dtype=np.float64)[0].copy()
        v = np.ascontiguousarray(vertices, dtype=np.float64)
        t = np.ascontiguousarray(triangles, dtype=np.int32)
        if v.ndim != 2 or v.shape[1] != 3 or t.ndim != 2 or t.shape[1] != 3:
            raise ValueError("vertices must be (V,3), triangles (T,3)")
        if t.size and (t.min() < 0 or t.max() >= len(v)):
            raise ValueError("triangle indices out of range of the vertices")
        self._handle = lib.md_build(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(t),
        )
        if not self._handle:
            raise ValueError("mesh has no valid triangles")
        self.num_tris = lib.md_num_tris(self._handle)

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.md_free(h)
            self._handle = None


def _t16(T) -> np.ndarray:
    T = np.eye(4) if T is None else np.asarray(T, dtype=np.float64)
    if T.shape == (3, 3):
        M = np.eye(4)
        M[:3, :3] = T
        T = M
    return np.ascontiguousarray(T.reshape(16))


def distance(a: NativeMesh, Ta, b: NativeMesh, Tb, brute: bool = False) -> float:
    """Minimum distance between the transformed meshes; 0.0 when they
    intersect (penetration is confirmed triangle-exactly, the role of
    the reference's collide() follow-up)."""
    Ta16, Tb16 = _t16(Ta), _t16(Tb)
    fn = a._lib.md_distance_brute if brute else a._lib.md_distance
    return float(fn(
        a._handle, Ta16.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        b._handle, Tb16.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    ))


def contains_point(m: NativeMesh, T, point_world) -> bool:
    """Ray-parity containment of a world-frame point in the transformed
    (approximately closed) mesh. Surface distance cannot see full
    containment — the role FCL's signed queries would play."""
    T = np.asarray(_t16(T)).reshape(4, 4)
    p_local = T[:3, :3].T @ (np.asarray(point_world, float) - T[:3, 3])
    p = np.ascontiguousarray(p_local, dtype=np.float64)
    return bool(m._lib.md_inside(
        m._handle, p.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    ))


def contained(a: NativeMesh, Ta, b: NativeMesh, Tb) -> bool:
    """True when a surface point of one mesh lies inside the other —
    the containment case a positive surface-to-surface distance hides."""
    Ta4 = np.asarray(_t16(Ta)).reshape(4, 4)
    Tb4 = np.asarray(_t16(Tb)).reshape(4, 4)
    pa_world = Ta4[:3, :3] @ a.surface_point + Ta4[:3, 3]
    if contains_point(b, Tb4, pa_world):
        return True
    pb_world = Tb4[:3, :3] @ b.surface_point + Tb4[:3, 3]
    return contains_point(a, Ta4, pb_world)


def mesh_from_transform(T_rot: np.ndarray | None, pos: np.ndarray | None) -> np.ndarray:
    """Assemble a 4x4 rigid transform from (R, p)."""
    T = np.eye(4)
    if T_rot is not None:
        T[:3, :3] = np.asarray(T_rot, dtype=float)
    if pos is not None:
        T[:3, 3] = np.asarray(pos, dtype=float)
    return T
