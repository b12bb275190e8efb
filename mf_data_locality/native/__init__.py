"""ctypes bindings for the native C++ setup runtime (native/setup.cc).

The shared library is built on demand with g++ on first import (cached next
to the source).  Every entry point has a pure-NumPy equivalent elsewhere in
the package; :data:`AVAILABLE` is False when no compiler is present and
callers fall back automatically.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _SRC_DIR / "libmfdl_setup.so"

AVAILABLE = False
_lib = None


def _build() -> bool:
    src = _SRC_DIR / "setup.cc"
    if not src.exists():
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             str(src), "-o", str(_LIB_PATH)],
            check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> None:
    global _lib, AVAILABLE
    src = _SRC_DIR / "setup.cc"
    stale = (_LIB_PATH.exists() and src.exists()
             and src.stat().st_mtime > _LIB_PATH.stat().st_mtime)
    if (not _LIB_PATH.exists() or stale) and not _build():
        if not _LIB_PATH.exists():
            return
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c = ctypes.c_int32
    c64 = ctypes.c_int64
    lib.build_gather_map.argtypes = [c, c, c, c, i32p]
    lib.build_vertex_lattice.argtypes = [c, c, c, ctypes.c_double,
                                         ctypes.c_double, c, f64p]
    lib.build_trilinear_coefficients.argtypes = [c, c, c, f64p, f64p]
    lib.renumber_locality.argtypes = [i32p, c64, c, c64, u8p, i32p]
    lib.renumber_locality.restype = c64
    lib.build_boundary_mask.argtypes = [c64, c64, c64, u8p]
    _lib = lib
    AVAILABLE = True


_load()


def gather_map(p: int, ncz: int, ncy: int, ncx: int) -> np.ndarray:
    """(n_cells, (p+1)^3) int32 structured gather map (native)."""
    out = np.empty((ncz * ncy * ncx, (p + 1) ** 3), dtype=np.int32)
    _lib.build_gather_map(p, ncz, ncy, ncx, out)
    return out


def vertex_lattice(ncz: int, ncy: int, ncx: int, h: float,
                   factor: float = 0.1, deformed: bool = True) -> np.ndarray:
    """Deformed vertex lattice (ncz+1, ncy+1, ncx+1, 3) (native)."""
    out = np.empty(((ncz + 1) * (ncy + 1) * (ncx + 1) * 3,), dtype=np.float64)
    _lib.build_vertex_lattice(ncz, ncy, ncx, float(h), float(factor),
                              int(deformed), out)
    return out.reshape(ncz + 1, ncy + 1, ncx + 1, 3)


def trilinear_coefficients(ncz: int, ncy: int, ncx: int,
                           verts: np.ndarray) -> np.ndarray:
    """(n_cells, 8, 3) trilinear coefficients from the vertex lattice (native)."""
    v = np.ascontiguousarray(verts.reshape(-1), dtype=np.float64)
    out = np.empty((ncz * ncy * ncx * 24,), dtype=np.float64)
    _lib.build_trilinear_coefficients(ncz, ncy, ncx, v, out)
    return out.reshape(ncz * ncy * ncx, 8, 3)


def renumber_locality(gather: np.ndarray, n_nodes: int,
                      ghost_flags: np.ndarray | None = None
                      ) -> tuple[np.ndarray, int]:
    """Locality permutation (old node -> new node), and #interior nodes."""
    g = np.ascontiguousarray(gather, dtype=np.int32)
    n_cells, nloc = g.shape
    if ghost_flags is None:
        ghost_flags = np.zeros(n_nodes, dtype=np.uint8)
    gf = np.ascontiguousarray(ghost_flags, dtype=np.uint8)
    out = np.empty(n_nodes, dtype=np.int32)
    n_int = _lib.renumber_locality(g, n_cells, nloc, n_nodes, gf, out)
    return out, int(n_int)


def boundary_mask(nz: int, ny: int, nx: int) -> np.ndarray:
    """(nz*ny*nx,) bool whole-boundary Dirichlet mask (native)."""
    out = np.empty(nz * ny * nx, dtype=np.uint8)
    _lib.build_boundary_mask(nz, ny, nx, out)
    return out.astype(bool)

