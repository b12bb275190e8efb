"""Structured hex meshes for the BP4 benchmark family.

Reproduces the reference mesh recipe (``common_code/benchmark.h:66-89``):

* ``s`` is the size exponent; ``n_refine = s // 3``, ``remainder = s % 3``.
* The base box is ``[0, 2]`` in the first ``remainder`` coordinates (with 2
  base subdivisions there) and ``[0, 1]`` (1 subdivision) in the rest, so the
  refined mesh always has exactly ``2**s`` congruent cells of spacing
  ``2**-n_refine``.
* Every vertex of the refined lattice is mapped through the sine manifold.
  (In deal.II the manifold is attached before ``refine_global`` so refined
  vertices are chart midpoints; for this chart the pull-backs of base vertices
  are exact lattice points, hence every refined vertex is exactly
  ``push_forward(lattice point)`` — which is what we evaluate directly.)

The mesh is exposed both as a structured lattice (the fast path: per-cell
extraction by reshapes) and as generic ``(vertices, cells)`` connectivity for
the general gather/scatter operator and for dense validation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from mf_data_locality.mesh import manifold


@dataclass(frozen=True)
class BoxMesh:
    """A structured, manifold-deformed hex mesh.

    Cell (cz, cy, cx) — z slowest — covers lattice nodes
    ``[cz, cz+1] x [cy, cy+1] x [cx, cx+1]`` of the vertex lattice.
    """

    n_cells_axis: tuple[int, int, int]  # (ncz, ncy, ncx)
    spacing: float  # lattice spacing h (same in all axes)
    deformed: bool = True
    factor: float = manifold.DEFAULT_FACTOR

    @classmethod
    def from_s(cls, s: int, deformed: bool = True) -> "BoxMesh":
        """The reference size ladder geometry: 2**s cells (benchmark.h:66-89)."""
        if s < 0:
            raise ValueError("s must be non-negative")
        n_refine, remainder = divmod(s, 3)
        h = 0.5**n_refine
        # first `remainder` *coordinates* (x, then y) get extent 2 / 2 subdivisions
        nc_xyz = [2 ** (n_refine + (1 if d < remainder else 0)) for d in range(3)]
        return cls(n_cells_axis=(nc_xyz[2], nc_xyz[1], nc_xyz[0]), spacing=h,
                   deformed=deformed)

    @property
    def n_cells(self) -> int:
        ncz, ncy, ncx = self.n_cells_axis
        return ncz * ncy * ncx

    @cached_property
    def vertex_lattice(self) -> np.ndarray:
        """Deformed vertex coordinates, shape (ncz+1, ncy+1, ncx+1, 3) as (x,y,z).

        Uses the native C++ builder when available (native/setup.cc).
        """
        ncz, ncy, ncx = self.n_cells_axis
        from mf_data_locality import native
        if native.AVAILABLE and self.factor == manifold.DEFAULT_FACTOR:
            return native.vertex_lattice(ncz, ncy, ncx, self.spacing,
                                         deformed=self.deformed)
        z = np.arange(ncz + 1) * self.spacing
        y = np.arange(ncy + 1) * self.spacing
        x = np.arange(ncx + 1) * self.spacing
        Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
        pts = np.stack([X, Y, Z], axis=-1)
        if self.deformed:
            pts = manifold.push_forward(pts, self.factor)
        return pts

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        """Per-cell corner coordinates, shape (n_cells, 8, 3).

        Local vertex ordering matches deal.II hexes: vertex ``v`` sits at local
        coords ``(v & 1, (v >> 1) & 1, (v >> 2) & 1)`` (x fastest) — the order
        the trilinear coefficients (``poisson_operator.h:151-179``) assume.
        Cells are numbered lexicographically with z slowest.
        """
        lat = self.vertex_lattice
        ncz, ncy, ncx = self.n_cells_axis
        out = np.empty((ncz, ncy, ncx, 8, 3), dtype=np.float64)
        for v in range(8):
            dx, dy, dz = v & 1, (v >> 1) & 1, (v >> 2) & 1
            out[..., v, :] = lat[dz:dz + ncz, dy:dy + ncy, dx:dx + ncx, :]
        return out.reshape(self.n_cells, 8, 3)

    # ---- generic connectivity (for the general-mesh operator & validation) ----

    @cached_property
    def vertices(self) -> np.ndarray:
        """Flat vertex array (n_vertices, 3), lexicographic with z slowest."""
        return self.vertex_lattice.reshape(-1, 3)

    @cached_property
    def cells(self) -> np.ndarray:
        """Cell->vertex connectivity (n_cells, 8) into :attr:`vertices`."""
        ncz, ncy, ncx = self.n_cells_axis
        nvx, nvy = ncx + 1, ncy + 1
        cz, cy, cx = np.meshgrid(
            np.arange(ncz), np.arange(ncy), np.arange(ncx), indexing="ij"
        )
        base = (cz * nvy + cy) * nvx + cx  # vertex id of corner (0,0,0)
        conn = np.empty((ncz, ncy, ncx, 8), dtype=np.int64)
        for v in range(8):
            dx, dy, dz = v & 1, (v >> 1) & 1, (v >> 2) & 1
            conn[..., v] = base + (dz * nvy + dy) * nvx + dx
        return conn.reshape(self.n_cells, 8)
