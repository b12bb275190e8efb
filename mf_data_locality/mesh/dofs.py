"""Degree-of-freedom numbering, gather maps and Dirichlet constraints.

Capability of deal.II's DoFHandler + AffineConstraints as used by the
benchmark (reference: ``common_code/benchmark.h:91-120``): continuous FE_Q(p)
spaces on the hex mesh with zero Dirichlet values on the whole boundary, plus
the per-cell index maps the matrix-free loop gathers with (the role of
``compressed_dof_indices``, ``poisson_operator.h:183-267``).

Numbering decision: DoF *nodes* are numbered lexicographically over
the global node lattice (z slowest), with the ``n_components`` vector
components stored as a trailing axis of the DoF vector, i.e. a DoF vector has
shape ``(n_nodes, n_components)``.  On structured meshes the flat node order
*is* the 3D lattice order, so the hot path can reshape to
``(Nz, Ny, Nx, C)`` and extract per-cell data with strided slices instead of
gathers — the lattice layout *is* our locality renumbering (the capability of
``renumber_dofs_for_mf.h``: sweep-ordered, contiguous-per-object DoFs).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.ops import quadrature
from mf_data_locality.ops.geometry import map_points, trilinear_coefficients


@dataclass(frozen=True)
class DofLayout:
    """DoF numbering of a continuous Q_p space on a structured box mesh."""

    mesh: BoxMesh
    degree: int

    @property
    def n_nodes_axis(self) -> tuple[int, int, int]:
        """(Nz, Ny, Nx) scalar-node lattice dimensions."""
        ncz, ncy, ncx = self.mesh.n_cells_axis
        p = self.degree
        return (p * ncz + 1, p * ncy + 1, p * ncx + 1)

    @property
    def n_nodes(self) -> int:
        nz, ny, nx = self.n_nodes_axis
        return nz * ny * nx

    @property
    def nodes_per_cell(self) -> int:
        return (self.degree + 1) ** 3

    @cached_property
    def gather_map(self) -> np.ndarray:
        """(n_cells, (p+1)^3) int32: global node id for each cell-local node.

        Cell-local nodes in lexicographic (z, y, x) order, x fastest; cells in
        lexicographic order, z slowest (matching :class:`BoxMesh`).  Uses the
        native C++ builder when available (native/setup.cc).
        """
        p = self.degree
        ncz, ncy, ncx = self.mesh.n_cells_axis
        nz, ny, nx = self.n_nodes_axis
        if self.n_nodes < np.iinfo(np.int32).max:
            from mf_data_locality import native
            if native.AVAILABLE:
                return native.gather_map(p, ncz, ncy, ncx)
        cz, cy, cx = np.meshgrid(
            np.arange(ncz), np.arange(ncy), np.arange(ncx), indexing="ij"
        )
        base = ((p * cz) * ny + p * cy) * nx + p * cx  # node (0,0,0) of each cell
        k, j, i = np.meshgrid(
            np.arange(p + 1), np.arange(p + 1), np.arange(p + 1), indexing="ij"
        )
        local = (k * ny + j) * nx + i  # offset of local node within the lattice
        out = base.reshape(-1, 1) + local.reshape(1, -1)
        if out.max() >= np.iinfo(np.int32).max:
            raise ValueError("mesh too large for int32 gather indices")
        return out.astype(np.int32)

    @cached_property
    def boundary_node_mask(self) -> np.ndarray:
        """(n_nodes,) bool: True where the node lies on the domain boundary.

        With zero Dirichlet values on the whole boundary (benchmark.h:96-102)
        these are exactly the constrained scalar nodes; all components of a
        node are constrained together.
        """
        nz, ny, nx = self.n_nodes_axis
        from mf_data_locality import native
        if native.AVAILABLE:
            return native.boundary_mask(nz, ny, nx)
        m = np.zeros((nz, ny, nx), dtype=bool)
        m[0, :, :] = m[-1, :, :] = True
        m[:, 0, :] = m[:, -1, :] = True
        m[:, :, 0] = m[:, :, -1] = True
        return m.reshape(-1)

    @cached_property
    def node_coords(self) -> np.ndarray:
        """(n_nodes, 3) physical node coordinates (trilinear image of GLL points).

        Needed for manufactured-solution tests and RHS construction; matches
        the FE_Q support points under the trilinear mapping.
        """
        p = self.degree
        gll = quadrature.gll_nodes(p)
        k, j, i = np.meshgrid(gll, gll, gll, indexing="ij")
        uvw = np.stack([i, j, k], axis=-1).reshape(-1, 3)  # local (u,v,w)
        coeffs = trilinear_coefficients(self.mesh.cell_vertices)
        pts = map_points(coeffs[:, None], uvw[None])  # (n_cells, nloc, 3)
        out = np.zeros((self.n_nodes, 3))
        out[self.gather_map.reshape(-1)] = pts.reshape(-1, 3)
        return out

    def lattice_shape(self, n_components: int) -> tuple[int, int, int, int]:
        nz, ny, nx = self.n_nodes_axis
        return (nz, ny, nx, n_components)
