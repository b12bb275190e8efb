"""Irregular (non-box) conforming hex meshes for the general backend.

The reference inherits full mesh generality from deal.II/p4est — its mesh
recipe is pluggable (``common_code/benchmark.h:67-89``) and the operator
works on any conforming hex triangulation.  Here the same capability slot is
"any hex mesh expressible as gather maps": the general operator
(:mod:`ops.laplace`) and its distributed decomposition
(:mod:`parallel.dist_general`) consume only

  - ``mesh.cell_vertices`` — (n_cells, 8, 3) corner coordinates in deal.II
    local order (bit0 -> x, bit1 -> y, bit2 -> z),
  - ``gather_map`` — (n_cells, (p+1)^3) int32 cell-to-node map,
  - ``boundary_node_mask`` — (n_nodes,) Dirichlet flags,

so *any* conforming hex mesh fits through :class:`GeneralDofLayout` — this
module provides the container plus a constructor for macro-lattice meshes
(an arbitrary ACTIVE SUBSET of box cells: L-shapes, steps, holes), which is
the honest device-side instance of the deal.II generality the reference leans
on (the numbering problem for fully unstructured hexes — shared-face
orientation matching — is a host-side preprocessing concern, orthogonal to
the device kernels, and the container accepts externally built maps).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


@dataclass(frozen=True)
class GeneralHexMesh:
    """A conforming hex mesh as plain connectivity + coordinates."""

    vertices: np.ndarray  # (n_vertices, 3), coordinates (x, y, z)
    cells: np.ndarray  # (n_cells, 8) int, deal.II local corner order

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @cached_property
    def cell_vertices(self) -> np.ndarray:
        """(n_cells, 8, 3) corner coordinates (the geometry input of
        ``ops.geometry.trilinear_coefficients``)."""
        return np.asarray(self.vertices, np.float64)[self.cells]


@dataclass(frozen=True)
class GeneralDofLayout:
    """Q_p DoF layout on an arbitrary conforming hex mesh.

    Duck-type compatible with :class:`mesh.dofs.DofLayout` for every
    consumer of the general path: ``ops.laplace.make_operator`` /
    ``assemble_dense``, ``ops.diagonal.compute_inverse_diagonal``, and
    ``parallel.dist_general``.  (The structured fast path requires
    the box lattice and do not accept this class.)
    """

    mesh: GeneralHexMesh
    degree: int
    gather_map: np.ndarray  # (n_cells, (p+1)^3) int32
    boundary_node_mask: np.ndarray  # (n_nodes,) bool

    @property
    def n_nodes(self) -> int:
        return self.boundary_node_mask.shape[0]

    @property
    def nodes_per_cell(self) -> int:
        return (self.degree + 1) ** 3


_FACES = (  # (axis, side): axis 0=z, 1=y, 2=x in macro coords
    (0, -1), (0, +1), (1, -1), (1, +1), (2, -1), (2, +1))


def macro_hex_layout(active_cells, degree: int, spacing: float = 1.0,
                     deform=None) -> GeneralDofLayout:
    """Build a :class:`GeneralDofLayout` from an active macro-cell set.

    ``active_cells``: (n_cells, 3) int array of (cz, cy, cx) unit-cell
    positions — any subset of a box lattice (an L-shape, a step, a domain
    with a hole...).  Zero Dirichlet conditions on the whole domain
    boundary (every face not shared by two active cells), matching the BP4
    protocol (``benchmark.h:96-102``).  ``deform``: optional smooth map
    applied to the vertex coordinates, ``(n, 3) -> (n, 3)`` in (x, y, z) —
    geometry may be arbitrarily curved; conformity only needs the
    CONNECTIVITY to be a macro lattice subset.
    """
    cells = np.asarray(active_cells, np.int64)
    if cells.ndim != 2 or cells.shape[1] != 3:
        raise ValueError("active_cells must be (n_cells, 3) (cz, cy, cx)")
    p = degree
    active = {tuple(c) for c in cells.tolist()}
    if len(active) != len(cells):
        raise ValueError("duplicate active cells")

    # --- scalar nodes: union of each cell's (p+1)^3 lattice points -------
    k = np.arange(p + 1)
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    loc = np.stack([kz, ky, kx], axis=-1).reshape(-1, 3)  # (p+1)^3 x 3
    pts = cells[:, None, :] * p + loc[None, :, :]  # (n_cells, nloc, 3)
    flatpts = pts.reshape(-1, 3)
    # lexicographic node numbering, z slowest (the repo convention)
    span = flatpts.max(axis=0) + 1
    keys = (flatpts[:, 0] * span[1] + flatpts[:, 1]) * span[2] + flatpts[:, 2]
    uniq, inv = np.unique(keys, return_inverse=True)
    gather = inv.reshape(len(cells), -1).astype(np.int32)
    n_nodes = uniq.size

    # --- Dirichlet mask: nodes on any neighbor-less face ------------------
    boundary = np.zeros(n_nodes, bool)
    g3 = gather.reshape(len(cells), p + 1, p + 1, p + 1)
    for ci, c in enumerate(cells):
        for axis, side in _FACES:
            nb = c.copy()
            nb[axis] += side
            if tuple(nb) in active:
                continue
            sl = [slice(None)] * 3
            sl[axis] = 0 if side < 0 else p
            boundary[g3[ci][tuple(sl)].reshape(-1)] = True

    # --- vertices / cell connectivity ------------------------------------
    corner = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    # deal.II corner order: v -> (x=v&1, y=v>>1&1, z=v>>2&1); corner rows
    # above are (dz, dy, dx) with dx fastest, i.e. row v = (z=v>>2, y=v>>1&1,
    # x=v&1) — exactly the required order
    cpts = (cells[:, None, :] + corner[None, :, :])  # (n_cells, 8) of (z,y,x)
    cflat = cpts.reshape(-1, 3)
    vspan = cflat.max(axis=0) + 1
    vkeys = (cflat[:, 0] * vspan[1] + cflat[:, 1]) * vspan[2] + cflat[:, 2]
    vuniq, vinv = np.unique(vkeys, return_inverse=True)
    conn = vinv.reshape(len(cells), 8).astype(np.int64)
    vz = vuniq // (vspan[1] * vspan[2])
    vy = (vuniq // vspan[2]) % vspan[1]
    vx = vuniq % vspan[2]
    verts = np.stack([vx, vy, vz], axis=-1).astype(np.float64) * spacing
    if deform is not None:
        verts = np.asarray(deform(verts), np.float64)

    mesh = GeneralHexMesh(vertices=verts, cells=conn)
    return GeneralDofLayout(mesh=mesh, degree=degree, gather_map=gather,
                            boundary_node_mask=boundary)
