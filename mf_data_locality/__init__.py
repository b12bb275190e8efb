"""mf_data_locality — a matrix-free finite-element framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the
``peterrum/mf_data_locality`` research code (CEED benchmark BP4: vector-valued
Poisson with matrix-free high-order FEM and data-locality-optimized conjugate
gradient solvers).

Design (re-expressed for XLA, not a translation):

* The reference's SIMD cell batches (``VectorizedArray`` lanes) become the
  vectorized cell axis of batched XLA contractions.
* The reference's compressed gather/scatter (``vector_access_reduced.h``)
  becomes, on the structured benchmark meshes, a *lattice layout*: the DoF
  vector is stored as a 3D node lattice so per-cell extraction is reshapes and
  strided slices — no actual gather/scatter on the hot path.  A general
  gather/segment-sum path covers arbitrary hex meshes.
* The reference's single-MPI-allreduce merged CG (``solver_cg_optimized.h``)
  becomes a single fused jitted iteration body whose 7 reduction scalars are
  one ``psum`` over the device mesh.
* MPI domain decomposition + ghost exchange (deal.II partitioner) becomes
  ``shard_map`` over a ``jax.sharding.Mesh`` with ``ppermute`` halo exchange.
"""

__version__ = "0.1.0"

from mf_data_locality.ops import quadrature, lagrange  # noqa: F401
