"""CEED benchmark problem BP4: 3-component vector Poisson.

The flagship "model" of the framework — assembles mesh, DoF layout, operator,
node-blocked Jacobi preconditioner and the synthetic right-hand side into one
solvable problem, mirroring the reference harness setup
(``common_code/benchmark.h:50-176``):

* FE_Q(p)^3 on the sine-deformed box with 2**s cells, zero Dirichlet
  boundary values, Gauss(p+2) integration;
* preconditioner from the GLL(p+1) operator diagonal, one scalar per node;
* RHS value ``dof_index % 8`` on unconstrained DoFs (``benchmark.h:170-176``)
  with the node-major, component-interleaved index convention.

Two interchangeable operator backends:

* ``"structured"`` (default) — the lattice layout with zero gather/scatter
  (:mod:`~mf_data_locality.ops.laplace_structured`); vectors are
  (C, Nz, Ny, Nx).
* ``"general"`` — gather/scatter-add for arbitrary hex meshes
  (:mod:`~mf_data_locality.ops.laplace`); vectors are (C, n_nodes).

BP4 per the CEED definition pairs with BP3's q = p + 2 rule; scalar variants
(BP1/BP3 analogues) are available via ``n_components=1``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from mf_data_locality.mesh.box import BoxMesh
from mf_data_locality.mesh.dofs import DofLayout
from mf_data_locality.ops import diagonal, laplace, laplace_structured
from mf_data_locality.solvers import cg, cg_merged


@dataclass(frozen=True)
class BP4Problem:
    layout: DofLayout
    op: Any  # LaplaceOperatorData | StructuredOperatorData
    inv_diag: jax.Array  # broadcastable against b
    b: jax.Array  # (C, n_nodes) or (C, Nz, Ny, Nx)
    n_components: int
    backend: str

    @property
    def n_dofs(self) -> int:
        return self.layout.n_nodes * self.n_components

    def _wrap(self, constrained_identity: bool) -> Callable[[jax.Array], jax.Array]:
        fn = partial(_VMULT[self.backend], self.op,
                     constrained_identity=constrained_identity)
        if self.backend == "general":
            return fn
        # lattice backend: solver vectors stay flat (C, n_nodes), the layout
        # both backends share; the reshape to the lattice happens only inside
        # the operator (a free relayout under fusion)
        lat = (self.n_components,) + self.layout.n_nodes_axis

        def apply_flat(u):
            return fn(u.reshape(lat)).reshape(u.shape)

        return apply_flat

    @property
    def a_apply(self) -> Callable[[jax.Array], jax.Array]:
        """Operator application without constrained identity (merged-CG form)."""
        return self._wrap(False)

    @property
    def a_apply_full(self) -> Callable[[jax.Array], jax.Array]:
        """Operator with constrained identity (reference vmult semantics)."""
        return self._wrap(True)


_VMULT = {
    "structured": laplace_structured.vmult,
    "general": laplace.vmult,
}


def build(s: int, degree: int, dtype=jnp.float32, n_components: int = 3,
          n_q: int | None = None, backend: str = "structured") -> BP4Problem:
    if backend not in _VMULT:
        raise ValueError(f"unknown backend {backend!r}")
    layout = DofLayout(BoxMesh.from_s(s), degree)

    # RHS: dof % 8 on unconstrained DoFs, components interleaved per node.
    # NOTE: the %8 pattern is applied in THIS framework's numbering
    # (node-major lattice order, components interleaved per node), while the
    # reference fills i % 8 over its rank-local renumbered ordering
    # (benchmark.h:170-176) — same protocol, different permutation of the
    # values, so itCG can differ slightly from published reference logs.
    n = layout.n_nodes
    dof_index = (np.arange(n)[:, None] * n_components
                 + np.arange(n_components)[None, :])
    b = (dof_index % 8).astype(np.float64)
    b[layout.boundary_node_mask] = 0.0
    b = b.T  # (C, n_nodes)

    inv_diag = jnp.asarray(diagonal.compute_inverse_diagonal(layout, dtype=dtype))
    if backend == "structured":
        op = laplace_structured.make_structured_operator(layout, n_q=n_q,
                                                         dtype=dtype)
    else:
        op = laplace.make_operator(layout, n_q=n_q, dtype=dtype)
    return BP4Problem(layout, op, inv_diag[None, :],
                      jnp.asarray(b, dtype=dtype), n_components, backend)


def solve_baseline(problem: BP4Problem, max_iter: int = 100,
                   rel_tol: float = 1e-8) -> cg.SolveResult:
    """Textbook PCG with full vmult (constrained identity), as bench_precond."""
    return cg.cg_solve(problem.a_apply_full, problem.b, problem.inv_diag,
                       max_iter=max_iter, rel_tol=rel_tol)


def solve_merged(problem: BP4Problem, max_iter: int = 100,
                 rel_tol: float = 1e-8) -> cg.SolveResult:
    """Fully-merged CG; operator applied without the constrained-identity
    fixup, exactly like ``vmult_with_merged_sums`` (poisson_operator.h:327-377)."""
    return cg_merged.merged_cg_solve(problem.a_apply, problem.b,
                                     problem.inv_diag, max_iter=max_iter,
                                     rel_tol=rel_tol)
