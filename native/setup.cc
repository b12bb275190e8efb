// Native host-side setup runtime for mf_data_locality.
//
// The reference implements its entire host-side setup machinery in C++
// (DoF/index construction: poisson_operator.h:183-267; locality renumbering:
// renumber_dofs_for_mf.h; mesh generation: benchmark.h:66-89 via deal.II).
// This library provides the same capabilities natively for the JAX package:
// the device path consumes precomputed index maps and geometry arrays, and
// this code builds them at C++ speed for large meshes.
//
// Exposed via a plain C ABI consumed through ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Structured gather map: cell-local node -> global lattice node id.
// Mirrors mesh/dofs.py:DofLayout.gather_map (z slowest, x fastest).
// out: int32[ncz*ncy*ncx * (p+1)^3]
// ---------------------------------------------------------------------------
void build_gather_map(int32_t p, int32_t ncz, int32_t ncy, int32_t ncx,
                      int32_t* out) {
  const int64_t ny = (int64_t)p * ncy + 1;
  const int64_t nx = (int64_t)p * ncx + 1;
  const int32_t p1 = p + 1;
  int64_t idx = 0;
  for (int32_t cz = 0; cz < ncz; ++cz)
    for (int32_t cy = 0; cy < ncy; ++cy)
      for (int32_t cx = 0; cx < ncx; ++cx) {
        const int64_t base = ((int64_t)p * cz * ny + (int64_t)p * cy) * nx +
                             (int64_t)p * cx;
        for (int32_t k = 0; k < p1; ++k)
          for (int32_t j = 0; j < p1; ++j)
            for (int32_t i = 0; i < p1; ++i)
              out[idx++] = (int32_t)(base + ((int64_t)k * ny + j) * nx + i);
      }
}

// ---------------------------------------------------------------------------
// Deformed vertex lattice: push_forward of the uniform lattice
// (curved_manifold.h:25-35 capability).  out: double[(ncz+1)(ncy+1)(ncx+1)*3]
// ordered z-slowest, coordinates (x, y, z) interleaved.
// ---------------------------------------------------------------------------
void build_vertex_lattice(int32_t ncz, int32_t ncy, int32_t ncx, double h,
                          double factor, int32_t deformed, double* out) {
  const double pi = 3.14159265358979323846;
  int64_t idx = 0;
  for (int32_t iz = 0; iz <= ncz; ++iz) {
    const double z = h * iz;
    const double sz = std::sin(pi * z);
    for (int32_t iy = 0; iy <= ncy; ++iy) {
      const double y = h * iy;
      const double sy = std::sin(pi * y);
      for (int32_t ix = 0; ix <= ncx; ++ix) {
        const double x = h * ix;
        double d = 0.0;
        if (deformed) d = factor * std::sin(pi * x) * sy * sz;
        out[idx++] = x + d;
        out[idx++] = y + d;
        out[idx++] = z + d;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Trilinear geometry coefficients per cell from the vertex lattice
// (poisson_operator.h:151-179 capability).
// verts: double[(ncz+1)(ncy+1)(ncx+1)*3]; out: double[n_cells*8*3]
// cell order z-slowest; coefficient order [1,u,v,uv,w,uw,vw,uvw].
// ---------------------------------------------------------------------------
void build_trilinear_coefficients(int32_t ncz, int32_t ncy, int32_t ncx,
                                  const double* verts, double* out) {
  const int64_t vy = ncy + 1, vx = ncx + 1;
  auto V = [&](int32_t iz, int32_t iy, int32_t ix, int32_t d) {
    return verts[(((int64_t)iz * vy + iy) * vx + ix) * 3 + d];
  };
  int64_t idx = 0;
  for (int32_t cz = 0; cz < ncz; ++cz)
    for (int32_t cy = 0; cy < ncy; ++cy)
      for (int32_t cx = 0; cx < ncx; ++cx) {
        double v[8][3];
        for (int32_t c = 0; c < 8; ++c) {
          const int32_t dx = c & 1, dy = (c >> 1) & 1, dz = (c >> 2) & 1;
          for (int32_t d = 0; d < 3; ++d)
            v[c][d] = V(cz + dz, cy + dy, cx + dx, d);
        }
        for (int32_t d = 0; d < 3; ++d) {
          out[idx + 0 * 3 + d] = v[0][d];
          out[idx + 1 * 3 + d] = v[1][d] - v[0][d];
          out[idx + 2 * 3 + d] = v[2][d] - v[0][d];
          out[idx + 3 * 3 + d] = v[3][d] - v[2][d] - v[1][d] + v[0][d];
          out[idx + 4 * 3 + d] = v[4][d] - v[0][d];
          out[idx + 5 * 3 + d] = v[5][d] - v[4][d] - v[1][d] + v[0][d];
          out[idx + 6 * 3 + d] = v[6][d] - v[4][d] - v[2][d] + v[0][d];
          out[idx + 7 * 3 + d] = v[7][d] - v[6][d] - v[5][d] + v[4][d] -
                                 v[3][d] + v[2][d] + v[1][d] - v[0][d];
        }
        idx += 24;
      }
}

// ---------------------------------------------------------------------------
// Locality renumbering (renumber_dofs_for_mf.h capability, general meshes):
// given a cell->node gather map in sweep order, produce a permutation
// new_number[node] such that
//   * nodes touched by exactly one cell ("interior") come first, in
//     first-touch sweep order (cell_assembly + first_touch, :247-361,461-474),
//   * then nodes touched by multiple cells, in first-touch order
//     (touch_count grouping, :556-590),
//   * then listed "ghost" nodes (shared with other partitions), grouped by
//     their partition set order (grouping, :492-535).
// gather: int32[n_cells*nloc]; ghost_flags: uint8[n_nodes] (1 = ghost);
// out_perm: int32[n_nodes] (old -> new).  Returns number of interior nodes.
// ---------------------------------------------------------------------------
int64_t renumber_locality(const int32_t* gather, int64_t n_cells, int32_t nloc,
                          int64_t n_nodes, const uint8_t* ghost_flags,
                          int32_t* out_perm) {
  std::vector<int32_t> touch(n_nodes, 0);
  for (int64_t i = 0; i < n_cells * nloc; ++i) touch[gather[i]]++;

  std::vector<int64_t> first_touch(n_nodes, -1);
  int64_t counter = 0;
  for (int64_t i = 0; i < n_cells * nloc; ++i) {
    const int32_t node = gather[i];
    if (first_touch[node] < 0) first_touch[node] = counter++;
  }
  // untouched nodes (not referenced by any cell) go last within their class
  for (int64_t n = 0; n < n_nodes; ++n)
    if (first_touch[n] < 0) first_touch[n] = counter++;

  // stable three-way bucketing by (class, first_touch):
  // class 0: owned, touch == 1; class 1: owned, touch != 1; class 2: ghost
  std::vector<std::pair<int64_t, int64_t>> keys(n_nodes);
  for (int64_t n = 0; n < n_nodes; ++n) {
    int cls = ghost_flags && ghost_flags[n] ? 2 : (touch[n] == 1 ? 0 : 1);
    keys[n] = {((int64_t)cls << 48) | first_touch[n], n};
  }
  std::vector<int64_t> order(n_nodes);
  for (int64_t n = 0; n < n_nodes; ++n) order[n] = n;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return keys[a].first < keys[b].first;
  });
  int64_t n_interior = 0;
  for (int64_t n = 0; n < n_nodes; ++n) {
    out_perm[order[n]] = (int32_t)n;
    if (!(ghost_flags && ghost_flags[order[n]]) && touch[order[n]] == 1)
      ++n_interior;
  }
  return n_interior;
}

// ---------------------------------------------------------------------------
// Boundary mask for the structured lattice (whole-boundary Dirichlet,
// benchmark.h:96-102 capability).  out: uint8[nz*ny*nx].
// ---------------------------------------------------------------------------
void build_boundary_mask(int64_t nz, int64_t ny, int64_t nx, uint8_t* out) {
  std::memset(out, 0, (size_t)(nz * ny * nx));
  for (int64_t iz = 0; iz < nz; ++iz)
    for (int64_t iy = 0; iy < ny; ++iy)
      for (int64_t ix = 0; ix < nx; ++ix)
        if (iz == 0 || iz == nz - 1 || iy == 0 || iy == ny - 1 || ix == 0 ||
            ix == nx - 1)
          out[(iz * ny + iy) * nx + ix] = 1;
}

}  // extern "C"
