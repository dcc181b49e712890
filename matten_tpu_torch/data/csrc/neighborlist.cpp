// Periodic radius-graph construction — native host kernel.
//
// Replaces the C core of ASE's primitive_neighbor_list (reference N9,
// data/data.py:365): for every ordered pair (i, j) and periodic image S
// with |pos[j] + S@cell - pos[i]| < r_cut, emit a directed edge. Same-image
// self edges are dropped unless self_interaction; cross-image self edges
// are kept. Called from Python via ctypes (matten_tpu_torch/data/neighborlist.py).
//
// Two passes: count, then fill (caller sizes buffers between passes), or a
// single pass when max_edges is large enough. Complexity is
// O(N^2 * images) — ample for crystal unit cells (the production datasets
// top out near ~50 atoms); a cell-list (spatial binning) path would be the
// next step if thousand-atom cells ever matter.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 matvec_rows(const double* cell, double a, double b, double c) {
  // rows of `cell` are lattice vectors: out = a*cell[0] + b*cell[1] + c*cell[2]
  return {a * cell[0] + b * cell[3] + c * cell[6],
          a * cell[1] + b * cell[4] + c * cell[7],
          a * cell[2] + b * cell[5] + c * cell[8]};
}

inline double det3(const double* m) {
  return m[0] * (m[4] * m[8] - m[5] * m[7]) -
         m[1] * (m[3] * m[8] - m[5] * m[6]) +
         m[2] * (m[3] * m[7] - m[4] * m[6]);
}

inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

inline double norm(const Vec3& a) {
  return std::sqrt(a.x * a.x + a.y * a.y + a.z * a.z);
}

}  // namespace

extern "C" {

// Returns the number of edges found (<= max_edges written), or -1 on a
// singular cell. If the edge count exceeds max_edges, counting continues
// (the return value is the true total) but writes stop — callers retry
// with a larger buffer.
int64_t periodic_neighbors(
    const double* pos,        // [n, 3]
    int64_t n,
    const double* cell,       // [3, 3] rows = lattice vectors
    double r_cut,
    const uint8_t* pbc,       // [3]
    int self_interaction,
    int64_t max_edges,
    int64_t* out_i,           // [max_edges]
    int64_t* out_j,           // [max_edges]
    double* out_shift,        // [max_edges, 3]
    double* out_num_neigh     // [n] (counts for written+unwritten edges)
) {
  const double vol = std::fabs(det3(cell));
  if (vol < 1e-12) return -1;

  Vec3 a0{cell[0], cell[1], cell[2]};
  Vec3 a1{cell[3], cell[4], cell[5]};
  Vec3 a2{cell[6], cell[7], cell[8]};
  Vec3 faces[3] = {cross(a1, a2), cross(a2, a0), cross(a0, a1)};
  int nimg[3];
  for (int k = 0; k < 3; ++k) {
    if (!pbc[k]) {
      nimg[k] = 0;
    } else {
      double spacing = vol / norm(faces[k]);
      nimg[k] = static_cast<int>(std::ceil(r_cut / spacing));
    }
  }

  const double r2 = r_cut * r_cut;
  for (int64_t i = 0; i < n; ++i) out_num_neigh[i] = 0.0;

  int64_t count = 0;
  for (int sx = -nimg[0]; sx <= nimg[0]; ++sx) {
    for (int sy = -nimg[1]; sy <= nimg[1]; ++sy) {
      for (int sz = -nimg[2]; sz <= nimg[2]; ++sz) {
        const bool home = (sx == 0 && sy == 0 && sz == 0);
        const Vec3 disp = matvec_rows(cell, sx, sy, sz);
        for (int64_t i = 0; i < n; ++i) {
          const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
          for (int64_t j = 0; j < n; ++j) {
            if (home && i == j && !self_interaction) continue;
            const double dx = pos[3 * j] + disp.x - xi;
            const double dy = pos[3 * j + 1] + disp.y - yi;
            const double dz = pos[3 * j + 2] + disp.z - zi;
            const double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < r2) {
              if (count < max_edges) {
                out_i[count] = i;
                out_j[count] = j;
                out_shift[3 * count] = sx;
                out_shift[3 * count + 1] = sy;
                out_shift[3 * count + 2] = sz;
              }
              out_num_neigh[i] += 1.0;
              ++count;
            }
          }
        }
      }
    }
  }
  return count;
}

}  // extern "C"
