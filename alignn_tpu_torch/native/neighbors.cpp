// Periodic neighbor search: cell-list algorithm over tiled images.
//
// Native replacement for the host-side graph-construction hot loop.  The
// reference delegates this to jarvis-tools' Python neighbor search /
// torch.cdist supercell tiling (alignn/graphs.py:267-364); this is the
// same geometry — every ordered pair (i, j+image) with
// 0 < |r_j + R - r_i| <= cutoff — implemented with O(N) cell binning
// instead of O(N^2 * images) dense distances.
//
// A copy of alignn_tpu/native/neighbors.cpp, so that both packages give the
// same pairs in the same order.
// Build: g++ -O3 -shared -fPIC -std=c++17, at first use, into
// build/alignn_tpu_torch/ (alignn_tpu_torch/native/__init__.py).
// ABI: plain C, consumed via ctypes (alignn_tpu_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 matvec(const double* m, double a, double b, double c) {
  // row-vector convention: v = [a b c] @ M  (rows of M are lattice vecs)
  return {a * m[0] + b * m[3] + c * m[6],
          a * m[1] + b * m[4] + c * m[7],
          a * m[2] + b * m[5] + c * m[8]};
}

}  // namespace

extern "C" {

// Count-or-fill periodic neighbor pairs.
//
// lattice: [9] row-major (rows = lattice vectors)
// frac:    [n*3] fractional coordinates
// cutoff:  distance cutoff (exclusive of self pairs below `atol`)
// cap:     capacity of the output arrays (pairs); pass 0 to only count
// out_src/out_dst: [cap]
// out_images:      [cap*3] image of dst (integer-valued doubles)
// out_disp:        [cap*3] displacement src -> dst+image (cartesian)
// out_dist:        [cap]
// Returns the total number of pairs found (may exceed cap; caller
// re-invokes with a larger buffer).
int64_t periodic_pairs(const double* lattice, const double* frac,
                       int64_t n, double cutoff, double atol,
                       int64_t cap, int32_t* out_src, int32_t* out_dst,
                       double* out_images, double* out_disp,
                       double* out_dist) {
  if (n <= 0) return 0;
  // image ranges from reciprocal-lattice bound (graphs.py:292-305)
  // recp_len[k] = 2*pi * |row k of inv(lattice)^T| = 2*pi*|col k of inv|
  double a = lattice[0], b = lattice[1], c = lattice[2];
  double d = lattice[3], e = lattice[4], f = lattice[5];
  double g = lattice[6], h = lattice[7], i = lattice[8];
  double det = a * (e * i - f * h) - b * (d * i - f * g) +
               c * (d * h - e * g);
  if (std::fabs(det) < 1e-14) return -1;
  double inv[9] = {(e * i - f * h) / det, (c * h - b * i) / det,
                   (b * f - c * e) / det, (f * g - d * i) / det,
                   (a * i - c * g) / det, (c * d - a * f) / det,
                   (d * h - e * g) / det, (b * g - a * h) / det,
                   (a * e - b * d) / det};
  const double bond_tol = 0.5;
  int64_t maxr[3];
  for (int k = 0; k < 3; ++k) {
    // |column k of inv| = length of reciprocal vector k / (2 pi)
    double len = std::sqrt(inv[k] * inv[k] + inv[3 + k] * inv[3 + k] +
                           inv[6 + k] * inv[6 + k]);
    maxr[k] = (int64_t)std::ceil((cutoff + bond_tol) * len);
  }
  // fractional bounding box of the sites
  double fmin[3] = {1e30, 1e30, 1e30}, fmax[3] = {-1e30, -1e30, -1e30};
  for (int64_t s = 0; s < n; ++s)
    for (int k = 0; k < 3; ++k) {
      double v = frac[s * 3 + k];
      if (v < fmin[k]) fmin[k] = v;
      if (v > fmax[k]) fmax[k] = v;
    }
  int64_t lo[3], hi[3];
  for (int k = 0; k < 3; ++k) {
    lo[k] = (int64_t)std::floor(fmin[k]) - maxr[k];
    hi[k] = (int64_t)std::ceil(fmax[k]) + maxr[k];  // exclusive: < hi
  }

  // expanded point set: all (site, image) with cart coords
  struct Pt {
    double x, y, z;
    int32_t site;
    int32_t ia, ib, ic;
  };
  std::vector<Pt> pts;
  pts.reserve((size_t)n * (hi[0] - lo[0]) * (hi[1] - lo[1]) *
              (hi[2] - lo[2]) / 4 + 16);
  for (int64_t ia = lo[0]; ia < hi[0]; ++ia)
    for (int64_t ib = lo[1]; ib < hi[1]; ++ib)
      for (int64_t ic = lo[2]; ic < hi[2]; ++ic)
        for (int64_t s = 0; s < n; ++s) {
          Vec3 v = matvec(lattice, frac[s * 3] + ia, frac[s * 3 + 1] + ib,
                          frac[s * 3 + 2] + ic);
          pts.push_back({v.x, v.y, v.z, (int32_t)s, (int32_t)ia,
                         (int32_t)ib, (int32_t)ic});
        }

  // bin expanded points into a uniform grid of cell size >= cutoff
  double bxmin = 1e30, bymin = 1e30, bzmin = 1e30;
  double bxmax = -1e30, bymax = -1e30, bzmax = -1e30;
  for (const Pt& p : pts) {
    bxmin = std::min(bxmin, p.x); bxmax = std::max(bxmax, p.x);
    bymin = std::min(bymin, p.y); bymax = std::max(bymax, p.y);
    bzmin = std::min(bzmin, p.z); bzmax = std::max(bzmax, p.z);
  }
  const double cell = cutoff + 1e-9;
  int64_t nx = std::max<int64_t>(1, (int64_t)((bxmax - bxmin) / cell) + 1);
  int64_t ny = std::max<int64_t>(1, (int64_t)((bymax - bymin) / cell) + 1);
  int64_t nz = std::max<int64_t>(1, (int64_t)((bzmax - bzmin) / cell) + 1);
  auto bin_of = [&](const Pt& p) -> int64_t {
    int64_t bx = (int64_t)((p.x - bxmin) / cell);
    int64_t by = (int64_t)((p.y - bymin) / cell);
    int64_t bz = (int64_t)((p.z - bzmin) / cell);
    if (bx >= nx) bx = nx - 1;
    if (by >= ny) by = ny - 1;
    if (bz >= nz) bz = nz - 1;
    return (bx * ny + by) * nz + bz;
  };
  int64_t nbins = nx * ny * nz;
  std::vector<int64_t> counts(nbins + 1, 0);
  for (const Pt& p : pts) counts[bin_of(p) + 1]++;
  for (int64_t t = 0; t < nbins; ++t) counts[t + 1] += counts[t];
  std::vector<int32_t> order(pts.size());
  {
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (size_t t = 0; t < pts.size(); ++t)
      order[cursor[bin_of(pts[t])]++] = (int32_t)t;
  }

  // for each central site (image 0), scan the 27 neighboring bins
  const double cut2 = cutoff * cutoff;
  const double atol2 = atol * atol;
  int64_t total = 0;
  for (int64_t s = 0; s < n; ++s) {
    Vec3 ci = matvec(lattice, frac[s * 3], frac[s * 3 + 1],
                     frac[s * 3 + 2]);
    int64_t bx = (int64_t)((ci.x - bxmin) / cell);
    int64_t by = (int64_t)((ci.y - bymin) / cell);
    int64_t bz = (int64_t)((ci.z - bzmin) / cell);
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          int64_t x = bx + dx, y = by + dy, z = bz + dz;
          if (x < 0 || x >= nx || y < 0 || y >= ny || z < 0 || z >= nz)
            continue;
          int64_t t0 = counts[(x * ny + y) * nz + z];
          int64_t t1 = counts[(x * ny + y) * nz + z + 1];
          for (int64_t t = t0; t < t1; ++t) {
            const Pt& p = pts[order[t]];
            double ddx = p.x - ci.x, ddy = p.y - ci.y, ddz = p.z - ci.z;
            double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 > cut2 || d2 <= atol2) continue;
            if (total < cap) {
              out_src[total] = (int32_t)s;
              out_dst[total] = p.site;
              out_images[total * 3] = p.ia;
              out_images[total * 3 + 1] = p.ib;
              out_images[total * 3 + 2] = p.ic;
              out_disp[total * 3] = ddx;
              out_disp[total * 3 + 1] = ddy;
              out_disp[total * 3 + 2] = ddz;
              out_dist[total] = std::sqrt(d2);
            }
            ++total;
          }
        }
  }
  return total;
}

}  // extern "C"
