// Fine-occupancy-grid assembly — native geometry kernel.
//
// Builds the dense fine grid the isosurface pass consumes: nearest-
// upsampled coarse values (sign-correct away from the surface), exact
// coarse values at shared grid points, and refined values scattered at the
// active-voxel sample points. The numpy version of this (3x np.repeat over
// ~340 MB + a 35M-element fancy scatter) dominated mesh-generation wall
// time on the single host core; this does one fused pass.

#include <cstdint>
#include <cstring>

namespace {

// nearest-upsample coarse into out, exact coarse values at shared points
void upsample_nearest(const float* coarse, int r0, int u, float* out) {
  const int rc = r0 + 1;
  const int rf = r0 * u + 1;
  for (int x = 0; x < rf; ++x) {
    int cx_n = x / u < r0 ? x / u : r0 - 1;
    int cx_e = x / u;                     // exact when x % u == 0
    bool x_exact = (x % u) == 0;
    for (int y = 0; y < rf; ++y) {
      int cy_n = y / u < r0 ? y / u : r0 - 1;
      const float* crow_n = coarse + ((size_t)cx_n * rc + cy_n) * rc;
      float* orow = out + ((size_t)x * rf + y) * rf;
      // run-fill: each coarse z value covers u fine points
      float* o = orow;
      for (int cz = 0; cz < r0; ++cz) {
        float v = crow_n[cz];
        for (int k = 0; k < u; ++k) *o++ = v;
      }
      *o = crow_n[r0 - 1];                // rf-1 = r0*u tail point
      if (x_exact && (y % u) == 0) {
        // overwrite the u-strided points with exact coarse values
        const float* crow_e = coarse + ((size_t)cx_e * rc + y / u) * rc;
        for (int cz = 0; cz <= r0; ++cz) orow[(size_t)cz * u] = crow_e[cz];
      }
    }
  }
}

}  // namespace

extern "C" {

// coarse: [(r0+1)^3] C-order; out: [(r0*u+1)^3] C-order (pre-allocated).
// flat_idx/vals: n refined samples addressed into the fine grid.
void assemble_fine(const float* coarse, int r0, int u,
                   const int64_t* flat_idx, const float* vals, int64_t n,
                   float* out) {
  upsample_nearest(coarse, r0, u, out);
  for (int64_t i = 0; i < n; ++i) out[flat_idx[i]] = vals[i];
}

// Voxel-addressed variant: vox_ids are [n] active coarse-voxel ids
// (flat x*r0^2 + y*r0 + z), vals is [n, (u+1)^3] in ox-oy-oz offset order
// (matching the device eval's meshgrid(indexing='ij') layout). Computes
// all fine-grid addresses internally — the caller never materialises the
// [K, (u+1)^3] int64 index tensor.
void assemble_fine_vox(const float* coarse, int r0, int u,
                       const int64_t* vox_ids, const float* vals,
                       int64_t n, float* out) {
  upsample_nearest(coarse, r0, u, out);
  const int rf = r0 * u + 1;
  const int o3 = (u + 1) * (u + 1) * (u + 1);
  for (int64_t i = 0; i < n; ++i) {
    int64_t vid = vox_ids[i];
    int vx = (int)(vid / ((int64_t)r0 * r0));
    int vy = (int)((vid / r0) % r0);
    int vz = (int)(vid % r0);
    const float* v = vals + i * o3;
    for (int ox = 0; ox <= u; ++ox) {
      for (int oy = 0; oy <= u; ++oy) {
        float* orow = out + ((size_t)(vx * u + ox) * rf
                             + (vy * u + oy)) * rf + vz * u;
        for (int oz = 0; oz <= u; ++oz) orow[oz] = *v++;
      }
    }
  }
}

}  // extern "C"
