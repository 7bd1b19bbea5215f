// Fused isosurface sampling — marching tetrahedra + area-weighted surface
// sampling in ONE host pass, no indexed mesh.
//
// The ONet-Mesh defense only needs N surface SAMPLES per cloud
// (`ONet/remesh_defense.py:151-171`: mesh -> trimesh.sample 1024), not the
// mesh itself. Building the indexed mesh (isosurface.cpp) spends most of
// its time on the vertex-dedup edge cache (60 MB memset + cache-missy
// lookups per 128^3 grid) and the Python side then re-derives triangle
// areas over ~800k triangles just to draw 1024 samples. This kernel emits
// a triangle SOUP with running area prefix sums and samples directly:
// one pass over the grid, no dedup, no index buffers, no numpy.
//
// Identical surface geometry to mt_extract (same 6-tet decomposition,
// same edge interpolation/clamp); only vertex identity/orientation is
// dropped — irrelevant for area-weighted point sampling.
//
// The int8 variant marches the quantised logit grid (generation.py
// quantize_wire_int8) directly: q-space is an affine map of logit space
// with iso at 0, so crossing tests (q > 0) and linear interpolation give
// the SAME vertices as dequantise-then-march — and the host never
// materialises the 4x larger float grid.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kTets[6][4] = {
    {0, 4, 6, 7}, {0, 4, 5, 7}, {0, 2, 6, 7},
    {0, 2, 3, 7}, {0, 1, 5, 7}, {0, 1, 3, 7},
};

const int kCornerOff[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
};

// splitmix64 -> uniform double in [0, 1)
inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}
inline double uniform01(uint64_t* s) {
  return (double)(splitmix64(s) >> 11) * 0x1.0p-53;
}

struct Soup {
  std::vector<float> tri;      // 9 floats per triangle (v0 v1 v2)
  std::vector<double> cum;     // cumulative area
  double total = 0.0;
};

template <typename T>
void gather_soup(const T* vol, int nx, int ny, int nz, float iso,
                 Soup* soup) {
  size_t npts = (size_t)nx * ny * nz;
  std::vector<uint8_t> occ(npts);
  for (size_t i = 0; i < npts; ++i) occ[i] = (float)vol[i] > iso;

  float vx[3], vy[3], vz[3];  // scratch triangle
  auto push_tri = [&]() {
    float ux = vx[1] - vx[0], uy = vy[1] - vy[0], uz = vz[1] - vz[0];
    float wx = vx[2] - vx[0], wy = vy[2] - vy[0], wz = vz[2] - vz[0];
    float cx = uy * wz - uz * wy;
    float cy = uz * wx - ux * wz;
    float cz = ux * wy - uy * wx;
    double area = 0.5 * std::sqrt((double)cx * cx + (double)cy * cy +
                                  (double)cz * cz);
    soup->total += area;
    soup->cum.push_back(soup->total);
    for (int k = 0; k < 3; ++k) {
      soup->tri.push_back(vx[k]);
      soup->tri.push_back(vy[k]);
      soup->tri.push_back(vz[k]);
    }
  };

  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      const uint8_t* r00 = &occ[((size_t)x * ny + y) * nz];
      const uint8_t* r01 = r00 + nz;
      const uint8_t* r10 = r00 + (size_t)ny * nz;
      const uint8_t* r11 = r10 + nz;
      for (int z = 0; z + 1 < nz; ++z) {
        int in_cnt = r00[z] + r00[z + 1] + r01[z] + r01[z + 1]
                   + r10[z] + r10[z + 1] + r11[z] + r11[z + 1];
        if (in_cnt == 0 || in_cnt == 8) continue;

        float cv[8];
        float cx[8], cy[8], cz[8];
        for (int c = 0; c < 8; ++c) {
          int px = x + kCornerOff[c][0];
          int py = y + kCornerOff[c][1];
          int pz = z + kCornerOff[c][2];
          cx[c] = (float)px; cy[c] = (float)py; cz[c] = (float)pz;
          cv[c] = (float)vol[((size_t)px * ny + py) * nz + pz];
        }

        // edge crossing point, same interpolation/clamp as mt_extract
        auto ev = [&](int a, int b, int slot) {
          float va = cv[a], vb = cv[b];
          float t = (iso - va) / (vb - va);
          if (t < 0.f) t = 0.f;
          if (t > 1.f) t = 1.f;
          vx[slot] = cx[a] + t * (cx[b] - cx[a]);
          vy[slot] = cy[a] + t * (cy[b] - cy[a]);
          vz[slot] = cz[a] + t * (cz[b] - cz[a]);
        };

        for (const auto& tet : kTets) {
          int inside[4], outside[4];
          int nin = 0, nout = 0;
          for (int c = 0; c < 4; ++c) {
            if (cv[tet[c]] > iso) inside[nin++] = tet[c];
            else                  outside[nout++] = tet[c];
          }
          if (nin == 0 || nin == 4) continue;

          if (nin == 1 || nin == 3) {
            int lone = (nin == 1) ? inside[0] : outside[0];
            int others[3];
            int no = 0;
            for (int c = 0; c < 4; ++c)
              if (tet[c] != lone) others[no++] = tet[c];
            ev(lone, others[0], 0);
            ev(lone, others[1], 1);
            ev(lone, others[2], 2);
            push_tri();
          } else {
            // 2-2 split -> quad as two triangles
            float qx[4], qy[4], qz[4];
            int pairs[4][2] = {{inside[0], outside[0]},
                               {inside[0], outside[1]},
                               {inside[1], outside[1]},
                               {inside[1], outside[0]}};
            for (int k = 0; k < 4; ++k) {
              ev(pairs[k][0], pairs[k][1], 0);
              qx[k] = vx[0]; qy[k] = vy[0]; qz[k] = vz[0];
            }
            vx[0] = qx[0]; vy[0] = qy[0]; vz[0] = qz[0];
            vx[1] = qx[1]; vy[1] = qy[1]; vz[1] = qz[1];
            vx[2] = qx[2]; vy[2] = qy[2]; vz[2] = qz[2];
            push_tri();
            vx[1] = qx[2]; vy[1] = qy[2]; vz[1] = qz[2];
            vx[2] = qx[3]; vy[2] = qy[3]; vz[2] = qz[3];
            push_tri();
          }
        }
      }
    }
  }
}

int sample_soup(const Soup& soup, int64_t n_samples, uint64_t seed,
                float* out_pts) {
  if (soup.cum.empty() || !(soup.total > 0.0) ||
      !std::isfinite(soup.total))
    return 1;  // degenerate: caller falls back (remesh_defense.py:159-170)
  uint64_t s = seed * 0x9e3779b97f4a7c15ull + 0x243f6a8885a308d3ull;
  int64_t ntri = (int64_t)soup.cum.size();
  for (int64_t i = 0; i < n_samples; ++i) {
    double u = uniform01(&s) * soup.total;
    // binary search the cumulative areas
    int64_t lo = 0, hi = ntri - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (soup.cum[mid] <= u) lo = mid + 1;
      else hi = mid;
    }
    const float* t = &soup.tri[9 * lo];
    // uniform barycentric (sqrt trick)
    double r1 = std::sqrt(uniform01(&s));
    double r2 = uniform01(&s);
    double a = 1.0 - r1, b = r1 * (1.0 - r2), c = r1 * r2;
    out_pts[3 * i + 0] = (float)(a * t[0] + b * t[3] + c * t[6]);
    out_pts[3 * i + 1] = (float)(a * t[1] + b * t[4] + c * t[7]);
    out_pts[3 * i + 2] = (float)(a * t[2] + b * t[5] + c * t[8]);
  }
  return 0;
}

}  // namespace

extern "C" {

// Sample n area-weighted surface points of the iso-surface of a dense
// float32 grid. out_pts: caller-allocated [n_samples * 3], grid-index
// coordinates. Returns 0 on success, 1 if the surface is empty/degenerate
// (caller applies its fallback). out_area (optional) gets the total area.
int mt_sample_f32(const float* vol, int nx, int ny, int nz, float iso,
                  int64_t n_samples, uint64_t seed, float* out_pts,
                  double* out_area) {
  Soup soup;
  soup.tri.reserve(1 << 18);
  soup.cum.reserve(1 << 16);
  gather_soup(vol, nx, ny, nz, iso, &soup);
  if (out_area) *out_area = soup.total;
  return sample_soup(soup, n_samples, seed, out_pts);
}

// Same on the int8 QUANTISED logit grid (quantize_wire_int8: away-from-
// zero rounding, iso at q == 0) — no host-side dequantise pass.
int mt_sample_i8(const int8_t* vol, int nx, int ny, int nz,
                 int64_t n_samples, uint64_t seed, float* out_pts,
                 double* out_area) {
  Soup soup;
  soup.tri.reserve(1 << 18);
  soup.cum.reserve(1 << 16);
  gather_soup(vol, nx, ny, nz, 0.0f, &soup);
  if (out_area) *out_area = soup.total;
  return sample_soup(soup, n_samples, seed, out_pts);
}

}  // extern "C"
