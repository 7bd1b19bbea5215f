// Isosurface extraction (marching tetrahedra) — native geometry kernel.
//
// TPU-era replacement for the reference's Cython/C++ marching-cubes stack
// (ONet/im2mesh/utils/libmcubes/marchingcubes.cpp): occupancy values are
// evaluated in large batches on the TPU; this host-side pass turns the
// dense value grid into a triangle mesh. Marching tetrahedra (each cube
// split into 6 tets) yields a watertight isosurface with the same linear
// edge interpolation as marching cubes, without the 256-case tables —
// ~2x triangles, identical surface topology for resampling purposes.
//
// C ABI (ctypes): mt_extract() fills malloc'd buffers, mt_free() releases.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// The 6-tetrahedra decomposition of a cube around the main diagonal 0-7
// (corner indices 0..7 where corner c = (x + dx, y + dy, z + dz), bit
// order dx=4, dy=2, dz=1): one tet {0, a, b, 7} per monotone edge path
// 0 -> a -> b -> 7. Every cube face is split along the diagonal incident
// to corner 0 or 7, which is translation-invariant — adjacent cubes agree
// on shared-face diagonals, so the extracted surface is watertight.
const int kTets[6][4] = {
    {0, 4, 6, 7}, {0, 4, 5, 7}, {0, 2, 6, 7},
    {0, 2, 3, 7}, {0, 1, 5, 7}, {0, 1, 3, 7},
};

const int kCornerOff[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
};

// Every tet edge runs from a corner to one with a superset of its offset
// bits (the tets are monotone 0 -> a -> b -> 7 paths), so edge directions
// have non-negative components and fall into exactly 7 classes: 3 axis
// edges, the 3 face diagonals through corner 0/7, and the body diagonal.
// That makes the edge -> vertex cache a dense [7, nx*ny*nz] int32 array
// keyed by (direction class, lower endpoint) — O(1) lookups instead of a
// hash map, which dominated extraction time at ~1M edges/mesh.
inline int edge_class(int dx, int dy, int dz) {
  // (1,0,0)->0 (0,1,0)->1 (0,0,1)->2 (0,1,1)->3 (1,0,1)->4 (1,1,0)->5
  // (1,1,1)->6
  static const int lut[8] = {-1, 2, 1, 3, 0, 4, 5, 6};
  return lut[(dx << 2) | (dy << 1) | dz];
}

// Dense cache memory is 28 B per grid point regardless of surface size;
// above this limit (scene-scale sliding-window volumes) fall back to the
// surface-proportional hash map.
const size_t kDenseCacheMaxPoints = (size_t)16 << 20;  // 16M pts = 448 MB

struct MeshAccum {
  std::vector<float> verts;    // xyz triples
  std::vector<int64_t> tris;   // index triples
  std::vector<int32_t> edge_cache;  // dense: [7 * npoints], -1 = unset
  std::unordered_map<uint64_t, int64_t> edge_map;  // scene-scale fallback
  size_t npoints = 0;
  bool dense = true;
};

int64_t edge_vertex(MeshAccum* m, const float* vol, int ny, int nz,
                    int ax, int ay, int az, int bx, int by, int bz,
                    float iso) {
  // canonicalize to the non-negative direction (callers pass inside /
  // outside order; monotone edges have all-same-sign deltas)
  if (bx < ax || by < ay || bz < az) {
    std::swap(ax, bx); std::swap(ay, by); std::swap(az, bz);
  }
  size_t ia = ((size_t)ax * ny + ay) * nz + az;
  size_t ib = ((size_t)bx * ny + by) * nz + bz;
  int cls = edge_class(bx - ax, by - ay, bz - az);
  int32_t* slot = nullptr;
  if (m->dense) {
    slot = &m->edge_cache[(size_t)cls * m->npoints + ia];
    if (*slot >= 0) return *slot;
  } else {
    uint64_t key = (uint64_t)cls * m->npoints + ia;
    auto it = m->edge_map.find(key);
    if (it != m->edge_map.end()) return it->second;
  }

  float va = vol[ia], vb = vol[ib];
  float t = (iso - va) / (vb - va);
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  float px = ax + t * (bx - ax);
  float py = ay + t * (by - ay);
  float pz = az + t * (bz - az);
  int64_t idx = (int64_t)(m->verts.size() / 3);
  m->verts.push_back(px);
  m->verts.push_back(py);
  m->verts.push_back(pz);
  if (m->dense) {
    *slot = (int32_t)idx;
  } else {
    m->edge_map.emplace((uint64_t)cls * m->npoints + ia, idx);
  }
  return idx;
}

}  // namespace

extern "C" {

// Extract the iso-surface of a dense [nx, ny, nz] float32 grid (C order).
// Vertices are in grid-index coordinates (vertex v lies between the grid
// points it interpolates). "Inside" means value > iso.
// Returns 0 on success. Caller frees *out_verts / *out_tris via mt_free.
int mt_extract(const float* vol, int nx, int ny, int nz, float iso,
               float** out_verts, int64_t* n_verts,
               int64_t** out_tris, int64_t* n_tris) {
  MeshAccum m;
  m.verts.reserve(1 << 16);
  m.tris.reserve(1 << 16);
  m.npoints = (size_t)nx * ny * nz;
  m.dense = m.npoints <= kDenseCacheMaxPoints;
  if (m.dense) {
    m.edge_cache.assign(7 * m.npoints, -1);
  } else {
    m.edge_map.reserve(1 << 20);
  }

  // byte occupancy mask: the all-in / all-out test for the (overwhelmingly
  // common) empty cube becomes 8 byte loads on 4 row pointers instead of
  // 8 strided float loads + compares
  std::vector<uint8_t> occ(m.npoints);
  for (size_t i = 0; i < m.npoints; ++i) occ[i] = vol[i] > iso;

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
        int cx[8], cy[8], cz[8];
        for (int c = 0; c < 8; ++c) {
          int px = x + kCornerOff[c][0];
          int py = y + kCornerOff[c][1];
          int pz = z + kCornerOff[c][2];
          cx[c] = px; cy[c] = py; cz[c] = pz;
          cv[c] = vol[((size_t)px * ny + py) * nz + pz];
        }

        for (const auto& tet : kTets) {
          int idx[4] = {tet[0], tet[1], tet[2], tet[3]};
          int inside[4], outside[4];
          int nin = 0, nout = 0;
          for (int c = 0; c < 4; ++c) {
            if (cv[idx[c]] > iso) inside[nin++] = idx[c];
            else                  outside[nout++] = idx[c];
          }
          if (nin == 0 || nin == 4) continue;

          auto ev = [&](int a, int b) {
            return edge_vertex(&m, vol, ny, nz, cx[a], cy[a], cz[a],
                               cx[b], cy[b], cz[b], iso);
          };
          // centroid of the inside corners: triangles are oriented so
          // their normal points away from it (outward)
          float gx = 0, gy = 0, gz = 0;
          for (int c = 0; c < nin; ++c) {
            gx += cx[inside[c]]; gy += cy[inside[c]]; gz += cz[inside[c]];
          }
          gx /= nin; gy /= nin; gz /= nin;

          auto emit = [&](int64_t a, int64_t b, int64_t c) {
            const float* va = &m.verts[3 * a];
            const float* vb = &m.verts[3 * b];
            const float* vc = &m.verts[3 * c];
            float ux = vb[0] - va[0], uy = vb[1] - va[1], uz = vb[2] - va[2];
            float wx = vc[0] - va[0], wy = vc[1] - va[1], wz = vc[2] - va[2];
            float nx_ = uy * wz - uz * wy;
            float ny_ = uz * wx - ux * wz;
            float nz_ = ux * wy - uy * wx;
            float dx = gx - va[0], dy = gy - va[1], dz = gz - va[2];
            if (nx_ * dx + ny_ * dy + nz_ * dz > 0) std::swap(b, c);
            m.tris.push_back(a);
            m.tris.push_back(b);
            m.tris.push_back(c);
          };

          if (nin == 1 || nin == 3) {
            // single separated corner -> one triangle on its 3 edges
            int lone = (nin == 1) ? inside[0] : outside[0];
            int others[3];
            int no = 0;
            for (int c = 0; c < 4; ++c)
              if (idx[c] != lone) others[no++] = idx[c];
            emit(ev(lone, others[0]), ev(lone, others[1]),
                 ev(lone, others[2]));
          } else {
            // 2-2 split -> quad e(i0,o0), e(i0,o1), e(i1,o1), e(i1,o0)
            int64_t q0 = ev(inside[0], outside[0]);
            int64_t q1 = ev(inside[0], outside[1]);
            int64_t q2 = ev(inside[1], outside[1]);
            int64_t q3 = ev(inside[1], outside[0]);
            emit(q0, q1, q2);
            emit(q0, q2, q3);
          }
        }
      }
    }
  }

  *n_verts = (int64_t)(m.verts.size() / 3);
  *n_tris = (int64_t)(m.tris.size() / 3);
  *out_verts = (float*)malloc(m.verts.size() * sizeof(float));
  *out_tris = (int64_t*)malloc(m.tris.size() * sizeof(int64_t));
  if ((!*out_verts && !m.verts.empty()) ||
      (!*out_tris && !m.tris.empty()))
    return -1;
  if (!m.verts.empty())
    std::memcpy(*out_verts, m.verts.data(), m.verts.size() * sizeof(float));
  if (!m.tris.empty())
    std::memcpy(*out_tris, m.tris.data(), m.tris.size() * sizeof(int64_t));
  return 0;
}

void mt_free(void* p) { free(p); }

}  // extern "C"
