// Quadric-error-metric mesh simplification — native geometry kernel.
//
// Role of the reference's libsimplify (Fast-Quadric-Mesh-Simplification,
// ONet/im2mesh/utils/libsimplify, used by generation.py:210-213 when
// `simplify_nfaces` is configured): greedy edge collapse ranked by the
// summed vertex quadric error with a per-sweep threshold ramp and a
// triangle-flip guard. Same algorithmic family, written from scratch.
//
// C ABI (ctypes): qem_simplify() fills malloc'd buffers, mt_free() frees
// (shared with isosurface.cpp when linked together; a local free is
// exported as qem_free for standalone builds).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Quadric {
  // symmetric 4x4: stored as 10 coefficients
  double m[10] = {0};
  void add_plane(double a, double b, double c, double d) {
    m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
    m[4] += b * b; m[5] += b * c; m[6] += b * d;
    m[7] += c * c; m[8] += c * d;
    m[9] += d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
  }
  double eval(double x, double y, double z) const {
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z +
           2 * m[3] * x + m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y +
           m[7] * z * z + 2 * m[8] * z + m[9];
  }
};

struct Vec3 {
  double x, y, z;
};

inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline Vec3 sub(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline double norm(const Vec3& a) { return std::sqrt(dot(a, a)); }

}  // namespace

extern "C" {

// Simplify (verts [nv,3] f32, tris [nt,3] i64) toward target_faces.
// Returns 0 on success; outputs are malloc'd (free with qem_free).
int qem_simplify(const float* verts_in, int64_t nv,
                 const int64_t* tris_in, int64_t nt,
                 int64_t target_faces, double aggressiveness,
                 float** out_verts, int64_t* out_nv,
                 int64_t** out_tris, int64_t* out_nt) {
  std::vector<Vec3> V(nv);
  for (int64_t i = 0; i < nv; ++i)
    V[i] = {verts_in[3 * i], verts_in[3 * i + 1], verts_in[3 * i + 2]};
  std::vector<int64_t> T(tris_in, tris_in + 3 * nt);
  std::vector<char> tdel(nt, 0);
  std::vector<Quadric> Q(nv);

  auto tri_plane = [&](int64_t t, double* abcd) -> bool {
    Vec3 a = V[T[3 * t]], b = V[T[3 * t + 1]], c = V[T[3 * t + 2]];
    Vec3 n = cross(sub(b, a), sub(c, a));
    double l = norm(n);
    if (l < 1e-12) return false;
    n = {n.x / l, n.y / l, n.z / l};
    abcd[0] = n.x; abcd[1] = n.y; abcd[2] = n.z;
    abcd[3] = -dot(n, a);
    return true;
  };

  for (int64_t t = 0; t < nt; ++t) {
    double p[4];
    if (tri_plane(t, p))
      for (int k = 0; k < 3; ++k)
        Q[T[3 * t + k]].add_plane(p[0], p[1], p[2], p[3]);
  }

  // vertex -> incident (live) triangles
  std::vector<std::vector<int64_t>> vtris(nv);
  for (int64_t t = 0; t < nt; ++t)
    for (int k = 0; k < 3; ++k) vtris[T[3 * t + k]].push_back(t);

  int64_t live = nt;
  for (int iteration = 0; iteration < 120 && live > target_faces;
       ++iteration) {
    double threshold = 1e-9 * std::pow(double(iteration + 3),
                                       aggressiveness);
    for (int64_t t = 0; t < nt && live > target_faces; ++t) {
      if (tdel[t]) continue;
      for (int e = 0; e < 3 && live > target_faces; ++e) {
        int64_t v0 = T[3 * t + e];
        int64_t v1 = T[3 * t + (e + 1) % 3];
        if (v0 == v1) continue;
        Quadric q = Q[v0];
        q.add(Q[v1]);
        // candidate positions: v0, v1, midpoint — pick lowest error
        Vec3 cand[3] = {V[v0], V[v1],
                        {(V[v0].x + V[v1].x) / 2, (V[v0].y + V[v1].y) / 2,
                         (V[v0].z + V[v1].z) / 2}};
        double best = 1e300;
        Vec3 pos = cand[0];
        for (auto& cd : cand) {
          double err = q.eval(cd.x, cd.y, cd.z);
          if (err < best) { best = err; pos = cd; }
        }
        if (best > threshold) continue;

        // flip guard: no surviving triangle at v0/v1 may invert
        Vec3 old0 = V[v0], old1 = V[v1];
        bool flips = false;
        for (int side = 0; side < 2 && !flips; ++side) {
          int64_t v = side ? v1 : v0;
          for (int64_t it : vtris[v]) {
            if (tdel[it]) continue;
            int64_t a = T[3 * it], b = T[3 * it + 1], c = T[3 * it + 2];
            bool has0 = a == v0 || b == v0 || c == v0;
            bool has1 = a == v1 || b == v1 || c == v1;
            if (has0 && has1) continue;  // will be deleted
            Vec3 pa = V[a], pb = V[b], pc = V[c];
            Vec3 n_before = cross(sub(pb, pa), sub(pc, pa));
            Vec3 qa = (a == v) ? pos : pa;
            Vec3 qb = (b == v) ? pos : pb;
            Vec3 qc = (c == v) ? pos : pc;
            Vec3 n_after = cross(sub(qb, qa), sub(qc, qa));
            if (dot(n_before, n_after) <= 0) { flips = true; break; }
          }
        }
        if (flips) { V[v0] = old0; V[v1] = old1; continue; }

        // collapse v1 -> v0 at pos
        V[v0] = pos;
        Q[v0] = q;
        for (int64_t it : vtris[v1]) {
          if (tdel[it]) continue;
          int64_t* tri = &T[3 * it];
          bool has0 = tri[0] == v0 || tri[1] == v0 || tri[2] == v0;
          for (int k = 0; k < 3; ++k)
            if (tri[k] == v1) tri[k] = v0;
          if (has0) {  // degenerate after merge
            tdel[it] = 1;
            --live;
          } else {
            vtris[v0].push_back(it);
          }
        }
        vtris[v1].clear();
      }
    }
  }

  // compact
  std::vector<int64_t> remap(nv, -1);
  std::vector<float> vo;
  std::vector<int64_t> to;
  for (int64_t t = 0; t < nt; ++t) {
    if (tdel[t]) continue;
    int64_t tri[3];
    for (int k = 0; k < 3; ++k) {
      int64_t v = T[3 * t + k];
      if (remap[v] < 0) {
        remap[v] = (int64_t)(vo.size() / 3);
        vo.push_back((float)V[v].x);
        vo.push_back((float)V[v].y);
        vo.push_back((float)V[v].z);
      }
      tri[k] = remap[v];
    }
    if (tri[0] == tri[1] || tri[1] == tri[2] || tri[0] == tri[2]) continue;
    to.push_back(tri[0]);
    to.push_back(tri[1]);
    to.push_back(tri[2]);
  }

  *out_nv = (int64_t)(vo.size() / 3);
  *out_nt = (int64_t)(to.size() / 3);
  *out_verts = (float*)malloc(vo.size() * sizeof(float));
  *out_tris = (int64_t*)malloc(to.size() * sizeof(int64_t));
  if ((!*out_verts && !vo.empty()) || (!*out_tris && !to.empty()))
    return -1;
  if (!vo.empty())
    std::memcpy(*out_verts, vo.data(), vo.size() * sizeof(float));
  if (!to.empty())
    std::memcpy(*out_tris, to.data(), to.size() * sizeof(int64_t));
  return 0;
}

void qem_free(void* p) { free(p); }

}  // extern "C"
