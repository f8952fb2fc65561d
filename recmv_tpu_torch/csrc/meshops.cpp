// Copy of recmv_tpu/native/meshops.cpp, kept byte-for-byte apart from this
// note: the port builds its native code from its own sources only.
//
// meshops: native host-side geometry runtime for recmv_tpu.
//
// Replaces the reference's native/C++ geometry dependencies:
//  - marching_cubes: host-side MC for very large inference grids (513^3),
//    the MCGpu role when the volume lives host-side (MCGpu/CudaKernels.cu);
//    uses caller-provided tables (generated in ops/mc_tables.py) so the
//    C++ and JAX paths extract byte-identical meshes.
//  - isotropic_remesh: split/collapse/flip/smooth remeshing, the pymeshlab
//    isotropic remesh role in template registration
//    (engineer/utils/garment_structure.py:402-460).
//
// Exposed via a plain C ABI consumed with ctypes (no pybind11 in image).
// Build: see build_native.sh / native.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Marching cubes
// ---------------------------------------------------------------------------
// vol: (D*H*W) floats, z-major (z,y,x); tri_table: (256*15) int32 local edge
// ids (-1 padded); n_tris: (256) int32. Returns number of verts/faces
// written, or -1 on overflow.

static inline int64_t edge_key(int axis, int64_t z, int64_t y, int64_t x,
                               int64_t H, int64_t W) {
  return (((int64_t)axis * 2049 + z) * 2049 + y) * 2049 + x;
}

int64_t mc_run(const float* vol, int64_t D, int64_t H, int64_t W,
               float level,
               const float* origin, const float* spacing,
               const int32_t* tri_table, const int32_t* n_tris,
               float* out_verts, int64_t max_verts,
               int32_t* out_faces, int64_t max_faces,
               int64_t* out_counts) {
  // corner offsets (x,y,z) matching ops/mc_tables.py CORNERS
  static const int C[8][3] = {{0,0,0},{1,0,0},{1,1,0},{0,1,0},
                              {0,0,1},{1,0,1},{1,1,1},{0,1,1}};
  // edge -> (corner a, corner b)
  static const int E[12][2] = {{0,1},{1,2},{2,3},{3,0},{4,5},{5,6},{6,7},{7,4},
                               {0,4},{1,5},{2,6},{3,7}};
  std::unordered_map<int64_t, int64_t> edge_vert;
  edge_vert.reserve(1 << 16);
  int64_t nv = 0, nf = 0;
  auto V = [&](int64_t z, int64_t y, int64_t x) {
    return vol[(z * H + y) * W + x];
  };
  for (int64_t z = 0; z + 1 < D; ++z)
    for (int64_t y = 0; y + 1 < H; ++y)
      for (int64_t x = 0; x + 1 < W; ++x) {
        int cfg = 0;
        float val[8];
        for (int i = 0; i < 8; ++i) {
          val[i] = V(z + C[i][2], y + C[i][1], x + C[i][0]);
          if (val[i] < level) cfg |= 1 << i;
        }
        int nt = n_tris[cfg];
        if (!nt) continue;
        for (int t = 0; t < nt; ++t) {
          int32_t vid3[3];
          for (int k = 0; k < 3; ++k) {
            int le = tri_table[cfg * 15 + t * 3 + k];
            int a = E[le][0], b = E[le][1];
            // identify the global edge by its lower corner + axis
            int ax = C[a][0] != C[b][0] ? 0 : (C[a][1] != C[b][1] ? 1 : 2);
            int64_t gx = x + std::min(C[a][0], C[b][0]);
            int64_t gy = y + std::min(C[a][1], C[b][1]);
            int64_t gz = z + std::min(C[a][2], C[b][2]);
            int64_t key = edge_key(ax, gz, gy, gx, H, W);
            auto it = edge_vert.find(key);
            if (it != edge_vert.end()) {
              vid3[k] = (int32_t)it->second;
            } else {
              if (nv >= max_verts) return -1;
              float va = val[a], vb = val[b];
              float dn = vb - va;
              float tt = std::fabs(dn) < 1e-12f ? 0.5f : (level - va) / dn;
              tt = std::min(1.f, std::max(0.f, tt));
              float px = (float)C[a][0] + tt * (C[b][0] - C[a][0]) + (float)x;
              float py = (float)C[a][1] + tt * (C[b][1] - C[a][1]) + (float)y;
              float pz = (float)C[a][2] + tt * (C[b][2] - C[a][2]) + (float)z;
              out_verts[nv * 3 + 0] = px * spacing[0] + origin[0];
              out_verts[nv * 3 + 1] = py * spacing[1] + origin[1];
              out_verts[nv * 3 + 2] = pz * spacing[2] + origin[2];
              edge_vert.emplace(key, nv);
              vid3[k] = (int32_t)nv;
              ++nv;
            }
          }
          if (nf >= max_faces) return -1;
          out_faces[nf * 3 + 0] = vid3[0];
          out_faces[nf * 3 + 1] = vid3[1];
          out_faces[nf * 3 + 2] = vid3[2];
          ++nf;
        }
      }
  out_counts[0] = nv;
  out_counts[1] = nf;
  return 0;
}

// ---------------------------------------------------------------------------
// Isotropic remeshing (Botsch-Kobbelt style, simplified)
// ---------------------------------------------------------------------------

struct Mesh {
  std::vector<float> v;       // 3*nv
  std::vector<int32_t> f;     // 3*nf
};

static void collect_edges(const Mesh& m,
                          std::vector<std::pair<int32_t,int32_t>>& edges) {
  edges.clear();
  std::unordered_map<int64_t, char> seen;
  int64_t nf = (int64_t)m.f.size() / 3;
  for (int64_t i = 0; i < nf; ++i) {
    for (int k = 0; k < 3; ++k) {
      int32_t a = m.f[i * 3 + k], b = m.f[i * 3 + (k + 1) % 3];
      int64_t key = ((int64_t)std::min(a,b) << 32) | std::max(a,b);
      if (seen.emplace(key, 1).second) edges.push_back({std::min(a,b), std::max(a,b)});
    }
  }
}

static inline float elen(const Mesh& m, int32_t a, int32_t b) {
  float dx = m.v[a*3]-m.v[b*3], dy = m.v[a*3+1]-m.v[b*3+1], dz = m.v[a*3+2]-m.v[b*3+2];
  return std::sqrt(dx*dx + dy*dy + dz*dz);
}

static void split_long_edges(Mesh& m, float high) {
  std::vector<std::pair<int32_t,int32_t>> edges;
  collect_edges(m, edges);
  std::unordered_map<int64_t, int32_t> mid;
  for (auto& e : edges) {
    if (elen(m, e.first, e.second) > high) {
      int64_t key = ((int64_t)e.first << 32) | e.second;
      int32_t id = (int32_t)(m.v.size() / 3);
      for (int c = 0; c < 3; ++c)
        m.v.push_back(0.5f * (m.v[e.first*3+c] + m.v[e.second*3+c]));
      mid.emplace(key, id);
    }
  }
  if (mid.empty()) return;
  std::vector<int32_t> nfaces;
  int64_t nf = (int64_t)m.f.size() / 3;
  auto midpoint = [&](int32_t a, int32_t b) -> int32_t {
    int64_t key = ((int64_t)std::min(a,b) << 32) | std::max(a,b);
    auto it = mid.find(key);
    return it == mid.end() ? -1 : it->second;
  };
  for (int64_t i = 0; i < nf; ++i) {
    int32_t a = m.f[i*3], b = m.f[i*3+1], c = m.f[i*3+2];
    int32_t mab = midpoint(a,b), mbc = midpoint(b,c), mca = midpoint(c,a);
    int n = (mab>=0) + (mbc>=0) + (mca>=0);
    if (n == 0) { nfaces.insert(nfaces.end(), {a,b,c}); }
    else if (n == 3) {
      nfaces.insert(nfaces.end(), {a,mab,mca, mab,b,mbc, mca,mbc,c, mab,mbc,mca});
    } else if (n == 1) {
      if (mab>=0)      nfaces.insert(nfaces.end(), {a,mab,c, mab,b,c});
      else if (mbc>=0) nfaces.insert(nfaces.end(), {b,mbc,a, mbc,c,a});
      else             nfaces.insert(nfaces.end(), {c,mca,b, mca,a,b});
    } else { // n == 2
      if (mab<0)       nfaces.insert(nfaces.end(), {b,mbc,mca, b,mca,a, mbc,c,mca});
      else if (mbc<0)  nfaces.insert(nfaces.end(), {c,mca,mab, c,mab,b, mca,a,mab});
      else             nfaces.insert(nfaces.end(), {a,mab,mbc, a,mbc,c, mab,b,mbc});
    }
  }
  m.f.swap(nfaces);
}

static void tangential_smooth(Mesh& m, float lam, const std::vector<char>& lock) {
  int64_t nv = (int64_t)m.v.size() / 3;
  std::vector<float> acc(nv * 3, 0.f);
  std::vector<int32_t> deg(nv, 0);
  std::vector<std::pair<int32_t,int32_t>> edges;
  collect_edges(m, edges);
  for (auto& e : edges) {
    for (int c = 0; c < 3; ++c) {
      acc[e.first*3+c]  += m.v[e.second*3+c];
      acc[e.second*3+c] += m.v[e.first*3+c];
    }
    deg[e.first]++; deg[e.second]++;
  }
  for (int64_t i = 0; i < nv; ++i) {
    if (!deg[i] || lock[i]) continue;
    for (int c = 0; c < 3; ++c) {
      float mean = acc[i*3+c] / deg[i];
      m.v[i*3+c] += lam * (mean - m.v[i*3+c]);
    }
  }
}

static void boundary_mask(const Mesh& m, std::vector<char>& lock) {
  int64_t nv = (int64_t)m.v.size() / 3;
  lock.assign(nv, 0);
  std::unordered_map<int64_t, int> cnt;
  int64_t nf = (int64_t)m.f.size() / 3;
  for (int64_t i = 0; i < nf; ++i)
    for (int k = 0; k < 3; ++k) {
      int32_t a = m.f[i*3+k], b = m.f[i*3+(k+1)%3];
      int64_t key = ((int64_t)std::min(a,b) << 32) | std::max(a,b);
      cnt[key]++;
    }
  for (auto& kv : cnt)
    if (kv.second == 1) {
      lock[(int32_t)(kv.first >> 32)] = 1;
      lock[(int32_t)(kv.first & 0xffffffff)] = 1;
    }
}

// --- short-edge collapse (Botsch-Kobbelt "collapse" stage) ----------------
// Collapses edges shorter than `low` to their midpoint, guarded by:
//  * boundary vertices never move (and boundary edges never collapse),
//  * the link condition (the one-rings of the endpoints share exactly the
//    two opposite vertices) so the mesh stays manifold,
//  * no resulting edge may exceed `high` (would immediately re-split).
// One greedy pass per call; endpoints and their one-rings are marked
// "touched" so conflicting collapses wait for the next iteration.
static void collapse_short_edges(Mesh& m, float low, float high) {
  int64_t nv = (int64_t)m.v.size() / 3;
  std::vector<char> lock;
  boundary_mask(m, lock);
  std::vector<std::pair<int32_t,int32_t>> edges;
  collect_edges(m, edges);
  std::vector<std::vector<int32_t>> nbr(nv);
  for (auto& e : edges) {
    nbr[e.first].push_back(e.second);
    nbr[e.second].push_back(e.first);
  }
  std::vector<int32_t> remap(nv);
  for (int64_t i = 0; i < nv; ++i) remap[i] = (int32_t)i;
  std::vector<char> touched(nv, 0);
  int64_t done = 0;
  for (auto& e : edges) {
    int32_t a = e.first, b = e.second;
    if (touched[a] || touched[b] || lock[a] || lock[b]) continue;
    if (elen(m, a, b) >= low) continue;
    // link condition: common one-ring members must be exactly 2
    int common = 0;
    for (int32_t x : nbr[a])
      for (int32_t y : nbr[b])
        if (x == y) ++common;
    if (common != 2) continue;
    // midpoint placement; guard against creating long edges
    float mid[3] = {0.5f * (m.v[a*3] + m.v[b*3]),
                    0.5f * (m.v[a*3+1] + m.v[b*3+1]),
                    0.5f * (m.v[a*3+2] + m.v[b*3+2])};
    bool ok = true;
    for (int side = 0; side < 2 && ok; ++side)
      for (int32_t c : nbr[side ? b : a]) {
        if (c == a || c == b) continue;
        float dx = mid[0]-m.v[c*3], dy = mid[1]-m.v[c*3+1], dz = mid[2]-m.v[c*3+2];
        if (std::sqrt(dx*dx+dy*dy+dz*dz) > high) { ok = false; break; }
      }
    if (!ok) continue;
    for (int c = 0; c < 3; ++c) m.v[a*3+c] = mid[c];
    remap[b] = a;
    touched[a] = touched[b] = 1;
    for (int32_t c : nbr[a]) touched[c] = 1;
    for (int32_t c : nbr[b]) touched[c] = 1;
    ++done;
  }
  if (!done) return;
  // apply remap, drop degenerate faces, compact vertices
  std::vector<int32_t> nfaces;
  nfaces.reserve(m.f.size());
  int64_t nf = (int64_t)m.f.size() / 3;
  for (int64_t i = 0; i < nf; ++i) {
    int32_t a = remap[m.f[i*3]], b = remap[m.f[i*3+1]], c = remap[m.f[i*3+2]];
    if (a == b || b == c || c == a) continue;
    nfaces.insert(nfaces.end(), {a, b, c});
  }
  std::vector<int32_t> newid(nv, -1);
  std::vector<float> nverts;
  nverts.reserve(m.v.size());
  for (size_t i = 0; i < nfaces.size(); ++i) {
    int32_t v = nfaces[i];
    if (newid[v] < 0) {
      newid[v] = (int32_t)(nverts.size() / 3);
      nverts.insert(nverts.end(), {m.v[v*3], m.v[v*3+1], m.v[v*3+2]});
    }
    nfaces[i] = newid[v];
  }
  m.v.swap(nverts);
  m.f.swap(nfaces);
}

// --- valence-optimizing edge flips ----------------------------------------
// Flip an interior edge when it reduces the squared deviation from the
// target valence (6 interior / 4 boundary) of the four incident vertices,
// unless the flipped diagonal already exists or a flipped triangle would
// degenerate.
static void flip_edges(Mesh& m) {
  int64_t nv = (int64_t)m.v.size() / 3;
  int64_t nf = (int64_t)m.f.size() / 3;
  std::vector<char> lock;
  boundary_mask(m, lock);
  std::vector<int32_t> val(nv, 0);
  std::unordered_map<int64_t, std::pair<int32_t,int32_t>> e2f;  // edge -> 2 faces
  std::unordered_map<int64_t, char> eset;
  e2f.reserve(nf * 2);
  auto ekey = [](int32_t a, int32_t b) {
    return ((int64_t)std::min(a,b) << 32) | std::max(a,b);
  };
  for (int64_t i = 0; i < nf; ++i)
    for (int k = 0; k < 3; ++k) {
      int32_t a = m.f[i*3+k], b = m.f[i*3+(k+1)%3];
      int64_t key = ekey(a, b);
      auto it = e2f.find(key);
      if (it == e2f.end()) {
        e2f.emplace(key, std::make_pair((int32_t)i, (int32_t)-1));
        val[a]++; val[b]++;   // count each undirected edge once
      } else if (it->second.second < 0) {
        it->second.second = (int32_t)i;
      } else {
        it->second.second = -2;  // non-manifold: never flip
      }
      eset.emplace(key, 1);
    }
  auto tgt = [&](int32_t v) { return lock[v] ? 4 : 6; };
  auto area2 = [&](int32_t a, int32_t b, int32_t c) {
    float ux = m.v[b*3]-m.v[a*3], uy = m.v[b*3+1]-m.v[a*3+1], uz = m.v[b*3+2]-m.v[a*3+2];
    float vx = m.v[c*3]-m.v[a*3], vy = m.v[c*3+1]-m.v[a*3+1], vz = m.v[c*3+2]-m.v[a*3+2];
    float cx = uy*vz-uz*vy, cy = uz*vx-ux*vz, cz = ux*vy-uy*vx;
    return cx*cx + cy*cy + cz*cz;
  };
  std::vector<char> fdone(nf, 0);
  for (auto& kv : e2f) {
    int32_t f1 = kv.second.first, f2 = kv.second.second;
    if (f2 < 0 || fdone[f1] || fdone[f2]) continue;
    int32_t a = (int32_t)(kv.first >> 32), b = (int32_t)(kv.first & 0xffffffff);
    // opposite vertices
    auto opp = [&](int32_t f) {
      for (int k = 0; k < 3; ++k) {
        int32_t v = m.f[f*3+k];
        if (v != a && v != b) return v;
      }
      return (int32_t)-1;
    };
    int32_t c = opp(f1), d = opp(f2);
    if (c < 0 || d < 0 || c == d) continue;
    if (eset.count(ekey(c, d))) continue;       // diagonal already an edge
    int before = 0, after = 0;
    int32_t vs4[4] = {a, b, c, d};
    int dv[4] = {-1, -1, +1, +1};
    for (int k = 0; k < 4; ++k) {
      int dev0 = val[vs4[k]] - tgt(vs4[k]);
      int dev1 = dev0 + dv[k];
      before += dev0 * dev0;
      after += dev1 * dev1;
    }
    if (after >= before) continue;
    if (val[a] <= 3 || val[b] <= 3) continue;   // keep min valence
    // orientation: find the face holding the DIRECTED edge a->b
    auto has_dir = [&](int32_t f, int32_t u, int32_t v) {
      for (int k = 0; k < 3; ++k)
        if (m.f[f*3+k] == u && m.f[f*3+(k+1)%3] == v) return true;
      return false;
    };
    if (!has_dir(f1, a, b)) std::swap(f1, f2);
    if (!has_dir(f1, a, b) || !has_dir(f2, b, a)) continue;
    c = opp(f1); d = opp(f2);
    // degeneracy guard on the flipped triangles (a,d,c) and (d,b,c)
    float eps = 1e-24f;
    if (area2(a, d, c) < eps || area2(d, b, c) < eps) continue;
    m.f[f1*3] = a; m.f[f1*3+1] = d; m.f[f1*3+2] = c;
    m.f[f2*3] = d; m.f[f2*3+1] = b; m.f[f2*3+2] = c;
    fdone[f1] = fdone[f2] = 1;
    val[a]--; val[b]--; val[c]++; val[d]++;
    eset.erase(ekey(a, b));
    eset.emplace(ekey(c, d), 1);
  }
}

// --- closest-point projection back onto the original surface --------------
// Uniform grid over the input triangles; Ericson closest-point-on-triangle.
struct ProjGrid {
  float o[3]; float cell; int n[3];
  std::vector<std::vector<int32_t>> bins;
  const float* v; const int32_t* f; int64_t nf;
};

static void closest_on_tri(const float* p, const float* A, const float* B,
                           const float* C, float* out) {
  float ab[3], ac[3], ap[3];
  for (int i = 0; i < 3; ++i) { ab[i]=B[i]-A[i]; ac[i]=C[i]-A[i]; ap[i]=p[i]-A[i]; }
  float d1 = ab[0]*ap[0]+ab[1]*ap[1]+ab[2]*ap[2];
  float d2 = ac[0]*ap[0]+ac[1]*ap[1]+ac[2]*ap[2];
  if (d1 <= 0 && d2 <= 0) { std::memcpy(out, A, 12); return; }
  float bp[3]; for (int i = 0; i < 3; ++i) bp[i] = p[i]-B[i];
  float d3 = ab[0]*bp[0]+ab[1]*bp[1]+ab[2]*bp[2];
  float d4 = ac[0]*bp[0]+ac[1]*bp[1]+ac[2]*bp[2];
  if (d3 >= 0 && d4 <= d3) { std::memcpy(out, B, 12); return; }
  float vc = d1*d4 - d3*d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    float t = d1 / (d1 - d3);
    for (int i = 0; i < 3; ++i) out[i] = A[i] + t*ab[i];
    return;
  }
  float cp[3]; for (int i = 0; i < 3; ++i) cp[i] = p[i]-C[i];
  float d5 = ab[0]*cp[0]+ab[1]*cp[1]+ab[2]*cp[2];
  float d6 = ac[0]*cp[0]+ac[1]*cp[1]+ac[2]*cp[2];
  if (d6 >= 0 && d5 <= d6) { std::memcpy(out, C, 12); return; }
  float vb = d5*d2 - d1*d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    float t = d2 / (d2 - d6);
    for (int i = 0; i < 3; ++i) out[i] = A[i] + t*ac[i];
    return;
  }
  float va = d3*d6 - d5*d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    float t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    for (int i = 0; i < 3; ++i) out[i] = B[i] + t*(C[i]-B[i]);
    return;
  }
  float denom = 1.f / (va + vb + vc);
  float s = vb * denom, t = vc * denom;
  for (int i = 0; i < 3; ++i) out[i] = A[i] + s*ab[i] + t*ac[i];
}

static void build_grid(ProjGrid& g, const float* v, const int32_t* f,
                       int64_t nv, int64_t nf, float cell) {
  g.v = v; g.f = f; g.nf = nf; g.cell = cell;
  float lo[3] = {1e30f,1e30f,1e30f}, hi[3] = {-1e30f,-1e30f,-1e30f};
  for (int64_t i = 0; i < nv; ++i)
    for (int c = 0; c < 3; ++c) {
      lo[c] = std::min(lo[c], v[i*3+c]);
      hi[c] = std::max(hi[c], v[i*3+c]);
    }
  for (int c = 0; c < 3; ++c) {
    g.o[c] = lo[c] - cell;
    g.n[c] = std::max(1, (int)((hi[c] - lo[c]) / cell) + 3);
  }
  g.bins.assign((size_t)g.n[0] * g.n[1] * g.n[2], {});
  auto cidx = [&](float x, int c) {
    int i = (int)((x - g.o[c]) / g.cell);
    return std::min(std::max(i, 0), g.n[c] - 1);
  };
  for (int64_t i = 0; i < nf; ++i) {
    float tlo[3] = {1e30f,1e30f,1e30f}, thi[3] = {-1e30f,-1e30f,-1e30f};
    for (int k = 0; k < 3; ++k) {
      const float* p = v + (int64_t)f[i*3+k] * 3;
      for (int c = 0; c < 3; ++c) {
        tlo[c] = std::min(tlo[c], p[c]);
        thi[c] = std::max(thi[c], p[c]);
      }
    }
    int i0[3], i1[3];
    for (int c = 0; c < 3; ++c) { i0[c] = cidx(tlo[c], c); i1[c] = cidx(thi[c], c); }
    for (int x = i0[0]; x <= i1[0]; ++x)
      for (int y = i0[1]; y <= i1[1]; ++y)
        for (int z = i0[2]; z <= i1[2]; ++z)
          g.bins[((size_t)x * g.n[1] + y) * g.n[2] + z].push_back((int32_t)i);
  }
}

// Search rings of cells outward; stop once the best hit is provably
// closer than anything a farther ring could hold.
static bool project_point(const ProjGrid& g, const float* p, float* out,
                          int max_ring = 2) {
  int ci[3];
  for (int c = 0; c < 3; ++c) {
    ci[c] = (int)((p[c] - g.o[c]) / g.cell);
    ci[c] = std::min(std::max(ci[c], 0), g.n[c] - 1);
  }
  float best = 1e30f;
  bool found = false;
  for (int r = 0; r <= max_ring; ++r) {
    if (found && best < (float)r * g.cell * ((float)r * g.cell)) break;
    for (int dx = -r; dx <= r; ++dx)
      for (int dy = -r; dy <= r; ++dy)
        for (int dz = -r; dz <= r; ++dz) {
          if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) != r) continue;
          int x = ci[0]+dx, y = ci[1]+dy, z = ci[2]+dz;
          if (x < 0 || y < 0 || z < 0 || x >= g.n[0] || y >= g.n[1] || z >= g.n[2])
            continue;
          for (int32_t fi : g.bins[((size_t)x * g.n[1] + y) * g.n[2] + z]) {
            float q[3];
            closest_on_tri(p, g.v + (int64_t)g.f[fi*3]*3,
                           g.v + (int64_t)g.f[fi*3+1]*3,
                           g.v + (int64_t)g.f[fi*3+2]*3, q);
            float d = (q[0]-p[0])*(q[0]-p[0]) + (q[1]-p[1])*(q[1]-p[1])
                    + (q[2]-p[2])*(q[2]-p[2]);
            if (d < best) { best = d; std::memcpy(out, q, 12); found = true; }
          }
        }
  }
  return found;
}

int64_t isotropic_remesh(const float* verts, int64_t nv,
                         const int32_t* faces, int64_t nf,
                         float target_len, int32_t iters,
                         float* out_verts, int64_t max_verts,
                         int32_t* out_faces, int64_t max_faces,
                         int64_t* out_counts) {
  Mesh m;
  m.v.assign(verts, verts + nv * 3);
  m.f.assign(faces, faces + nf * 3);
  // reprojection target = the input surface (pymeshlab Reproject flag)
  ProjGrid grid;
  build_grid(grid, verts, faces, nv, nf, std::max(2.f * target_len, 1e-6f));
  const float high = 4.f / 3.f * target_len;
  const float low = 4.f / 5.f * target_len;
  for (int it = 0; it < iters; ++it) {
    split_long_edges(m, high);
    collapse_short_edges(m, low, high);
    flip_edges(m);
    std::vector<char> lock;
    boundary_mask(m, lock);
    tangential_smooth(m, 0.5f, lock);
    int64_t cnv = (int64_t)m.v.size() / 3;
    for (int64_t i = 0; i < cnv; ++i) {
      if (lock[i]) continue;
      float q[3];
      if (project_point(grid, m.v.data() + i * 3, q))
        std::memcpy(m.v.data() + i * 3, q, 12);
    }
    if (cnv > max_verts || (int64_t)m.f.size() / 3 > max_faces)
      return -1;
  }
  out_counts[0] = (int64_t)m.v.size() / 3;
  out_counts[1] = (int64_t)m.f.size() / 3;
  if (out_counts[0] > max_verts || out_counts[1] > max_faces) return -1;
  std::memcpy(out_verts, m.v.data(), m.v.size() * sizeof(float));
  std::memcpy(out_faces, m.f.data(), m.f.size() * sizeof(int32_t));
  return 0;
}

}  // extern "C"
