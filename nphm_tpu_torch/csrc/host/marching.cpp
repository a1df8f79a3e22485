// Iso-surface extraction from dense or sparse-block SDF grids via marching
// tetrahedra.
//
// The port's own copy of csrc/marching.cpp (same source, same flags), built
// by nphm_tpu_torch/ops/native.py with the system C++ compiler.
//
// Host-side companion to the grid evaluator: the device produces logits
// for a res^3 lattice (dense) or for the sign-crossing subset of aligned
// blocks (sparse two-pass extraction), this library produces
// (vertices, triangles).
//
// Design notes:
//  - Kuhn 6-tetrahedra cube subdivision around the main diagonal (0 -> 7);
//    identical orientation in every cube makes face diagonals agree between
//    neighbors, so the output is watertight on closed iso-surfaces.
//  - No triangulation lookup tables: tetra cases are enumerated directly
//    (1-inside -> 1 triangle, 2-inside -> quad -> 2 triangles) and each
//    triangle's winding is fixed by a geometric test against the inside /
//    outside centroids.  This removes the classic wrong-table-entry failure
//    mode entirely.
//  - Vertices are deduplicated on GLOBAL grid-edge keys, shared across cubes
//    and across blocks — the sparse path welds block seams for free and
//    yields the same watertight topology as the dense path.
//  - Dense path parallelized over a fixed number of z-bands, sparse path
//    over blocks, each with its own buffer, merged in band / block order;
//    every shared edge's crossing is computed from the same endpoint, so
//    the output is bit-identical run to run, on any core count, and across
//    the dense, window and blocks entries (up to vertex order).
//
// Convention: emits the boundary of {field > iso}.  The Python wrapper
// mirrors the reference pipeline (negated SDF logits at iso 0, see
// reference utils/reconstruction.py:22-37) and rescales vertices to world
// coordinates.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// Kuhn subdivision: 6 tets (0, a, b, 7) where (a, b) walks the edge path
// 1 -> 3 -> 2 -> 6 -> 4 -> 5 -> 1 around the cube. Corner id = 4x + 2y + z.
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

struct Chunk {
  std::vector<float> verts;     // xyz triplets, GLOBAL grid-index coordinates
  std::vector<int64_t> vkeys;   // global edge key per emitted vertex
  std::vector<int64_t> tris;    // indices into the *local* vertex list
};

// A local value array embedded at a global offset of a conceptual
// rx * ry * rz lattice.  Dense extraction uses offset 0 and local == global
// dims; sparse blocks use their own (lx, ly, lz) window.
struct Grid {
  const float* data;            // [lx, ly, lz] C-contiguous local values
  int lx, ly, lz;               // local dims
  int64_t ox, oy, oz;           // global voxel index of local (0, 0, 0)
  int64_t rx, ry, rz;           // global lattice dims (for edge keys)
  float iso;
};

static inline float lval(const Grid& g, int x, int y, int z) {
  return g.data[((int64_t)x * g.ly + y) * g.lz + z];
}

static inline int64_t gkey(const Grid& g, int x, int y, int z) {
  return (((g.ox + x) * g.ry + (g.oy + y)) * g.rz) + (g.oz + z);
}

// Emit one triangle with winding such that its normal points from the
// inside region (field > iso) toward outside.
static inline void emit_tri(Chunk& ch, const V3 p[3], const int64_t key[3],
                            const V3& inward) {
  V3 n = cross(sub(p[1], p[0]), sub(p[2], p[0]));
  int64_t base = (int64_t)ch.vkeys.size();
  int order[3] = {0, 1, 2};
  if (dot(n, inward) > 0.f) {  // normal points toward inside: flip
    order[1] = 2;
    order[2] = 1;
  }
  for (int k = 0; k < 3; ++k) {
    const V3& q = p[order[k]];
    ch.verts.push_back(q.x);
    ch.verts.push_back(q.y);
    ch.verts.push_back(q.z);
    ch.vkeys.push_back(key[order[k]]);
    ch.tris.push_back(base + k);
  }
}

// March the cells [x0, x1) x [y0, y1) x [z0, z1) of ``g`` (local coords);
// cell (x, y, z) spans local voxels (x..x+1, y..y+1, z..z+1).
//
// Hot-path structure: on a res-256 dense grid ~99% of cells have no sign
// change, and the naive reject costs 8 scattered float loads per cell (each
// voxel is re-read by all 8 cells it touches).  Instead we precompute one
// sign byte per voxel per x-plane (a single vectorizable compare pass, each
// voxel loaded once), fold the 4 corner columns of a cell row into or/and
// byte rows, and test ``straddle = (or8 != 0) && (and8 != 1)`` 8 cells at a
// time via word loads.  Cells are still visited in the identical (x, y, z)
// order and re-read their 8 float corners on the slow path, so the emitted
// geometry is bit-identical to the naive loop — this is purely a skip
// accelerator (the host here has one core; see bench host_mc notes).
static void march_cells(const Grid& g, int x0, int x1, int y0, int y1,
                        int z0, int z1, Chunk& ch) {
  const float iso = g.iso;
  // corner offsets by id = 4x+2y+z
  const int off[8][3] = {{0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
                         {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1}};
  const int ny = y1 - y0 + 1;       // voxel rows touched per plane
  const int nz = z1 - z0 + 1;       // voxels per row (cells + 1)
  const size_t plane_sz = (size_t)ny * nz;
  // sign[v > iso] per voxel for plane x and x+1, plus or/and scratch rows
  std::vector<uint8_t> sbuf(2 * plane_sz), orrow(nz), androw(nz),
      strad(nz > 0 ? nz - 1 : 0);
  uint8_t* splane[2] = {sbuf.data(), sbuf.data() + plane_sz};
  auto fill_plane = [&](int x, uint8_t* dst) {
    for (int y = 0; y < ny; ++y) {
      const float* col = g.data + ((int64_t)x * g.ly + (y0 + y)) * g.lz + z0;
      uint8_t* row = dst + (size_t)y * nz;
      for (int z = 0; z < nz; ++z) row[z] = col[z] > iso ? 1 : 0;
    }
  };
  if (x0 < x1) fill_plane(x0, splane[0]);
  for (int x = x0; x < x1; ++x) {
    fill_plane(x + 1, splane[(x - x0 + 1) & 1]);
    const uint8_t* s0 = splane[(x - x0) & 1];
    const uint8_t* s1 = splane[(x - x0 + 1) & 1];
    for (int y = y0; y < y1; ++y) {
      const float* col0 = g.data + ((int64_t)x * g.ly + y) * g.lz;
      const float* col1 = g.data + ((int64_t)x * g.ly + y + 1) * g.lz;
      const float* col2 = g.data + ((int64_t)(x + 1) * g.ly + y) * g.lz;
      const float* col3 = g.data + ((int64_t)(x + 1) * g.ly + y + 1) * g.lz;
      const uint8_t* r00 = s0 + (size_t)(y - y0) * nz;
      const uint8_t* r01 = r00 + nz;
      const uint8_t* r10 = s1 + (size_t)(y - y0) * nz;
      const uint8_t* r11 = r10 + nz;
      for (int z = 0; z < nz; ++z) {
        uint8_t a = r00[z], b = r01[z], c = r10[z], d = r11[z];
        orrow[z] = a | b | c | d;
        androw[z] = a & b & c & d;
      }
      for (int z = 0; z + 1 < nz; ++z)
        strad[z] = (uint8_t)((orrow[z] | orrow[z + 1]) &
                             ((androw[z] & androw[z + 1]) ^ 1));
      for (int zc = 0; zc + 1 < nz; ++zc) {
        // word-level skip over runs of non-straddling cells
        while (zc + 8 <= nz - 1) {
          uint64_t w;
          std::memcpy(&w, &strad[zc], 8);
          if (w) break;
          zc += 8;
        }
        if (zc + 1 >= nz) break;
        if (!strad[zc]) continue;
        const int z = z0 + zc;
        float v[8];
        v[0] = col0[z];     // (0,0,0)
        v[1] = col0[z + 1]; // (0,0,1)
        v[2] = col1[z];     // (0,1,0)
        v[3] = col1[z + 1];
        v[4] = col2[z];     // (1,0,0)
        v[5] = col2[z + 1];
        v[6] = col3[z];     // (1,1,0)
        v[7] = col3[z + 1];

        V3 p[8];
        int64_t gk[8];
        for (int k = 0; k < 8; ++k) {
          p[k] = {(float)(g.ox + x + off[k][0]), (float)(g.oy + y + off[k][1]),
                  (float)(g.oz + z + off[k][2])};
          gk[k] = gkey(g, x + off[k][0], y + off[k][1], z + off[k][2]);
        }

        for (int t = 0; t < 6; ++t) {
          const int* T = kTets[t];
          int inside[4], n_in = 0;
          for (int k = 0; k < 4; ++k)
            if (v[T[k]] > iso) inside[n_in++] = k;
          if (n_in == 0 || n_in == 4) continue;

          // crossing point on tet edge (a_local, b_local), interpolated
          // from the endpoint with the lower global key: every tet sharing
          // the edge computes the same bits, whichever corner it separates
          auto cut = [&](int a, int b, V3& q, int64_t& key) {
            int ga = T[a], gb = T[b];
            if (gk[gb] < gk[ga]) std::swap(ga, gb);
            float va = v[ga], vb = v[gb];
            float tt = (iso - va) / (vb - va);
            if (tt < 0.f) tt = 0.f;
            if (tt > 1.f) tt = 1.f;
            q = {p[ga].x + tt * (p[gb].x - p[ga].x),
                 p[ga].y + tt * (p[gb].y - p[ga].y),
                 p[ga].z + tt * (p[gb].z - p[ga].z)};
            key = gk[ga] * (int64_t)g.rx * g.ry * g.rz + gk[gb];
          };

          // centroid of inside corners (for winding)
          V3 cin = {0, 0, 0}, cout = {0, 0, 0};
          int n_out = 0;
          for (int k = 0; k < 4; ++k) {
            if (v[T[k]] > iso) {
              cin.x += p[T[k]].x; cin.y += p[T[k]].y; cin.z += p[T[k]].z;
            } else {
              cout.x += p[T[k]].x; cout.y += p[T[k]].y; cout.z += p[T[k]].z;
              ++n_out;
            }
          }
          cin.x /= n_in; cin.y /= n_in; cin.z /= n_in;
          cout.x /= n_out; cout.y /= n_out; cout.z /= n_out;
          V3 inward = sub(cin, cout);  // points toward inside

          if (n_in == 1 || n_in == 3) {
            // single separated corner: one triangle on its 3 edges
            int a = -1;
            if (n_in == 1) a = inside[0];
            else {  // single outside corner
              for (int k = 0; k < 4; ++k) {
                bool is_in = false;
                for (int m = 0; m < n_in; ++m) is_in |= (inside[m] == k);
                if (!is_in) { a = k; break; }
              }
            }
            V3 q[3];
            int64_t key[3];
            int j = 0;
            for (int b = 0; b < 4; ++b) {
              if (b == a) continue;
              cut(a, b, q[j], key[j]);
              ++j;
            }
            emit_tri(ch, q, key, inward);
          } else {  // n_in == 2: quad on the 4 cut edges
            int a = inside[0], b = inside[1];
            int others[2], j = 0;
            for (int k = 0; k < 4; ++k)
              if (k != a && k != b) others[j++] = k;
            int cc = others[0], d = others[1];
            V3 q_ac, q_ad, q_bd, q_bc;
            int64_t k_ac, k_ad, k_bd, k_bc;
            cut(a, cc, q_ac, k_ac);
            cut(a, d, q_ad, k_ad);
            cut(b, d, q_bd, k_bd);
            cut(b, cc, q_bc, k_bc);
            // quad cycle q_ac -> q_ad -> q_bd -> q_bc
            {
              V3 tri1[3] = {q_ac, q_ad, q_bd};
              int64_t kk1[3] = {k_ac, k_ad, k_bd};
              emit_tri(ch, tri1, kk1, inward);
              V3 tri2[3] = {q_ac, q_bd, q_bc};
              int64_t kk2[3] = {k_ac, k_bd, k_bc};
              emit_tri(ch, tri2, kk2, inward);
            }
          }
        }
      }
    }
  }
}

// Open-addressing int64 -> int32 map (linear probing, power-of-2 capacity).
// ~4x faster than std::unordered_map on the multi-million-lookup merge of a
// res-256 mesh; keys here are nonnegative edge keys, so -1 marks empty.
struct FlatMap {
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  size_t mask;
  explicit FlatMap(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    keys.assign(cap, -1);
    vals.resize(cap);
    mask = cap - 1;
  }
  // Returns the slot's value reference; *inserted says whether the key was new.
  int32_t& probe(int64_t key, bool* inserted) {
    size_t h = (size_t)((uint64_t)key * 0x9E3779B97F4A7C15ull) & mask;
    for (;;) {
      if (keys[h] == key) { *inserted = false; return vals[h]; }
      if (keys[h] == -1) { keys[h] = key; *inserted = true; return vals[h]; }
      h = (h + 1) & mask;
    }
  }
};

// Merge per-thread chunks with global vertex dedup on edge keys.
// out_keys (optional): the global edge key per emitted vertex, so callers
// marching a PARTIAL lattice window can weld seams against other windows
// exactly (the streamed extractor's slab merge).
static int merge_chunks(std::vector<Chunk>& chunks, float** out_verts,
                        int64_t* n_verts, int32_t** out_faces,
                        int64_t* n_faces, int64_t** out_keys = nullptr) {
  // every emitted vertex may carry a distinct key: size the table from
  // their count (a hard bound), so it can never fill and probe forever
  size_t tot_tris = 0, tot_keys = 0;
  for (auto& ch : chunks) {
    tot_tris += ch.tris.size() / 3;
    tot_keys += ch.vkeys.size();
  }
  FlatMap vmap(tot_keys);

  std::vector<float> verts;
  verts.reserve(tot_tris * 2);
  std::vector<int64_t> keys;
  if (out_keys) keys.reserve(tot_tris / 2 + 16);
  std::vector<int32_t> faces;
  faces.reserve(tot_tris * 3);

  for (auto& ch : chunks) {
    std::vector<int32_t> remap(ch.vkeys.size());
    for (size_t i = 0; i < ch.vkeys.size(); ++i) {
      bool inserted;
      int32_t& slot = vmap.probe(ch.vkeys[i], &inserted);
      if (inserted) {
        int32_t id = (int32_t)(verts.size() / 3);
        slot = id;
        verts.push_back(ch.verts[3 * i]);
        verts.push_back(ch.verts[3 * i + 1]);
        verts.push_back(ch.verts[3 * i + 2]);
        if (out_keys) keys.push_back(ch.vkeys[i]);
        remap[i] = id;
      } else {
        remap[i] = slot;
      }
    }
    for (size_t i = 0; i < ch.tris.size(); i += 3) {
      int32_t a = remap[ch.tris[i]];
      int32_t b = remap[ch.tris[i + 1]];
      int32_t cidx = remap[ch.tris[i + 2]];
      if (a == b || b == cidx || a == cidx) continue;  // degenerate
      faces.push_back(a);
      faces.push_back(b);
      faces.push_back(cidx);
    }
  }

  *n_verts = (int64_t)(verts.size() / 3);
  *n_faces = (int64_t)(faces.size() / 3);
  *out_verts = (float*)std::malloc(verts.size() * sizeof(float));
  *out_faces = (int32_t*)std::malloc(faces.size() * sizeof(int32_t));
  int64_t* kbuf = nullptr;
  bool ok = !(verts.size() && !*out_verts) && !(faces.size() && !*out_faces);
  if (ok && out_keys) {
    kbuf = (int64_t*)std::malloc(keys.size() * sizeof(int64_t));
    ok = !(keys.size() && !kbuf);
  }
  if (!ok) {
    // Python raises on rc!=0 without freeing any out-pointer, so nothing
    // half-allocated may escape — exactly the path where the host is OOM.
    std::free(*out_verts); *out_verts = nullptr;
    std::free(*out_faces); *out_faces = nullptr;
    std::free(kbuf);
    if (out_keys) *out_keys = nullptr;
    return -1;
  }
  // size guards: malloc(0) may return NULL and memcpy args are declared
  // nonnull — an empty mesh must not invoke UB
  if (!verts.empty())
    std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  if (!faces.empty())
    std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int32_t));
  if (out_keys) {
    *out_keys = kbuf;
    if (!keys.empty())
      std::memcpy(*out_keys, keys.data(), keys.size() * sizeof(int64_t));
  }
  return 0;
}

// Clamp owned-cell extents at the global lattice boundary (cells are owned
// by their min corner; a cell starting at or beyond r-1 has no +1 neighbor).
// Returns false when no owned cells remain.  Shared by all three entries so
// the boundary rule can never drift between the dense/window/sparse paths.
bool clamp_owned_cells(const Grid& g, int& cx, int& cy, int& cz) {
  if (g.ox + cx > g.rx - 1) cx = (int)(g.rx - 1 - g.ox);
  if (g.oy + cy > g.ry - 1) cy = (int)(g.ry - 1 - g.oy);
  if (g.oz + cz > g.rz - 1) cz = (int)(g.rz - 1 - g.oz);
  return cx > 0 && cy > 0 && cz > 0;
}

// Worker threads: one per hardware thread, at most `n_jobs`.
int n_workers(int64_t n_jobs) {
  const unsigned hw = std::thread::hardware_concurrency();
  int64_t n = hw ? (int64_t)hw : 4;
  if (n > n_jobs) n = n_jobs;
  return n < 1 ? 1 : (int)n;
}

// Run job(j) for j in [0, n_jobs) on n_workers threads, thread i taking the
// static range of jobs [i * per, (i + 1) * per): each job writes only its
// own output, so the result never depends on the thread count or timing.
template <class Job>
void run_static(int64_t n_jobs, Job job) {
  const int n_threads = n_workers(n_jobs);
  const int64_t per = (n_jobs + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int i = 0; i < n_threads; ++i)
    threads.emplace_back([&, i] {
      for (int64_t j = i * per; j < n_jobs && j < (i + 1) * per; ++j) job(j);
    });
  for (auto& t : threads) t.join();
}

// z-bands of the dense and window entries: a fixed count (not one per
// hardware thread), merged in band order, so the vertex and face order is
// the same on every host.
constexpr int kBands = 16;

// March [0,cx)x[0,cy)x[0,cz) as min(kBands, cz) z-bands, one chunk each.
void march_threaded(const Grid& g, int cx, int cy, int cz,
                    std::vector<Chunk>& chunks) {
  const int n_bands = cz < kBands ? cz : kBands;
  const int per = (cz + n_bands - 1) / n_bands;
  chunks.assign(n_bands, Chunk{});
  run_static(n_bands, [&](int64_t i) {
    const int z0 = (int)i * per;
    const int z1 = z0 + per < cz ? z0 + per : cz;
    if (z0 < z1) march_cells(g, 0, cx, 0, cy, z0, z1, chunks[i]);
  });
}

}  // namespace

extern "C" {

// Returns 0 on success. Caller frees out_verts/out_faces with nphm_free.
// Vertices are in grid-index coordinates (voxel units).
int nphm_marching_tets(const float* grid, int rx, int ry, int rz, float iso,
                       float** out_verts, int64_t* n_verts,
                       int32_t** out_faces, int64_t* n_faces) {
  Grid g{grid, rx, ry, rz, 0, 0, 0, rx, ry, rz, iso};
  std::vector<Chunk> chunks(1);
  int cx = rx - 1, cy = ry - 1, cz = rz - 1;
  if (clamp_owned_cells(g, cx, cy, cz))
    march_threaded(g, cx, cy, cz, chunks);
  return merge_chunks(chunks, out_verts, n_verts, out_faces, n_faces);
}

// Windowed dense marching: march the [lx, ly, lz] local window of a
// conceptual rx * ry * rz lattice whose local (0,0,0) sits at global voxel
// (ox, oy, oz).  Cell coordinates, interpolation, and edge keys are all
// GLOBAL, and ``out_keys`` returns the per-vertex edge key, so disjoint
// windows (e.g. the streamed extractor's x-slabs, each with one +x halo
// plane) weld into exactly the mesh the full dense pass would emit — same
// vertex positions bit-for-bit, no positional dedup needed.
int nphm_marching_tets_window(const float* grid, int lx, int ly, int lz,
                              int64_t ox, int64_t oy, int64_t oz,
                              int64_t rx, int64_t ry, int64_t rz, float iso,
                              float** out_verts, int64_t** out_keys,
                              int64_t* n_verts, int32_t** out_faces,
                              int64_t* n_faces) {
  Grid g{grid, lx, ly, lz, ox, oy, oz, rx, ry, rz, iso};
  int cx = lx - 1, cy = ly - 1, cz = lz - 1;
  if (!clamp_owned_cells(g, cx, cy, cz)) {
    *n_verts = *n_faces = 0;
    *out_verts = nullptr;
    *out_faces = nullptr;
    *out_keys = nullptr;
    return 0;
  }
  std::vector<Chunk> chunks;
  march_threaded(g, cx, cy, cz, chunks);
  return merge_chunks(chunks, out_verts, n_verts, out_faces, n_faces,
                      out_keys);
}

// Sparse-block marching: ``blocks`` is [n_blocks, bsx+1, bsy+1, bsz+1]
// (each block's owned voxels plus a +1 halo plane per axis), ``offsets`` is
// [n_blocks, 3] global voxel origins (multiples of the block shape).  Cells
// are owned by the block containing their min corner; cells at or beyond
// the global lattice boundary (rx, ry, rz) are skipped.  Edge keys are
// global, so vertices on block seams weld exactly and the result matches
// the dense path wherever the dense path would emit geometry.
int nphm_marching_tets_blocks(const float* blocks, const int32_t* offsets,
                              int64_t n_blocks, int bsx, int bsy, int bsz,
                              int64_t rx, int64_t ry, int64_t rz, float iso,
                              float** out_verts, int64_t* n_verts,
                              int32_t** out_faces, int64_t* n_faces) {
  const int lx = bsx + 1, ly = bsy + 1, lz = bsz + 1;
  const int64_t block_sz = (int64_t)lx * ly * lz;

  // one chunk per block, merged in block order: deterministic output
  std::vector<Chunk> chunks(n_blocks > 0 ? n_blocks : 1);
  run_static(n_blocks, [&](int64_t b) {
    Grid g{blocks + b * block_sz, lx, ly, lz,
           offsets[3 * b], offsets[3 * b + 1], offsets[3 * b + 2],
           rx, ry, rz, iso};
    int cx = bsx, cy = bsy, cz = bsz;
    if (clamp_owned_cells(g, cx, cy, cz)) march_cells(g, 0, cx, 0, cy, 0, cz, chunks[b]);
  });
  return merge_chunks(chunks, out_verts, n_verts, out_faces, n_faces);
}

void nphm_free(void* p) { std::free(p); }

}  // extern "C"
