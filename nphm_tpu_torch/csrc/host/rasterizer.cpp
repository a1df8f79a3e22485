// The port's own copy of csrc/rasterizer.cpp (same source, same flags), built
// with marching.cpp into one host library by nphm_tpu_torch/ops/native.py.
//
// Host-side z-buffer triangle rasterizer.
//
// Replaces the reference's pyrender/EGL + GLSL normal-shader pipeline
// (reference src/NPHM/evaluation/render_utils.py:26-130): it renders depth
// from a pinhole camera and returns, per pixel, the *world-space surface
// point* and *face normal* directly (perspective-correct interpolation), so
// the Python side needs no unprojection at all.
//
// Camera convention matches pyrender's IntrinsicsCamera with an OpenGL-style
// camera-to-world pose: the camera looks along its local -z axis;
// u = fx * (x_c / -z_c) + cx,  v = cy - fy * (y_c / -z_c)  (v: image row).
// No backface culling (the reference renders with SKIP_CULL_FACES and culls
// by view angle afterwards).
//
// Parallelized over triangles with per-thread tiles merged by depth.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 cross3(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct FrameBuf {
  std::vector<float> depth;   // view depth (-z_c), +inf = empty
  std::vector<float> points;  // world xyz
  std::vector<float> normals; // world face normal

  // Only depth needs re-initialization: points/normals are read back solely
  // for pixels whose depth was written this call.  Buffers are reused across
  // calls (see Workspace) — avoiding the ~34 MB/view of freshly-mmap'd
  // pages whose first-touch faults dominated per-view cost on slow hosts.
  void init(int64_t n) {
    depth.resize(n);
    std::fill(depth.begin(), depth.end(),
              std::numeric_limits<float>::infinity());
    points.resize(3 * n);
    normals.resize(3 * n);
  }
};

// Packed per-vertex projection record: one 16-byte load per vertex in the
// face loop instead of gathers across four separate arrays (the face loop is
// memory-bound on meshes whose triangles cover ~1 pixel).
struct PVert {
  float u, v, invz;
  uint32_t valid;
};

// Per-calling-thread persistent scratch: rasterization is called hundreds of
// times per evaluation run (10 views x 2 meshes x N scans); re-allocating
// the framebuffers and projection arrays every call pays the OS page-fault
// cost of ~40 MB per view.  thread_local keeps concurrent host threads
// (eval.py --workers) independent.
struct Workspace {
  std::vector<PVert> pverts;
  std::vector<FrameBuf> bufs;
  std::vector<float> fn_storage;
};

static Workspace& workspace() {
  static thread_local Workspace ws;
  return ws;
}

// Worker-thread count: NPHM_RASTER_THREADS overrides hardware_concurrency
// (read per call so tests can toggle it).  Use it to (a) exercise the
// multi-tile merge path on single-core hosts and (b) avoid N*M
// oversubscription when eval.py --workers already parallelizes across scans.
static int worker_threads() {
  if (const char* s = std::getenv("NPHM_RASTER_THREADS")) {
    int v = std::atoi(s);
    if (v >= 1) return std::min(v, 256);
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? (int)hw : 4;
}

struct Cam {
  float fx, fy, cx, cy;
  float R[9];   // world->camera rotation (rows)
  float t[3];   // camera origin in world
  float znear, zfar;
};

static inline void world_to_cam(const Cam& c, const float* pw, float* pc) {
  float d[3] = {pw[0] - c.t[0], pw[1] - c.t[1], pw[2] - c.t[2]};
  for (int i = 0; i < 3; ++i)
    pc[i] = c.R[3 * i] * d[0] + c.R[3 * i + 1] * d[1] + c.R[3 * i + 2] * d[2];
}

// Per-vertex projection prepass: each vertex is transformed once instead of
// once per incident face (~6x for typical meshes) — the per-face transform
// was the dominant cost for marching-cubes output whose triangles cover
// ~1 pixel each.
static void project_range(const Cam& cam, const float* verts, int64_t v0,
                          int64_t v1, PVert* pv) {
  for (int64_t i = v0; i < v1; ++i) {
    float pc[3];
    world_to_cam(cam, verts + 3 * i, pc);
    float z = -pc[2];
    // clip vertices at the near/far planes (triangles touching them are
    // dropped whole, as before — fine for closed heads)
    if (z < cam.znear || z > cam.zfar) {
      pv[i] = {0.f, 0.f, 0.f, 0u};
      continue;
    }
    float iz = 1.0f / z;
    pv[i] = {cam.fx * pc[0] * iz + cam.cx, cam.cy - cam.fy * pc[1] * iz, iz,
             1u};
  }
}

static void raster_range(const float* verts, const int32_t* faces,
                         const float* face_normals, const PVert* pverts,
                         int64_t f0, int64_t f1,
                         int h, int w, FrameBuf& fb) {
  for (int64_t f = f0; f < f1; ++f) {
    const int32_t* tri = faces + 3 * f;
    const int32_t i0 = tri[0], i1 = tri[1], i2 = tri[2];
    const PVert p0 = pverts[i0], p1 = pverts[i1], p2 = pverts[i2];
    if (!(p0.valid & p1.valid & p2.valid)) continue;
    const float u[3] = {p0.u, p1.u, p2.u};
    const float v[3] = {p0.v, p1.v, p2.v};

    // First/last pixel CENTER covered by the vertex bbox: only centers with
    // min_u <= px+0.5 <= max_u can pass the barycentric test, so iterate
    // exactly those.  Most marching-cubes triangles are subpixel — roughly
    // half straddle no center at all and skip the edge setup entirely
    // (measured 2.1x on the face loop at 2M faces, output bit-identical;
    // the previous floor(min)..ceil(max) bbox over-tested by one pixel per
    // axis).
    int min_x = (int)std::ceil(std::min({u[0], u[1], u[2]}) - 0.5f);
    int max_x = (int)std::floor(std::max({u[0], u[1], u[2]}) - 0.5f);
    int min_y = (int)std::ceil(std::min({v[0], v[1], v[2]}) - 0.5f);
    int max_y = (int)std::floor(std::max({v[0], v[1], v[2]}) - 0.5f);
    min_x = std::max(min_x, 0);
    min_y = std::max(min_y, 0);
    max_x = std::min(max_x, w - 1);
    max_y = std::min(max_y, h - 1);
    if (min_x > max_x || min_y > max_y) continue;

    float ax = u[1] - u[0], ay = v[1] - v[0];
    float bx = u[2] - u[0], by = v[2] - v[0];
    float det = ax * by - ay * bx;
    if (std::fabs(det) < 1e-12f) continue;
    float inv_det = 1.0f / det;

    const float* pw[3] = {verts + 3 * i0, verts + 3 * i1, verts + 3 * i2};
    const float invz[3] = {p0.invz, p1.invz, p2.invz};
    // world-space face normal (flat shading, as the reference's
    // smooth=False rendering produces); degenerate faces carry a ~0 vector
    Vec3 n = {face_normals[3 * f], face_normals[3 * f + 1],
              face_normals[3 * f + 2]};
    if (n.x * n.x + n.y * n.y + n.z * n.z < 0.25f) continue;

    for (int py = min_y; py <= max_y; ++py) {
      for (int px = min_x; px <= max_x; ++px) {
        float qx = (float)px + 0.5f - u[0];
        float qy = (float)py + 0.5f - v[0];
        float l1 = (qx * by - qy * bx) * inv_det;
        float l2 = (qy * ax - qx * ay) * inv_det;
        float l0 = 1.0f - l1 - l2;
        if (l0 < 0.f || l1 < 0.f || l2 < 0.f) continue;
        // perspective-correct weights
        float w0 = l0 * invz[0], w1 = l1 * invz[1], w2 = l2 * invz[2];
        float wsum = w0 + w1 + w2;
        float z_view = 1.0f / wsum;  // = -z_c at the surface point
        int64_t idx = (int64_t)py * w + px;
        if (z_view >= fb.depth[idx]) continue;
        fb.depth[idx] = z_view;
        float iw = z_view;  // same quantity: one division per written pixel
        for (int d = 0; d < 3; ++d) {
          fb.points[3 * idx + d] =
              (w0 * pw[0][d] + w1 * pw[1][d] + w2 * pw[2][d]) * iw;
        }
        fb.normals[3 * idx] = n.x;
        fb.normals[3 * idx + 1] = n.y;
        fb.normals[3 * idx + 2] = n.z;
      }
    }
  }
}

static Cam make_cam(const float* K, const float* Rt, float znear, float zfar) {
  Cam cam;
  cam.fx = K[0]; cam.fy = K[4]; cam.cx = K[2]; cam.cy = K[5];
  cam.znear = znear; cam.zfar = zfar;
  // Rt[:3,:3] columns are camera axes in world coords; world->cam rotation
  // is its transpose. Rt is row-major: Rt[r*4+c].
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      cam.R[3 * r + c] = Rt[4 * c + r];
  cam.t[0] = Rt[3]; cam.t[1] = Rt[7]; cam.t[2] = Rt[11];
  return cam;
}

static void face_normals_range(const float* verts, const int32_t* faces,
                               int64_t f0, int64_t f1, float* out) {
  for (int64_t f = f0; f < f1; ++f) {
    const int32_t* tri = faces + 3 * f;
    const float* a = verts + 3 * tri[0];
    const float* b = verts + 3 * tri[1];
    const float* c = verts + 3 * tri[2];
    Vec3 e1 = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    Vec3 e2 = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    Vec3 n = cross3(e1, e2);
    float nl = std::sqrt(n.x * n.x + n.y * n.y + n.z * n.z);
    float inl = nl < 1e-20f ? 0.f : 1.0f / nl;
    out[3 * f] = n.x * inl;
    out[3 * f + 1] = n.y * inl;
    out[3 * f + 2] = n.z * inl;
  }
}

static void compute_face_normals(const float* verts, const int32_t* faces,
                                 int64_t n_faces, float* out) {
  int n_threads = worker_threads();
  if ((int64_t)n_threads > n_faces)
    n_threads = (int)std::max<int64_t>(1, n_faces);
  std::vector<std::thread> threads;
  int64_t per = (n_faces + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    int64_t f0 = i * per;
    int64_t f1 = std::min<int64_t>(f0 + per, n_faces);
    if (f0 >= f1) continue;
    threads.emplace_back(
        [=]() { face_normals_range(verts, faces, f0, f1, out); });
  }
  for (auto& t : threads) t.join();
}

// Shared projection + rasterization stages; per-thread tiles land in the
// workspace's `bufs` (entries with an empty depth vector took no part in
// this call).
static void raster_pipeline(const float* verts, int64_t n_verts,
                            const int32_t* faces, int64_t n_faces,
                            const float* face_normals, const Cam& cam, int h,
                            int w, Workspace& ws) {
  int n_threads = worker_threads();
  if ((int64_t)n_threads > n_faces) n_threads = (int)std::max<int64_t>(1, n_faces);

  // per-vertex projection prepass (threaded)
  ws.pverts.resize(n_verts);
  PVert* pverts = ws.pverts.data();
  {
    std::vector<std::thread> vthreads;
    int64_t per_v = (n_verts + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; ++i) {
      int64_t v0 = i * per_v;
      int64_t v1 = std::min<int64_t>(v0 + per_v, n_verts);
      if (v0 >= v1) continue;
      vthreads.emplace_back([&, v0, v1]() {
        project_range(cam, verts, v0, v1, pverts);
      });
    }
    for (auto& t : vthreads) t.join();
  }

  if (face_normals == nullptr) {
    ws.fn_storage.resize(3 * n_faces);
    compute_face_normals(verts, faces, n_faces, ws.fn_storage.data());
    face_normals = ws.fn_storage.data();
  }

  if ((int)ws.bufs.size() < n_threads) ws.bufs.resize(n_threads);
  std::vector<FrameBuf>& bufs = ws.bufs;
  std::vector<std::thread> threads;
  int64_t per = (n_faces + n_threads - 1) / n_threads;
  for (int i = 0; i < (int)bufs.size(); ++i) {
    int64_t f0 = (int64_t)i * per;
    int64_t f1 = std::min<int64_t>(f0 + per, n_faces);
    if (f0 >= f1) {
      bufs[i].depth.clear();  // mark as not participating in this call
      continue;
    }
    bufs[i].init((int64_t)h * w);
    threads.emplace_back([&, i, f0, f1]() {
      raster_range(verts, faces, face_normals, pverts, f0, f1, h, w, bufs[i]);
    });
  }
  for (auto& t : threads) t.join();
}

// Winner tile + buffer index per pixel; -1 = no hit.
static inline int merge_pixel(const std::vector<FrameBuf>& bufs, int64_t i,
                              float* best_depth) {
  float best = std::numeric_limits<float>::infinity();
  int best_b = -1;
  for (size_t b = 0; b < bufs.size(); ++b) {
    if (!bufs[b].depth.empty() && bufs[b].depth[i] < best) {
      best = bufs[b].depth[i];
      best_b = (int)b;
    }
  }
  *best_depth = best;
  return best_b;
}

}  // namespace

extern "C" {

// Rt: 4x4 camera-to-world pose, row-major (OpenGL convention: camera looks
// along -z). K: 3x3 row-major intrinsics. face_normals: [n_faces,3] unit
// world-space normals, or NULL to compute them here. Outputs are
// h*w(-sized) buffers allocated by the caller: depth (view depth, inf where
// empty), points (world xyz), normals (world face normals), mask (1 = hit).
int nphm_rasterize(const float* verts, int64_t n_verts, const int32_t* faces,
                   int64_t n_faces, const float* face_normals, const float* K,
                   const float* Rt, int h, int w, float znear, float zfar,
                   float* out_depth, float* out_points, float* out_normals,
                   uint8_t* out_mask) {
  Cam cam = make_cam(K, Rt, znear, zfar);
  Workspace& ws = workspace();
  raster_pipeline(verts, n_verts, faces, n_faces, face_normals, cam, h, w, ws);
  const std::vector<FrameBuf>& bufs = ws.bufs;

  int64_t n = (int64_t)h * w;
  for (int64_t i = 0; i < n; ++i) {
    float best;
    int best_b = merge_pixel(bufs, i, &best);
    if (best_b < 0) {
      out_depth[i] = std::numeric_limits<float>::infinity();
      out_mask[i] = 0;
      std::memset(out_points + 3 * i, 0, 3 * sizeof(float));
      std::memset(out_normals + 3 * i, 0, 3 * sizeof(float));
    } else {
      out_depth[i] = best;
      out_mask[i] = 1;
      std::memcpy(out_points + 3 * i, &bufs[best_b].points[3 * i],
                  3 * sizeof(float));
      std::memcpy(out_normals + 3 * i, &bufs[best_b].normals[3 * i],
                  3 * sizeof(float));
    }
  }
  return 0;
}

// Visible-surface sampling for eval: rasterize, then emit only the hit
// pixels whose surface is front-facing w.r.t. the camera ray —
// dot(ray_hat, n) < -cos_thresh, the reference's backface removal
// (render_utils.py:169-201) — compacted in row-major pixel order (identical
// to masking the full image buffers on the Python side).  out_points /
// out_normals must hold h*w*3 floats; *out_count receives the number of
// emitted samples.
int nphm_render_visible(const float* verts, int64_t n_verts,
                        const int32_t* faces, int64_t n_faces,
                        const float* face_normals, const float* K,
                        const float* Rt, int h, int w, float znear, float zfar,
                        float cos_thresh, float* out_points,
                        float* out_normals, int64_t* out_count) {
  Cam cam = make_cam(K, Rt, znear, zfar);
  Workspace& ws = workspace();
  raster_pipeline(verts, n_verts, faces, n_faces, face_normals, cam, h, w, ws);
  const std::vector<FrameBuf>& bufs = ws.bufs;

  int64_t n = (int64_t)h * w;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    float best;
    int best_b = merge_pixel(bufs, i, &best);
    if (best_b < 0) continue;
    const float* p = &bufs[best_b].points[3 * i];
    const float* nn = &bufs[best_b].normals[3 * i];
    // double for the cull test: matches the float64 numpy path bit-for-bit
    // on the threshold boundary
    double rx = (double)p[0] - cam.t[0];
    double ry = (double)p[1] - cam.t[1];
    double rz = (double)p[2] - cam.t[2];
    double rlen = std::sqrt(rx * rx + ry * ry + rz * rz);
    if (rlen < 1e-20) rlen = 1e-20;
    double dot = rx * nn[0] + ry * nn[1] + rz * nn[2];
    if (dot >= -(double)cos_thresh * rlen) continue;
    std::memcpy(out_points + 3 * count, p, 3 * sizeof(float));
    std::memcpy(out_normals + 3 * count, nn, 3 * sizeof(float));
    ++count;
  }
  *out_count = count;
  return 0;
}

// Unit face normals (n / max(|n|, 1e-20) with degenerate faces mapped to 0),
// threaded.  Replaces the numpy cross/norm chain in Mesh.face_normals for
// the evaluation path, where its fresh [F,3] temporaries dominated the cost
// on large marching-cubes meshes.
int nphm_face_normals(const float* verts, int64_t n_verts,
                      const int32_t* faces, int64_t n_faces, float* out) {
  (void)n_verts;
  compute_face_normals(verts, faces, n_faces, out);
  return 0;
}

}  // extern "C"
