// K1: eval-mode NPHM ensemble SDF over a set of points, for one latent, on
// the tensor cores.
//
// Replaces nphm_tpu/ops/pallas_ensemble.py::nphm_sdf_pallas (body
// _make_kernel).  A block takes a tile of 64 points and walks the live
// members of their cull tile in ascending order, from a compacted work
// list built on the host side (offsets [n_tiles + 1] into members, the
// (tile, member) pairs whose anchor lies within the cull radius of the
// tile's bounding box, tile-major, members ascending), so culled members
// cost nothing.  For each live member it forms the member-local
// coordinates q - anchor, runs the member's MLP (field_tile.cuh's body in
// mode kFitFwd, K3's: 3xTF32 mma.sync over 16 warps, the member's K-major
// weights staged by TMA, two activation tiles in turn, bias and softplus
// in a block-wide pass, the head as a warp-row dot), and adds its
// Gaussian-weighted SDF to the blend.  The blend's numerator and
// denominator stay in the registers of the point's thread and start at
// the background member's pinned contribution (weight exp(bg_dist / var),
// SDF 1); the members close in a fixed order, so results are
// deterministic.  The TMA ring runs on from one member's last product into
// the next member's first.
//
// Bound on this card: 3xTF32 tensor-core operations (about 81k
// multiply-adds per point and live member at production dims, three TF32
// products each, at 495 TFLOP/s), with each live member's 325 KB of
// weights read from L2 once per block.
//
// First design (fp32 SIMT, 256 threads a 64-point block, every member's
// layers through a register-tiled product reading weights with __ldg):
// 41.29 ms on the 64^3 brick grid, 1.545 s on the res-256 extraction grid
// (NVIDIA H100 80GB HBM3, 700.00 W).
#include "field_tile.cuh"

namespace {

namespace field = nphm::field;
namespace tc = nphm::tc;

// The widest K slice of the weight ring: 32 where three stages fit beside
// the two activation tiles (the NPHM widths: ~183 KB), halving the ring's
// per-slice barrier work against K3's 16.
constexpr int kMaxSlice = 32;

// Shared memory: two activation tiles (act_floats), xs [3][64] member-local
// coordinates, F [64], rows [64] (all 0: one latent), then, 1 KB aligned,
// the ring and its mbarriers (field::setup's layout).
template <int KS>
__global__ void __launch_bounds__(field::kThreads, 1)
ensemble_sdf_kernel(nphm::Trunk tr, const __grid_constant__ field::Maps maps,
                    const float* __restrict__ q, const float* __restrict__ centers,
                    const int* __restrict__ offsets, const int* __restrict__ members,
                    float* __restrict__ out, int cull_tile, float inv_var, float bg_w,
                    int act_floats, int stage) {
  constexpr int T = field::kRows;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = (int)tr.n_layers;
  const int t = threadIdx.x;
  const int64_t p0 = (int64_t)blockIdx.x * T;
  float* xs = smem + act_floats;
  float* fs = xs + 3 * T;
  int* rows = reinterpret_cast<int*>(fs + T);
  tc::Ring ring = field::make_ring(smem + act_floats + 8 * T, stage);
  int ho[nphm::kMaxLayers];
  int ld[nphm::kMaxLayers];
  for (int i = 0; i < L - 1; ++i) {
    ld[i] = tc::act_ld((int)tr.n_out[i]);
    ho[i] = (i & 1) * (act_floats / 2);
  }
  auto fwd = [&](int m, int i) {
    return tc::Operand{&maps.fwd[i - 1], m * (int)tr.n_out[i], (int)tr.n_in[i],
                       (int)tr.n_out[i]};
  };

  const int64_t tile = p0 / cull_tile;
  const int k_begin = offsets[tile];
  const int k_end = offsets[tile + 1];
  float qx = 0.f, qy = 0.f, qz = 0.f, num = bg_w, den = bg_w;
  if (t < T) {
    qx = q[(p0 + t) * 3];
    qy = q[(p0 + t) * 3 + 1];
    qz = q[(p0 + t) * 3 + 2];
    rows[t] = 0;
  }
  field::init_ring(ring);
  for (int k = k_begin; k < k_end; ++k) {
    const int m = members[k];
    const int m_next = k + 1 < k_end ? members[k + 1] : -1;
    if (t < T) {
      xs[t] = qx - centers[m * 3];
      xs[T + t] = qy - centers[m * 3 + 1];
      xs[2 * T + t] = qz - centers[m * 3 + 2];
    }
    __syncthreads();
    field::layer0_pass(tr, m, xs, rows, smem + ho[0], ld[0]);
    __syncthreads();
    for (int i = 1; i < L - 1; ++i) {
      // raw sums, then bias and softplus in a balanced block-wide pass
      float* h = smem + ho[i];
      const int ldh = ld[i];
      tc::Operand next{};
      bool more = true;
      if (i + 1 < L - 1)
        next = fwd(m, i + 1);
      else if (m_next >= 0)
        next = fwd(m_next, 1);
      else
        more = false;
      tc::mm64<KS>(smem + ho[i - 1], ld[i - 1], fwd(m, i), more ? &next : nullptr, ring,
                   [&](int, int) { return 0.f; },
                   [&](int l, int o, float acc, float) { h[l * ldh + o] = acc; });
      __syncthreads();
      field::bias_pass(tr, i, m, xs, rows, h, ldh);
      __syncthreads();
    }
    field::head_pass<field::kFitFwd>(smem + ho[L - 2], ld[L - 2], (int)tr.n_out[L - 2],
                                     tr.w[L - 1] + m * tr.w_ms[L - 1], nullptr,
                                     (float)tr.beta, fs);
    __syncthreads();
    if (t < T) {
      const float r0 = xs[t], r1 = xs[T + t], r2 = xs[2 * T + t];
      const float dd = sqrtf(r0 * r0 + r1 * r1 + r2 * r2 + 1e-20f);
      const float e = dd + 1e-5f;
      const float w = expf(-(e * e) * inv_var);
      num += w * (fs[t] + __ldg(tr.b[L - 1] + m * tr.b_ms[L - 1]));
      den += w;
    }
  }
  if (t < T) out[p0 + t] = num / (den + 1e-6f);
}

}  // namespace

extern "C" int nphm_ensemble_points_per_block() { return field::kRows; }

// q: [n_points][3] (n_points a multiple of cull_tile, cull_tile a multiple
// of 64); centers: [n_members][3]; offsets [n_points / cull_tile + 1] and
// members: the live (cull tile, member) pairs, tile-major, members
// ascending.  Hidden layers read wt [n_members][n_out][ldwt] (ldwt a
// multiple of 8, zero columns past n_in), the head w [n_members][n_in].
extern "C" int nphm_ensemble_sdf(const nphm::Trunk* tr, const float* q,
                                 const float* centers, const int* offsets,
                                 const int* members, float* out, int64_t n_points,
                                 int n_members, int cull_tile, float inv_var,
                                 float bg_w, void* stream) {
  if (n_points % field::kRows != 0 || cull_tile % field::kRows != 0)
    return (int)cudaErrorInvalidValue;
  field::Maps maps = {};
  field::Launch ln;
  const int rc = field::setup(tr, n_members, false, &maps, &ln, 0, 8 * field::kRows, kMaxSlice);
  if (rc != 0) return rc;
  const auto kernel = ln.ks == 32   ? ensemble_sdf_kernel<32>
                      : ln.ks == 16 ? ensemble_sdf_kernel<16>
                                    : ensemble_sdf_kernel<8>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ln.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(n_points / field::kRows), field::kThreads, ln.smem,
           (cudaStream_t)stream>>>(*tr, maps, q, centers, offsets, members, out, cull_tile,
                                   inv_var, bg_w, ln.act_floats, ln.stage);
  return (int)cudaGetLastError();
}
