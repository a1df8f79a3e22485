// K1: eval-mode NPHM ensemble SDF over a set of points, for one latent.
//
// Replaces nphm_tpu/ops/pallas_ensemble.py::nphm_sdf_pallas (body
// _make_kernel).  Each block takes a tile of kPoints points and loops over
// the 39 anchored members; a member whose anchor is outside the cull radius
// of the point's cull tile (active[tile, member] == 0, computed on the host
// side from tile bounding boxes) is skipped by the whole block.  The Gaussian
// blend numerator and denominator stay in the registers of the lane's
// thread and start at the background member's pinned contribution
// (weight exp(bg_dist / var), SDF 1).
//
// Bound on this card: fp32 FMA throughput (about 81k FMAs per point and live
// member at production dims) with the member weights (325 KB each) read
// from L2 once per block and member.  Design: activations never leave
// shared memory; the conditioning, symmetric sharing and mirror sign are
// folded into the weights on the host; culling removes ~3/4 of the work on
// brick-ordered grids.
#include "mlp_tile.cuh"

namespace {

constexpr int kPoints = 64;

__global__ void __launch_bounds__(nphm::kThreads)
ensemble_sdf_kernel(nphm::Trunk tr, const float* __restrict__ q,
                    const float* __restrict__ centers,
                    const int* __restrict__ active, float* __restrict__ out,
                    int n_members, int cull_tile, int hmax, float inv_var,
                    float bg_w) {
  constexpr int T = kPoints;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf_a = smem;
  float* buf_b = buf_a + hmax * T;
  float* raw = buf_b + hmax * T;
  float* head = raw + 3 * T;
  float* part = head + nphm::kMaxHead * T;
  int* rows = reinterpret_cast<int*>(part + nphm::kWarps * nphm::kMaxHead * T);

  float* hs[nphm::kMaxLayers];
  for (int i = 0; i < nphm::kMaxLayers; ++i) hs[i] = (i % 2 == 0) ? buf_a : buf_b;

  const int t = threadIdx.x;
  const int64_t p0 = (int64_t)blockIdx.x * T;
  const int64_t tile = p0 / cull_tile;
  float qx = 0.f, qy = 0.f, qz = 0.f, num = bg_w, den = bg_w;
  if (t < T) {
    qx = q[(p0 + t) * 3];
    qy = q[(p0 + t) * 3 + 1];
    qz = q[(p0 + t) * 3 + 2];
    rows[t] = 0;
  }
  for (int k = 0; k < n_members; ++k) {
    if (active[tile * n_members + k] == 0) continue;  // uniform per block
    if (t < T) {
      raw[t] = qx - centers[k * 3];
      raw[T + t] = qy - centers[k * 3 + 1];
      raw[2 * T + t] = qz - centers[k * 3 + 2];
    }
    __syncthreads();
    nphm::trunk_forward<T, 8, 8>(tr, k, raw, rows, hs, head, part, true);
    if (t < T) {
      const float r0 = raw[t], r1 = raw[T + t], r2 = raw[2 * T + t];
      const float dd = sqrtf(r0 * r0 + r1 * r1 + r2 * r2 + 1e-20f);
      const float e = dd + 1e-5f;
      const float w = expf(-(e * e) * inv_var);
      num += w * head[t];
      den += w;
    }
  }
  if (t < T) out[p0 + t] = num / (den + 1e-6f);
}

}  // namespace

static int nphm_ensemble_smem_bytes(int hmax) {
  constexpr int T = kPoints;
  return (int)sizeof(float) *
         (2 * hmax * T + 3 * T + nphm::kMaxHead * T +
          nphm::kWarps * nphm::kMaxHead * T + T);
}

extern "C" int nphm_ensemble_points_per_block() { return kPoints; }

// q: [n_points][3] (n_points a multiple of cull_tile, cull_tile a multiple
// of kPoints); centers: [n_members][3]; active: [n_points/cull_tile][n_members].
extern "C" int nphm_ensemble_sdf(const nphm::Trunk* tr, const float* q,
                                 const float* centers, const int* active,
                                 float* out, int64_t n_points, int n_members,
                                 int cull_tile, int hmax, float inv_var,
                                 float bg_w, void* stream) {
  const int smem = nphm_ensemble_smem_bytes(hmax);
  cudaError_t err = cudaFuncSetAttribute(
      ensemble_sdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = n_points / kPoints;
  ensemble_sdf_kernel<<<(unsigned)blocks, nphm::kThreads, smem,
                        (cudaStream_t)stream>>>(*tr, q, centers, active, out,
                                                n_members, cull_tile, hmax,
                                                inv_var, bg_w);
  return (int)cudaGetLastError();
}
