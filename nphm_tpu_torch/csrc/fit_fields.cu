// K3 and K4: the fit-specialised NPHM field, forward and backward.
//
// Replace nphm_tpu/ops/pallas_train.py::_fit_fwd_impl (body
// _make_fit_fwd_kernel) and ::_fit_bwd_impl (body _make_fit_bwd_kernel), the
// two halves of the custom VJP _member_f behind apply_nphm_fit_pallas.
//
// K3: one block per (member, tile of kLanes points) computes the member's
// raw SDF F (head without its bias) at member-local coordinates, with the
// latent folded into per-(member, row) biases.  A (member, cull tile) pair
// outside the cull radius writes 0.
//
// K4: from F's cotangent dF, the same block recomputes the forward (keeping
// every hidden activation in shared memory), then runs one reverse sweep
// with the transposed weights: d(coords) is written directly, and the
// per-row bias cotangents of layer 0 and of the skip layer go to per-block
// partials [A][n_blocks][H], which a second pass (mlp_tile.cuh's
// sum_block_partials, shared with K6) sums over each row's blocks in a
// fixed order (deterministic, unlike atomics).  Weight
// cotangents are not computed: the decoder is frozen during a fit.
//
// Bound on this card: fp32 FMA throughput (forward ~81k FMAs per point and
// member, backward ~2x that) with member weights read from L2 once per
// block.  Design: activations stay in shared memory, the reverse sweep
// overwrites each activation buffer with its own cotangent in place, and
// culled (member, tile) pairs exit after writing zeros.
#include "mlp_tile.cuh"

namespace {

constexpr int kLanes = 32;

__device__ __forceinline__ void load_coords(const float* coords, int m,
                                            int64_t M, int64_t p0,
                                            int64_t row_len, float* xs,
                                            int* rows) {
  const int t = threadIdx.x;
  if (t < kLanes) {
    for (int c = 0; c < 3; ++c) xs[c * kLanes + t] = coords[(m * 3 + c) * M + p0 + t];
    rows[t] = (int)((p0 + t) / row_len);
  }
}

__global__ void __launch_bounds__(nphm::kThreads)
fit_fwd_kernel(nphm::Trunk tr, const float* __restrict__ coords,
               const int* __restrict__ active, float* __restrict__ F,
               int64_t M, int n_members, int cull_tile, int hmax) {
  constexpr int T = kLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf_a = smem;
  float* buf_b = buf_a + hmax * T;
  float* xs = buf_b + hmax * T;
  float* head = xs + 3 * T;
  float* part = head + nphm::kMaxHead * T;
  int* rows = reinterpret_cast<int*>(part + nphm::kWarps * nphm::kMaxHead * T);

  const int m = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * T;
  const int t = threadIdx.x;
  if (active[(p0 / cull_tile) * n_members + m] == 0) {
    if (t < T) F[m * M + p0 + t] = 0.f;
    return;
  }
  float* hs[nphm::kMaxLayers];
  for (int i = 0; i < nphm::kMaxLayers; ++i) hs[i] = (i % 2 == 0) ? buf_a : buf_b;
  load_coords(coords, m, M, p0, tr.row_len, xs, rows);
  __syncthreads();
  nphm::trunk_forward<T, 8, 4>(tr, m, xs, rows, hs, head, part, true);
  if (t < T) F[m * M + p0 + t] = head[t];
}

__global__ void __launch_bounds__(nphm::kThreads)
fit_bwd_kernel(nphm::Trunk tr, const float* __restrict__ coords,
               const float* __restrict__ dF, const int* __restrict__ active,
               float* __restrict__ dcoords, float* __restrict__ part0,
               float* __restrict__ part_s, int64_t M, int n_members,
               int cull_tile, int hsum) {
  constexpr int T = kLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = (int)tr.n_layers;
  const int skip = (int)tr.skip;
  const float beta = (float)tr.beta;
  const int m = blockIdx.y;
  const int64_t blk = blockIdx.x;
  const int64_t n_blk = gridDim.x;
  const int64_t p0 = blk * T;
  const int t = threadIdx.x;
  const int H0 = (int)tr.n_out[0];
  const int HS = (int)tr.n_out[skip];
  float* out0 = part0 + (m * n_blk + blk) * H0;
  float* out_s = part_s + (m * n_blk + blk) * HS;

  if (active[(p0 / cull_tile) * n_members + m] == 0) {
    if (t < T)
      for (int c = 0; c < 3; ++c) dcoords[(m * 3 + c) * M + p0 + t] = 0.f;
    for (int o = t; o < H0; o += blockDim.x) out0[o] = 0.f;
    for (int o = t; o < HS; o += blockDim.x) out_s[o] = 0.f;
    return;
  }

  // every hidden activation gets its own buffer: the reverse sweep needs all
  float* hs[nphm::kMaxLayers];
  float* cur = smem;
  for (int i = 0; i < L - 1; ++i) {
    hs[i] = cur;
    cur += tr.n_out[i] * T;
  }
  float* xs = smem + hsum * T;
  float* dg = xs + 3 * T;
  float* part = dg + 3 * T;
  int* rows = reinterpret_cast<int*>(part + nphm::kWarps * nphm::kMaxHead * T);

  load_coords(coords, m, M, p0, tr.row_len, xs, rows);
  __syncthreads();
  nphm::trunk_forward<T, 8, 4>(tr, m, xs, rows, hs, nullptr, part, false);

  // cotangent of the last hidden activation: wlast * dF (head width 1)
  {
    const float* wl = tr.w[L - 1] + m * tr.w_ms[L - 1];
    const int H = (int)tr.n_out[L - 2];
    float* h = hs[L - 2];
    for (int it = t; it < H * T; it += blockDim.x) {
      const int o = it / T;
      const int l = it - o * T;
      const float u = wl[o] * dF[m * M + p0 + l];
      h[it] = u * nphm::softplus_grad(h[it], beta);
    }
    for (int it = t; it < 3 * T; it += blockDim.x) dg[it] = 0.f;
    __syncthreads();
  }
  // hs[i] now holds d_i = u_i * softplus'(z_i); walk down to layer 0
  for (int i = L - 2; i >= 0; --i) {
    const int H = (int)tr.n_out[i];
    float* d = hs[i];
    if (i == skip || i == 0) {
      float* dst = (i == 0) ? out0 : out_s;
      const float* wp = (i == 0) ? tr.w[0] + m * tr.w_ms[0] : tr.wp + m * tr.wp_ms;
      for (int o = t; o < H; o += blockDim.x) {
        float s = 0.f;
        for (int l = 0; l < T; ++l) s += d[o * T + l];
        dst[o] = s;
      }
      for (int it = t; it < 3 * T; it += blockDim.x) {
        const int c = it / T;
        const int l = it - c * T;
        float s = 0.f;
        for (int o = 0; o < H; ++o) s = fmaf(wp[o * 3 + c], d[o * T + l], s);
        dg[it] += s;
      }
    }
    if (i > 0) {
      // u_{i-1} = W_i^T d_i, then d_{i-1} = u_{i-1} * softplus'(z_{i-1}) in place
      const float* Wt = tr.wt[i] + m * tr.wt_ms[i];
      float* prev = hs[i - 1];
      nphm::tile_mm<T, 8, 4>(Wt, (int)tr.ldwt[i], H, (int)tr.n_in[i], d,
                             [&](int j, int l, float acc) {
                               const int k = j * T + l;
                               prev[k] = acc * nphm::softplus_grad(prev[k], beta);
                             });
    }
    __syncthreads();
  }
  if (t < T)
    for (int c = 0; c < 3; ++c) dcoords[(m * 3 + c) * M + p0 + t] = dg[c * T + t];
}

}  // namespace

extern "C" int nphm_fit_lanes_per_block() { return kLanes; }

static int nphm_fit_fwd_smem_bytes(int hmax) {
  constexpr int T = kLanes;
  return (int)sizeof(float) *
         (2 * hmax * T + 3 * T + nphm::kMaxHead * T +
          nphm::kWarps * nphm::kMaxHead * T + T);
}

static int nphm_fit_bwd_smem_bytes(int hsum) {
  constexpr int T = kLanes;
  return (int)sizeof(float) *
         (hsum * T + 6 * T + nphm::kWarps * nphm::kMaxHead * T + T);
}

// coords: [A][3][M]; active: [M / cull_tile][A]; F: [A][M].
extern "C" int nphm_fit_fwd(const nphm::Trunk* tr, const float* coords,
                            const int* active, float* F, int64_t M,
                            int n_members, int cull_tile, int hmax,
                            void* stream) {
  const int smem = nphm_fit_fwd_smem_bytes(hmax);
  cudaError_t err = cudaFuncSetAttribute(
      fit_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(M / kLanes), (unsigned)n_members);
  fit_fwd_kernel<<<grid, nphm::kThreads, smem, (cudaStream_t)stream>>>(
      *tr, coords, active, F, M, n_members, cull_tile, hmax);
  return (int)cudaGetLastError();
}

// + dF [A][M] -> dcoords [A][3][M], d_bias0 [A][n_rows][H0],
// d_bias_s [A][n_rows][HS]; part0/part_s: scratch [A][M / kLanes][H].
extern "C" int nphm_fit_bwd(const nphm::Trunk* tr, const float* coords,
                            const float* dF, const int* active,
                            float* dcoords, float* part0, float* part_s,
                            float* d_bias0, float* d_bias_s, int64_t M,
                            int n_members, int n_rows, int cull_tile,
                            int hsum, void* stream) {
  const int smem = nphm_fit_bwd_smem_bytes(hsum);
  cudaError_t err = cudaFuncSetAttribute(
      fit_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_blk = M / kLanes;
  dim3 grid((unsigned)n_blk, (unsigned)n_members);
  fit_bwd_kernel<<<grid, nphm::kThreads, smem, (cudaStream_t)stream>>>(
      *tr, coords, dF, active, dcoords, part0, part_s, M, n_members, cull_tile,
      hsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // each row's bias cotangent: that row's block partials in a fixed order
  const int skip = (int)tr->skip;
  const int H0 = (int)tr->n_out[0];
  const int HS = (int)tr->n_out[skip];
  int64_t total = (int64_t)n_members * n_rows * H0;
  nphm::sum_block_partials<<<(unsigned)((total + 255) / 256), 256, 0,
                             (cudaStream_t)stream>>>(
      part0, d_bias0, n_members, n_blk, H0, 0, H0, n_rows, (int64_t)n_rows * H0);
  total = (int64_t)n_members * n_rows * HS;
  nphm::sum_block_partials<<<(unsigned)((total + 255) / 256), 256, 0,
                             (cudaStream_t)stream>>>(
      part_s, d_bias_s, n_members, n_blk, HS, 0, HS, n_rows, (int64_t)n_rows * HS);
  return (int)cudaGetLastError();
}
