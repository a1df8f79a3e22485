// K3 and K4: the fit-specialised NPHM field, forward and backward.
//
// Replace nphm_tpu/ops/pallas_train.py::_fit_fwd_impl (body
// _make_fit_fwd_kernel) and ::_fit_bwd_impl (body _make_fit_bwd_kernel), the
// two halves of the custom VJP _member_f behind apply_nphm_fit_pallas.
//
// K3: one block per (member, tile of kLanes points) computes the member's
// raw SDF F (head without its bias) at member-local coordinates, with the
// latent folded into per-(member, row) biases.  A (member, cull tile) pair
// outside the cull radius writes 0.  Bound: fp32 FMA throughput (~81k FMAs
// per point and member) with member weights read from L2 once per block.
//
// K4: from F's cotangent dF, one block per (member, 64-point tile)
// recomputes the forward (keeping every hidden activation in shared memory)
// and runs one reverse sweep with the transposed weights: d(coords) is
// written directly, and the per-row bias cotangents of layer 0 and of the
// skip layer go to per-block partials [A][n_blocks][H], which a second pass
// (mlp_tile.cuh's sum_block_partials, shared with K6) sums over each row's
// blocks in a fixed order (deterministic, unlike atomics).  Weight
// cotangents are not computed: the decoder is frozen during a fit.
//
// K4's bound on this card: tensor-core operations, ~161k multiply-adds per
// point and member for the recomputed forward and the reverse sweep, run as
// 3xTF32 (tc_tile.cuh): 3 x 2 x 161k flops at 495 TFLOP/s of TF32.
//
// Design.  Every hidden product (the layers forward, their transposes in
// reverse) is tc::mm64: 16 warps of mma.sync m16n8k8 .tf32, both operands
// split into TF32 halves in registers (tc::split_mma, three instructions an
// element) after ldmatrix loads.  A is the activation tile, point-major in
// shared memory ([64][act_ld(width)], 184 KB at the NPHM widths); B is the
// member's K-major weights, staged by TMA in 16-wide K slices through a
// three-stage swizzled ring (39 KB; 8-wide slices where a wider trunk leaves
// no room), issued two slices ahead and on into the next product by one
// thread, each slice serving all 64 points.  Each warp stores its raw sums;
// bias and softplus then run as a balanced block-wide pass, which also turns
// the consumed input activation into its softplus' (the reverse sweep's only
// use of it), so the reverse epilogues are a multiply; the reverse sweep
// overwrites each of those with its cotangent in place.  Bias cotangents
// are warp-shuffle column sums (tc::colsum64) and d(coords) a
// warp-cooperative product through the 3-wide point weights closed by
// shuffle trees (point_grad), both in a fixed order.  Culled (member, tile)
// pairs exit after writing zeros.  One block per SM (~222 KB of shared
// memory for the NPHM ensemble).
//
// mma.sync rather than wgmma: wgmma takes its .tf32 A operand from shared
// memory (both halves of 184 KB of activations: no room) or from registers,
// and its N is an instruction constant, so every hidden width (101 -> 104,
// 200) would need its own instruction and accumulator count; mma.sync tiles
// any width in 8-wide steps and splits both operands where they are loaded.
//
// K4's first design: 32-point blocks of 8 warps, an fp32
// register-tiled product reading weights from L2 with __ldg, serial bias and
// d(coords) loops: 5.83 ms at M = 5x1024 (NVIDIA H100 80GB HBM3, 700.00 W).
#include "mlp_tile.cuh"
#include "tc_tile.cuh"

namespace {

namespace tc = nphm::tc;

constexpr int kLanes = 32;
constexpr int kBwdLanes = tc::kRows;

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

// dg[c * 64 + t] += sum_o d[t * ld + o] * wp[o * 3 + c] over the 64 rows of
// a tile: warp w owns rows R w .. R w + R - 1 (R = 64 / warps), its lanes
// stride over o, and each of the 3 R sums closes with a fixed-order shuffle
// tree (deterministic).
__device__ __forceinline__ void point_grad(const float* d, int ld, int H,
                                           const float* __restrict__ wp, float* dg) {
  constexpr int R = kBwdLanes / tc::kMmaWarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* rows = d + warp * R * ld;
  float acc[R][3];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
  for (int o = lane; o < H; o += 32) {
    const float w0 = __ldg(wp + o * 3);
    const float w1 = __ldg(wp + o * 3 + 1);
    const float w2 = __ldg(wp + o * 3 + 2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = rows[r * ld + o];
      acc[r][0] = fmaf(v, w0, acc[r][0]);
      acc[r][1] = fmaf(v, w1, acc[r][1]);
      acc[r][2] = fmaf(v, w2, acc[r][2]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) dg[c * kBwdLanes + warp * R + r] += v;
    }
}

// TMA descriptors of each hidden layer i (1 <= i <= L-2) over all members:
// wt[i] as [A * n_out][ldwt] for the forward product, w[i] as [A * n_in][ldw]
// for the reverse one, in boxes of KS columns x round8(width) rows.
struct FitMaps {
  CUtensorMap fwd[nphm::kMaxLayers - 2];
  CUtensorMap rev[nphm::kMaxLayers - 2];
};

// Shared memory: hidden activations [64][act_ld(n_out_i)] back to back
// (act_floats in all), xs [3][64], dg [3][64], dF [64], rows [64], then,
// 1 KB aligned, the mm64 ring (tc::kRingStages stages of `stage` floats)
// and its full and empty mbarriers.  Grid: (members, 64-point tiles),
// members fastest, so the blocks in flight read all members' weights from
// L2 rather than all crowding one member's.
constexpr int kBwdThreads = 32 * tc::kMmaWarps;

template <int KS>
__global__ void __launch_bounds__(kBwdThreads, 1)
fit_bwd_kernel(nphm::Trunk tr, const __grid_constant__ FitMaps maps,
               const float* __restrict__ coords,
               const float* __restrict__ dF, const int* __restrict__ active,
               float* __restrict__ dcoords, float* __restrict__ part0,
               float* __restrict__ part_s, int64_t M, int n_members, int cull_tile,
               int act_floats, int stage) {
  constexpr int T = kBwdLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = (int)tr.n_layers;
  const int skip = (int)tr.skip;
  const float beta = (float)tr.beta;
  const int m = blockIdx.x;
  const int64_t blk = blockIdx.y;
  const int64_t n_blk = gridDim.y;
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

  // every hidden activation gets its own buffer: the reverse sweep needs
  // all.  Offsets, not pointers, so that every access stays a shared one.
  int ho[nphm::kMaxLayers];
  int ld[nphm::kMaxLayers];
  int cur = 0;
  for (int i = 0; i < L - 1; ++i) {
    ld[i] = tc::act_ld((int)tr.n_out[i]);
    ho[i] = cur;
    cur += T * ld[i];
  }
  const float inv_beta = 1.f / beta;
  float* xs = smem + act_floats;
  float* dg = xs + 3 * T;
  float* dfs = dg + 3 * T;
  int* rows = reinterpret_cast<int*>(dfs + T);
  tc::Ring ring;
  ring.buf = dfs + 2 * T;
  ring.buf += ((1024u - (tc::smem_u32(ring.buf) & 1023u)) & 1023u) / sizeof(float);
  ring.stage = stage;
  ring.full = reinterpret_cast<uint64_t*>(ring.buf + tc::kRingStages * stage);
  ring.empty = ring.full + tc::kRingStages;
  ring.slices = ring.issued = 0;
  // the block's products in order: forward i = 1..L-2, then reverse i = L-2..1
  auto fwd = [&](int i) {
    return tc::Operand{&maps.fwd[i - 1], m * (int)tr.n_out[i], (int)tr.n_in[i],
                       (int)tr.n_out[i]};
  };
  auto rev = [&](int i) {
    return tc::Operand{&maps.rev[i - 1], m * (int)tr.n_in[i], (int)tr.n_out[i],
                       (int)tr.n_in[i]};
  };

  // the products read activation columns up to the next multiple of 8 and
  // every layer writes the rest: zero the pad columns
  for (int i = 0; i < L - 1; ++i) {
    const int w = (int)tr.n_out[i];
    const int pad = ((w + 7) & ~7) - w;
    for (int it = t; it < pad * T; it += blockDim.x)
      smem[ho[i] + (it / pad) * ld[i] + w + it % pad] = 0.f;
  }
  if (t < T) {
    for (int c = 0; c < 3; ++c) {
      xs[c * T + t] = coords[(m * 3 + c) * M + p0 + t];
      dg[c * T + t] = 0.f;
    }
    dfs[t] = dF[m * M + p0 + t];
    rows[t] = (int)((p0 + t) / tr.row_len);
  }
  if (t == 0) {
    for (int s = 0; s < tc::kRingStages; ++s) {
      tc::mbar_init(&ring.full[s], 1);
      tc::mbar_init(&ring.empty[s], tc::kMmaWarps);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  // forward: layer 0 from the 3 point inputs (a thread per output column
  // and 16-row block, its rows independent), then the hidden products
  {
    const float* __restrict__ w = tr.w[0] + m * tr.w_ms[0];
    const float* __restrict__ b = tr.b[0] + m * tr.b_ms[0];
    const int64_t brs = tr.b_rs[0];
    float* h = smem + ho[0];
    const int ld0 = ld[0];
    for (int it = t; it < H0 * 4; it += blockDim.x) {
      const int o = it % H0;
      const int l0 = (it / H0) * 16;
      const float w0 = w[o * 3], w1 = w[o * 3 + 1], w2 = w[o * 3 + 2];
#pragma unroll 4
      for (int l = l0; l < l0 + 16; ++l) {
        float z = w0 * xs[l];
        z = fmaf(w1, xs[T + l], z);
        z = fmaf(w2, xs[2 * T + l], z);
        h[l * ld0 + o] =
            tc::softplus_fast(z + __ldg(b + rows[l] * brs + o), beta, inv_beta);
      }
    }
    __syncthreads();
  }
  for (int i = 1; i < L - 1; ++i) {
    // each warp stores its raw sums, then the block applies bias, point
    // term and softplus in a balanced pass (a thread per column and 16-row
    // block), and turns the consumed input h_{i-1} into softplus'(z_{i-1})
    // for the reverse sweep
    float* out = smem + ho[i];
    const int ldo = ld[i];
    const tc::Operand next = i + 1 < L - 1 ? fwd(i + 1) : rev(L - 2);
    tc::mm64<KS>(smem + ho[i - 1], ld[i - 1], fwd(i), &next, ring,
                 [&](int, int) { return 0.f; },
                 [&](int l, int o, float acc, float) { out[l * ldo + o] = acc; });
    __syncthreads();
    const int H = (int)tr.n_out[i];
    const float* __restrict__ b = tr.b[i] + m * tr.b_ms[i];
    const int64_t brs = tr.b_rs[i];
    const float* __restrict__ wp = i == skip ? tr.wp + m * tr.wp_ms : nullptr;
    for (int it = t; it < H * 4; it += blockDim.x) {
      const int o = it % H;
      const int l0 = (it / H) * 16;
      float w0 = 0.f, w1 = 0.f, w2 = 0.f;
      if (wp != nullptr) {
        w0 = wp[o * 3];
        w1 = wp[o * 3 + 1];
        w2 = wp[o * 3 + 2];
      }
#pragma unroll 4
      for (int l = l0; l < l0 + 16; ++l) {
        float z = out[l * ldo + o] + __ldg(b + rows[l] * brs + o);
        z = fmaf(w0, xs[l], z);
        z = fmaf(w1, xs[T + l], z);
        z = fmaf(w2, xs[2 * T + l], z);
        out[l * ldo + o] = tc::softplus_fast(z, beta, inv_beta);
      }
    }
    float* h = smem + ho[i - 1];
    const int Hp = (int)tr.n_out[i - 1];
    const int ldh = ld[i - 1];
    for (int it = t; it < Hp * 4; it += blockDim.x) {
      const int o = it % Hp;
      const int l0 = (it / Hp) * 16;
#pragma unroll 4
      for (int l = l0; l < l0 + 16; ++l)
        h[l * ldh + o] = tc::softplus_grad_fast(h[l * ldh + o], beta);
    }
    __syncthreads();
  }

  // cotangent of the last hidden activation: wlast * dF (head width 1)
  {
    const float* wl = tr.w[L - 1] + m * tr.w_ms[L - 1];
    const int H = (int)tr.n_out[L - 2];
    float* h = smem + ho[L - 2];
    const int ldh = ld[L - 2];
    for (int it = t; it < H * 4; it += blockDim.x) {
      const int o = it % H;
      const int l0 = (it / H) * 16;
      const float wo = wl[o];
#pragma unroll 4
      for (int l = l0; l < l0 + 16; ++l) {
        float& v = h[l * ldh + o];
        v = wo * dfs[l] * tc::softplus_grad_fast(v, beta);
      }
    }
    __syncthreads();
  }
  // activation L-2 now holds d_{L-2} = u * softplus'(z), the others
  // softplus'(z_i); walk down to layer 0
  for (int i = L - 2; i >= 0; --i) {
    const int H = (int)tr.n_out[i];
    float* d = smem + ho[i];
    if (i == skip || i == 0) {
      // bias cotangent partials and d(coords) += d_i . Wp_i (3 point inputs)
      tc::colsum64(d, ld[i], H, i == 0 ? out0 : out_s);
      point_grad(d, ld[i], H, i == 0 ? tr.w[0] + m * tr.w_ms[0] : tr.wp + m * tr.wp_ms,
                 dg);
    }
    if (i > 0) {
      // u_{i-1} = d_i W_i, then d_{i-1} = u_{i-1} * softplus'(z_{i-1}) in place
      float* prev = smem + ho[i - 1];
      const int ldv = ld[i - 1];
      const tc::Operand next = i > 1 ? rev(i - 1) : tc::Operand{};
      tc::mm64<KS>(d, ld[i], rev(i), i > 1 ? &next : nullptr, ring,
                   [&](int l, int k) { return prev[l * ldv + k]; },
                   [&](int l, int k, float acc, float g) { prev[l * ldv + k] = acc * g; });
    }
    __syncthreads();
  }
  if (t < T)
    for (int c = 0; c < 3; ++c) dcoords[(m * 3 + c) * M + p0 + t] = dg[c * T + t];
}

}  // namespace

extern "C" int nphm_fit_lanes_per_block() { return kLanes; }
extern "C" int nphm_fit_bwd_lanes_per_block() { return kBwdLanes; }

static int nphm_fit_fwd_smem_bytes(int hmax) {
  constexpr int T = kLanes;
  return (int)sizeof(float) *
         (2 * hmax * T + 3 * T + nphm::kMaxHead * T +
          nphm::kWarps * nphm::kMaxHead * T + T);
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

// + dF [A][M] -> dcoords [A][3][M], d_bias0 [A][n_rows][H0], d_bias_s
// [A][n_rows][HS]; part0/part_s: scratch [A][M / 64][H].  The weights'
// leading dims ldw/ldwt are multiples of 8 with zero columns past the
// width, and every product is at most tc::kMaxN wide.  The weights are
// staged in K slices of 16 where that ring fits in shared memory beside the
// activations (the NPHM ensemble: ~222 KB), else of 8.
extern "C" int nphm_fit_bwd(const nphm::Trunk* tr, const float* coords, const float* dF,
                            const int* active, float* dcoords, float* part0,
                            float* part_s, float* d_bias0, float* d_bias_s, int64_t M,
                            int n_members, int n_rows, int cull_tile, void* stream) {
  const int L = (int)tr->n_layers;
  int act_floats = 0;
  int nmax = 8;
  for (int i = 0; i < L - 1; ++i) {
    act_floats += kBwdLanes * tc::act_ld((int)tr->n_out[i]);
    if (i > 0) {
      nmax = tr->n_out[i] > nmax ? (int)tr->n_out[i] : nmax;
      nmax = tr->n_in[i] > nmax ? (int)tr->n_in[i] : nmax;
    }
  }
  if (nmax > tc::kMaxN) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int fixed = (int)sizeof(float) * (act_floats + 8 * kBwdLanes) + 1024 +
                    16 * tc::kRingStages;
  const int smem16 =
      fixed + (int)sizeof(float) * tc::kRingStages * tc::stage_floats<16>(nmax);
  const int smem8 =
      fixed + (int)sizeof(float) * tc::kRingStages * tc::stage_floats<8>(nmax);
  const bool wide = smem16 <= optin;
  const int KS = wide ? 16 : 8;
  FitMaps maps = {};
  for (int i = 1; i < L - 1; ++i) {
    const int n_in = (int)tr->n_in[i], n_out = (int)tr->n_out[i];
    int rc = tc::make_map(&maps.fwd[i - 1], tr->wt[i], (int)tr->ldwt[i],
                          (int64_t)n_members * n_out, (int)tr->ldwt[i], KS, (n_out + 7) & ~7);
    if (rc == 0)
      rc = tc::make_map(&maps.rev[i - 1], tr->w[i], (int)tr->ldw[i],
                        (int64_t)n_members * n_in, (int)tr->ldw[i], KS, (n_in + 7) & ~7);
    if (rc != 0) return rc;
  }
  auto kernel = wide ? fit_bwd_kernel<16> : fit_bwd_kernel<8>;
  const int smem = wide ? smem16 : smem8;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_blk = M / kBwdLanes;
  dim3 grid((unsigned)n_members, (unsigned)n_blk);
  kernel<<<grid, kBwdThreads, smem, (cudaStream_t)stream>>>(
      *tr, maps, coords, dF, active, dcoords, part0, part_s, M, n_members, cull_tile,
      act_floats, wide ? tc::stage_floats<16>(nmax) : tc::stage_floats<8>(nmax));
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
