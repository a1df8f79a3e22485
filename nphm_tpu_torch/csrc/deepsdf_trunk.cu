// K7: forward, no-grad evaluation of a conditioned DeepSDF trunk.
//
// Replaces nphm_tpu/ops/pallas_mlp.py::deepsdf_trunk_pallas (pl.pallas_call
// at :191, body _make_kernel).  The TPU kernel keeps one lane tile's hidden
// state resident in VMEM and streams one layer's weights per grid step.
// That cannot carry over: a 1024-wide fp32 hidden state of even 32 lanes is
// 128 KB, two of them exceed a block's 227 KB, and each block would stream
// all 33 MB of NPM weights for 32 points.  Here the trunk runs as one launch
// per layer over a chunk of points, activations ping-ponging between
// point-major scratch buffers ([points][features]) that the wrapper
// (ops/trunk.py) allocates, each held as its two TF32 halves:
//
//   trunk_layer_kernel : out[p][o] = act(sum_k x[p][k] W[o][k]
//                                       + sum_j pe[p][j] Wp[o][j] + b[o])
//   trunk_head_kernel  : y[p][o]   = sum_k W[o][k] x[p][k] + b[o], o < 4
//
// The conditioning code is constant along points, so its layer-0 and
// skip-layer contributions are folded into b on the host, and 1/sqrt(2) into
// the skip layer's weights; layer 0 is the same kernel with K = 0 (only the
// point term Wp . pe), the skip layer adds the point term to a full product.
//
// Bound on this card: tensor-core operations.  NPM's 8x1024 trunk is ~12.6
// MFLOP a point against ~16 KB a point and layer of activation traffic, far
// above the ridge.  fp32 outside the tensor cores peaks at 67 TFLOP/s; the
// products here run as 3xTF32 (big*big + big*small + small*big, fp32
// accumulation; tc_tile.cuh) on the TF32 tensor cores, 495 TFLOP/s / 3.
// Design: a block computes 128 points x 128 outputs.  One producer thread
// keeps a 3-stage ring of K slices (32 floats = one 128-byte swizzled row per
// operand row) filled by TMA: the activation tile's and the weight tile's
// big and small halves, 64 KB a stage, signalled on mbarriers.  Two consumer
// warpgroups each own 64 points and issue wgmma m64n128k8 .tf32 three times
// per K step of 8, keeping one slice's products in flight while the next
// slice's issue (a stage returns to the producer when its products retire).
// Both operands are K-major as wgmma requires for 32-bit types: activations
// point-major, weights [out][in].  Weights are split into their halves once
// per call by the wrapper; activations by the epilogue that writes them, so
// the main loop only moves and multiplies.  A K that is not a slice multiple
// (the skip layer's 509 or 309 hidden inputs) and a point or output count
// short of a tile read zeros from TMA's fill past the tensor map's extent.
// The epilogue adds the bias, the point term and Softplus(beta) (ReLU for
// beta <= 0) in registers and writes each output once (no atomics,
// deterministic).  Output tiles of one point tile are adjacent in the grid,
// so a point tile's activations come from L2 after their first read.
//
// This kernel's first design was a 128x128x8 register-tiled fp32 SIMT product:
// 313.01 ms for 2^20 points of the NPM identity trunk (42.2 TFLOP/s), 148.84
// ms for 2^19 points of the offsets trunk, 30.64 ms for 2^19 points of the
// NPHM 6x512 trunk (NVIDIA H100 80GB HBM3, 700.00 W).
#include "mlp_tile.cuh"
#include "tc_tile.cuh"

namespace {

namespace tc = nphm::tc;

constexpr int kBM = 128;  // points per block: two consumer warpgroups of 64
constexpr int kBN = 128;  // outputs per block
constexpr int kBK = 32;   // K slice: 128 bytes of fp32, the swizzle's row
constexpr int kStages = 3;
constexpr int kTileA = kBM * kBK;  // floats of one activation half-tile
constexpr int kTileB = kBN * kBK;  // floats of one weight half-tile
constexpr int kStageFloats = 2 * kTileA + 2 * kTileB;
constexpr int kStageBytes = kStageFloats * 4;
constexpr int kThr = 384;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
constexpr int kHeadWarps = 8;

// Maps: xb/xs the activation halves [P][ldx] (inner extent K), wb/ws the
// weight halves [O][ldw] (inner extent K); pe: [P][ds]; wp: [O][ds];
// b: [O]; ob/os: the output halves [P][ldo].
__global__ void __launch_bounds__(kThr, 1)
trunk_layer_kernel(const __grid_constant__ CUtensorMap xb_map,
                   const __grid_constant__ CUtensorMap xs_map,
                   const __grid_constant__ CUtensorMap wb_map,
                   const __grid_constant__ CUtensorMap ws_map, int K,
                   const float* __restrict__ wp, int ds, const float* __restrict__ pe,
                   const float* __restrict__ b, float* __restrict__ ob,
                   float* __restrict__ os, int ldo, int O, float beta) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  const uint32_t pad = (1024u - (tc::smem_u32(smem_raw) & 1023u)) & 1023u;
  float* ring = reinterpret_cast<float*>(smem_raw + pad);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageFloats);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x >> 7;
  const int o0 = blockIdx.x * kBN;
  const int p0 = blockIdx.y * kBM;
  const int n_k = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 256) {
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kStages;
        const uint32_t r = (uint32_t)(i / kStages);
        tc::mbar_wait(&empty[s], (r & 1u) ^ 1u);
        float* st = ring + s * kStageFloats;
        tc::mbar_expect_tx(&full[s], kStageBytes);
        tc::tma_load_2d(st, &xb_map, &full[s], i * kBK, p0);
        tc::tma_load_2d(st + kTileA, &xs_map, &full[s], i * kBK, p0);
        tc::tma_load_2d(st + 2 * kTileA, &wb_map, &full[s], i * kBK, o0);
        tc::tma_load_2d(st + 2 * kTileA + kTileB, &ws_map, &full[s], i * kBK, o0);
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  tc::fence_regs(acc);
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kStages;
    tc::mbar_wait(&full[s], (uint32_t)(i / kStages) & 1u);
    const float* st = ring + s * kStageFloats;
    const float* a_b = st + wg * 64 * kBK;  // this warpgroup's 64 points
    const float* a_s = a_b + kTileA;
    const float* w_b = st + 2 * kTileA;
    const float* w_s = w_b + kTileB;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const uint64_t da_b = tc::wgmma_desc_sw128(a_b + kk);
      const uint64_t da_s = tc::wgmma_desc_sw128(a_s + kk);
      const uint64_t db_b = tc::wgmma_desc_sw128(w_b + kk);
      const uint64_t db_s = tc::wgmma_desc_sw128(w_s + kk);
      tc::wgmma_m64n128k8_tf32(acc, da_s, db_b);
      tc::wgmma_m64n128k8_tf32(acc, da_b, db_s);
      tc::wgmma_m64n128k8_tf32(acc, da_b, db_b);
    }
    tc::wgmma_commit();
    // keep this slice's products in flight; the previous slice's are done,
    // so its stage goes back to the producer
    tc::wgmma_wait<1>();
    if (i > 0 && (threadIdx.x & 127) == 0) tc::mbar_arrive(&empty[(i - 1) % kStages]);
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);

  // epilogue: this thread holds rows r0, r0 + 8 and columns c0 + 8j + {0, 1}
  const int lane = threadIdx.x & 31;
  const int r0 = p0 + wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int c0 = o0 + 2 * (lane & 3);
  for (int d = 0; d < ds; ++d) {
    const float q0 = __ldg(pe + (size_t)r0 * ds + d);
    const float q1 = __ldg(pe + (size_t)(r0 + 8) * ds + d);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = c0 + 8 * j + e;
        const float w = o < O ? __ldg(wp + (size_t)o * ds + d) : 0.f;
        acc[4 * j + e] = fmaf(w, q0, acc[4 * j + e]);
        acc[4 * j + 2 + e] = fmaf(w, q1, acc[4 * j + 2 + e]);
      }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int o = c0 + 8 * j;
    if (o >= O) continue;
    const bool pair = o + 1 < O;
    const float b0 = __ldg(b + o);
    const float b1 = pair ? __ldg(b + o + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = (size_t)(r0 + 8 * h) * ldo + o;
      float v0 = acc[4 * j + 2 * h] + b0;
      float v1 = acc[4 * j + 2 * h + 1] + b1;
      v0 = beta > 0.f ? nphm::softplus_beta(v0, beta) : fmaxf(v0, 0.f);
      v1 = beta > 0.f ? nphm::softplus_beta(v1, beta) : fmaxf(v1, 0.f);
      float hb0, hs0, hb1, hs1;
      tc::split_tf32(v0, hb0, hs0);
      tc::split_tf32(v1, hb1, hs1);
      if (pair) {
        *reinterpret_cast<float2*>(ob + at) = make_float2(hb0, hb1);
        *reinterpret_cast<float2*>(os + at) = make_float2(hs0, hs1);
      } else {
        ob[at] = hb0;
        os[at] = hs0;
      }
    }
  }
}

// w: [n_out][K]; xb/xs: the last hidden layer's halves [P][ldx]; y:
// [n_valid][n_out] (point-major, the trunk's output layout).  One warp a
// point, lanes striding over K, a fixed-order shuffle sum.
__global__ void __launch_bounds__(kHeadWarps * 32)
trunk_head_kernel(const float* __restrict__ w, const float* __restrict__ b,
                  const float* __restrict__ xb, const float* __restrict__ xs,
                  int ldx, int K, float* __restrict__ y, int n_out,
                  int64_t n_valid) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kHeadWarps + (threadIdx.x >> 5);
  if (p >= n_valid) return;
  float acc[nphm::kMaxHead] = {0.f, 0.f, 0.f, 0.f};
  for (int k = lane; k < K; k += 32) {
    const float x = xb[p * ldx + k] + xs[p * ldx + k];
#pragma unroll
    for (int o = 0; o < nphm::kMaxHead; ++o)
      if (o < n_out) acc[o] = fmaf(__ldg(w + (size_t)o * K + k), x, acc[o]);
  }
#pragma unroll
  for (int o = 0; o < nphm::kMaxHead; ++o) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int o = 0; o < nphm::kMaxHead; ++o)
      if (o < n_out) y[p * n_out + o] = acc[o] + __ldg(b + o);
  }
}

}  // namespace

// Points per block: the chunk stride P must be a multiple of it.
extern "C" int nphm_trunk_tile() { return kBM; }

// One hidden layer over P points.  wb/ws: the weight halves [O][ldw] (null
// and K = 0 for layer 0); xb/xs: the input halves [P][ldx]; wp: [O][ds] or
// null with ds = 0; pe: [P][ds]; ob/os: the output halves [P][ldo].  ldw,
// ldx and ldo are multiples of 4 (TMA's 16-byte stride rule).
extern "C" int nphm_trunk_layer(const float* wb, const float* ws, int ldw, int K,
                                const float* xb, const float* xs, int ldx,
                                const float* wp, int ds, const float* pe,
                                const float* b, float* ob, float* os, int ldo, int O,
                                int64_t P, float beta, void* stream) {
  CUtensorMap maps[4] = {};
  if (K > 0) {
    int rc = tc::make_map(&maps[0], xb, K, P, ldx, kBK, kBM);
    if (rc == 0) rc = tc::make_map(&maps[1], xs, K, P, ldx, kBK, kBM);
    if (rc == 0) rc = tc::make_map(&maps[2], wb, K, O, ldw, kBK, kBN);
    if (rc == 0) rc = tc::make_map(&maps[3], ws, K, O, ldw, kBK, kBN);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(
      trunk_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((O + kBN - 1) / kBN), (unsigned)(P / kBM));
  trunk_layer_kernel<<<grid, kThr, kSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], K, wp, ds, pe, b, ob, os, ldo, O, beta);
  return (int)cudaGetLastError();
}

extern "C" int nphm_trunk_head(const float* w, const float* b, const float* xb,
                               const float* xs, int ldx, int K, float* y, int n_out,
                               int64_t n_valid, void* stream) {
  const unsigned blocks = (unsigned)((n_valid + kHeadWarps - 1) / kHeadWarps);
  trunk_head_kernel<<<blocks, kHeadWarps * 32, 0, (cudaStream_t)stream>>>(
      w, b, xb, xs, ldx, K, y, n_out, n_valid);
  return (int)cudaGetLastError();
}
