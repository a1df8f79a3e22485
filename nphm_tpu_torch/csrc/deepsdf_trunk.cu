// K7: forward, no-grad evaluation of a conditioned DeepSDF trunk.
//
// Replaces nphm_tpu/ops/pallas_mlp.py::deepsdf_trunk_pallas (pl.pallas_call
// at :191, body _make_kernel).  The TPU kernel keeps one lane tile's hidden
// state resident in VMEM and streams one layer's weights per grid step.
// That cannot carry over: a 1024-wide fp32 hidden state of even 32 lanes is
// 128 KB, two of them exceed a block's 227 KB, and each block would stream
// all 33 MB of NPM weights for 32 points.  Here the trunk runs as one launch
// per layer over a chunk of points, activations ping-ponging between two
// feature-major scratch buffers ([features][points]) that the wrapper
// (ops/trunk.py) allocates:
//
//   trunk_layer_kernel : out[o][p] = act(sum_k Wt[k][o] x[k][p]
//                                       + sum_j Wp[o][j] pe[j][p] + b[o])
//   trunk_head_kernel  : y[p][o]   = sum_k W[o][k] x[k][p] + b[o], o < 4
//
// The conditioning code is constant along points, so its layer-0 and
// skip-layer contributions are folded into b on the host, and 1/sqrt(2) into
// the skip layer's weights; layer 0 is the same kernel with K = 0 (only the
// point term Wp . pe), the skip layer adds the point term to a full product.
//
// Bound on this card: operations.  NPM's 8x1024 trunk is ~12.6 MFLOP a point
// against ~8 KB a point and layer of activation traffic (read once, written
// once), two orders of magnitude above the H100's fp32 ridge.  Design: a
// register-tiled fp32 SIMT product, 128 outputs x 128 points a block, 256
// threads with an 8x8 tile each, both operands staged through double-
// buffered shared memory in K slices of 8 with a register prefetch of the
// next slice; the bias, point term and Softplus(beta) (ReLU for beta <= 0)
// are fused into the epilogue.  Output tiles of one point tile are adjacent
// in the grid, so a point tile's activations are read from HBM once and
// reused from L2.  No atomics: each output is written once, deterministic.
// Tensor cores (3xTF32 / bf16x3 splits through wgmma, TMA staging) are
// later work.
#include "mlp_tile.cuh"

namespace {

constexpr int kBM = 128;  // outputs per block
constexpr int kBN = 128;  // points per block
constexpr int kBK = 8;    // contraction slice staged in shared memory
constexpr int kThr = 256;

// Wt: [K][ldw] (ldw a multiple of kBM, columns >= O zero); x: [K][P];
// wp: [O][ds]; pe: [ds][P]; b: [O]; out: [O][P]; P a multiple of kBN.
__global__ void __launch_bounds__(kThr, 2)
trunk_layer_kernel(const float* __restrict__ wt, int ldw, int K,
                   const float* __restrict__ x, const float* __restrict__ wp,
                   int ds, const float* __restrict__ pe,
                   const float* __restrict__ b, float* __restrict__ out, int O,
                   int64_t P, float beta) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // point group
  const int ty = tid >> 4;   // output group
  const int o0 = blockIdx.x * kBM;
  const int64_t p0 = (int64_t)blockIdx.y * kBN;
  // each thread stages one float4 of each operand per K slice
  const int lk = tid >> 5;
  const int lc = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_kt = (K + kBK - 1) / kBK;
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 rb = ra;
  auto fetch = [&](int kt) {
    const int k = kt * kBK + lk;
    if (k < K) {
      ra = __ldg(reinterpret_cast<const float4*>(wt + (size_t)k * ldw + o0 + lc));
      rb = __ldg(reinterpret_cast<const float4*>(x + (size_t)k * P + p0 + lc));
    } else {
      ra = rb = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stage = [&](int buf) {
    *reinterpret_cast<float4*>(&As[buf][lk][lc]) = ra;
    *reinterpret_cast<float4*>(&Bs[buf][lk][lc]) = rb;
  };
  if (n_kt > 0) {
    fetch(0);
    stage(0);
  }
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_kt) fetch(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous iteration's barrier
    if (kt + 1 < n_kt) stage(cur ^ 1);
    __syncthreads();
  }

  // point term: layer 0 (its whole product) and the skip layer
  for (int j = 0; j < ds; ++j) {
    const float* pr = pe + (size_t)j * P + p0;
    const float4 q0 = __ldg(reinterpret_cast<const float4*>(pr + tx * 4));
    const float4 q1 = __ldg(reinterpret_cast<const float4*>(pr + 64 + tx * 4));
    const float pv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = o0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      const float w = o < O ? __ldg(wp + (size_t)o * ds + j) : 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(w, pv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = o0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (o >= O) continue;
    const float bo = __ldg(b + o);
    float v[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float z = acc[i][jj] + bo;
      v[jj] = beta > 0.f ? nphm::softplus_beta(z, beta) : fmaxf(z, 0.f);
    }
    float* orow = out + (size_t)o * P + p0;
    *reinterpret_cast<float4*>(orow + tx * 4) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(orow + 64 + tx * 4) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
}

// w: [n_out][K]; x: [K][P]; y: [n_valid][n_out] (point-major, the trunk's
// output layout).  One thread per point; the head weights are warp-uniform.
__global__ void __launch_bounds__(kThr)
trunk_head_kernel(const float* __restrict__ w, const float* __restrict__ b,
                  const float* __restrict__ x, int K, float* __restrict__ y,
                  int n_out, int64_t P, int64_t n_valid) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_valid) return;
  float acc[nphm::kMaxHead] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const float xv = x[(size_t)k * P + p];
#pragma unroll
    for (int o = 0; o < nphm::kMaxHead; ++o)
      if (o < n_out) acc[o] = fmaf(__ldg(w + (size_t)o * K + k), xv, acc[o]);
  }
#pragma unroll
  for (int o = 0; o < nphm::kMaxHead; ++o)
    if (o < n_out) y[p * n_out + o] = acc[o] + __ldg(b + o);
}

}  // namespace

// Points per block: the chunk stride P must be a multiple of it, and the
// transposed weights' leading dimension a multiple of the output tile.
extern "C" int nphm_trunk_tile() { return kBN; }

extern "C" int nphm_trunk_layer(const float* wt, int ldw, int K, const float* x,
                                const float* wp, int ds, const float* pe,
                                const float* b, float* out, int O, int64_t P,
                                float beta, void* stream) {
  const dim3 grid((unsigned)((O + kBM - 1) / kBM), (unsigned)(P / kBN));
  trunk_layer_kernel<<<grid, kThr, 0, (cudaStream_t)stream>>>(
      wt, ldw, K, x, wp, ds, pe, b, out, O, P, beta);
  return (int)cudaGetLastError();
}

extern "C" int nphm_trunk_head(const float* w, const float* b, const float* x,
                               int K, float* y, int n_out, int64_t P,
                               int64_t n_valid, void* stream) {
  const unsigned blocks = (unsigned)((n_valid + kThr - 1) / kThr);
  trunk_head_kernel<<<blocks, kThr, 0, (cudaStream_t)stream>>>(
      w, b, x, K, y, n_out, P, n_valid);
  return (int)cudaGetLastError();
}
