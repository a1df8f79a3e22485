// The NPHM field over one (member, 64-point tile) on the tensor cores: the
// body that K3, K4 and K5 share (sm_90a); K1 walks a tile's live members
// through its forward parts, and K6's passes are built from them.
//
// One block of tc::kMmaWarps warps takes member m's trunk (conditioning
// folded into per-(member, row) biases) over tc::kRows points in
// member-local coordinates.  Three modes:
//
//   kFitFwd   (K3): the forward products, then the head product F.
//   kFitBwd   (K4): the forward products, then one reverse sweep seeded by
//                   wlast * dF down to d(coords), with the per-block partial
//                   cotangents of the two per-row biases.
//   kTrainFwd (K5): the forward products, F, then the reverse sweep seeded
//                   by wlast alone (dF = 1), no bias partials; d(coords) is
//                   written as G = dF/dcoords.
//
// Every hidden product (the layers forward, their transposes in reverse) is
// tc::mm64 at the route P (3xTF32 at tc::kF32, one pass on TF32-rounded
// operands at kTF32, one bf16 MMA a K step of 16 on bf16 weights at
// kBF16Mma): mma.sync over a point-major activation tile in shared memory
// ([64][act_ld(width)]), the member's K-major weights staged by TMA through
// the ring (tc_tile.cuh).  Each warp stores its raw sums; bias and softplus
// then run as a balanced block-wide pass (a thread per column and 16-row
// block), which in the reverse modes also turns the consumed input
// activation into its softplus' (the reverse sweep's only use of it), so
// the reverse epilogues are a multiply, and the reverse sweep overwrites
// each of those with its cotangent in place.  The reverse modes keep every
// hidden activation (184 KB at the NPHM widths: one block per SM); K3
// keeps two, in turn.  The head product and the reverse seed are one pass
// over the last activation, and bias cotangents (tc::colsum64) and
// d(coords) (point_grad) close with warp shuffle trees: every sum has a
// fixed order, so results are deterministic.  Culled (member, tile) pairs
// write zeros.
//
// At kBF16Mma (every mode) and in the fit modes at kF32 (K3, K4) the time
// outside the products is cut (kCuts below; measured with tc::PhaseClock,
// python -m nphm_tpu_torch.kernel_ab --kernels phases).  K5 at F32 and
// every mode at TF32 keep the code above.
#pragma once

#include <type_traits>

#include "mlp_tile.cuh"
#include "tc_tile.cuh"

namespace nphm {
namespace field {

enum Mode : int { kFitFwd, kFitBwd, kTrainFwd };

constexpr int kRows = tc::kRows;              // points per block
constexpr int kThreads = 32 * tc::kMmaWarps;  // threads per block
constexpr int kWarpRows = kRows / tc::kMmaWarps;  // rows a warp owns in the per-point sums

// TMA descriptors of each hidden layer i (1 <= i <= L-2) over all members:
// wt[i] as [A * n_out][ldwt] for the forward product, w[i] as [A * n_in][ldw]
// for the reverse one, in boxes of KS columns x round8(width) rows.
struct Maps {
  CUtensorMap fwd[kMaxLayers - 2];
  CUtensorMap rev[kMaxLayers - 2];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dg[c * 64 + t] += sum_o d[t * ld + o] * wp[o * 3 + c] over the 64 rows of
// a tile: warp w owns rows R w .. R w + R - 1, its lanes stride over o, and
// each of the 3 R sums closes with a fixed-order shuffle tree.
__device__ __forceinline__ void point_grad(const float* d, int ld, int H,
                                           const float* __restrict__ wp, float* dg) {
  constexpr int R = kWarpRows;
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
      const float v = warp_sum(acc[r][c]);
      if (lane == 0) dg[c * kRows + warp * R + r] += v;
    }
}

// The last hidden activation h [64][ld] (width H) against the head weights
// wl [H]: F[t] = sum_o h[t][o] wl[o] (K3, K5), and in the reverse modes the
// seed d[t][o] = wl[o] * dF[t] * softplus'(z[t][o]) in place (dF = 1 for
// K5).  Warp w owns rows R w .. R w + R - 1 and its lanes stride over o, so
// each element is read for the product and then overwritten by one thread;
// the caller's barrier after the pass orders the seed before the reverse
// sweep.  Each F[t] closes with a fixed-order shuffle tree.
template <int MODE>
__device__ __forceinline__ void head_pass(float* h, int ld, int H,
                                          const float* __restrict__ wl, const float* dfs,
                                          float beta, float* __restrict__ f_out) {
  constexpr int R = kWarpRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* rows = h + warp * R * ld;
  float acc[R], df[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.f;
    df[r] = MODE == kFitBwd ? dfs[warp * R + r] : 1.f;
  }
  for (int o = lane; o < H; o += 32) {
    const float w = __ldg(wl + o);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float& v = rows[r * ld + o];
      if (MODE != kFitBwd) acc[r] = fmaf(v, w, acc[r]);
      if (MODE != kFitFwd) v = w * df[r] * tc::softplus_grad_fast(v, beta);
    }
  }
  if (MODE != kFitBwd) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) f_out[warp * R + r] = s;
    }
  }
}

// The TMA ring of a block: kRingStages stages of `stage` floats from `base`
// rounded up to 1 KB (the swizzle's period), then its full and empty
// mbarriers.  init_ring (thread 0) arms them; the caller synchronises the
// block before the first product.
__device__ __forceinline__ tc::Ring make_ring(float* base, int stage) {
  tc::Ring ring;
  ring.buf = base + ((1024u - (tc::smem_u32(base) & 1023u)) & 1023u) / sizeof(float);
  ring.stage = stage;
  ring.full = reinterpret_cast<uint64_t*>(ring.buf + tc::kRingStages * stage);
  ring.empty = ring.full + tc::kRingStages;
  ring.slices = ring.issued = 0;
  return ring;
}

__device__ __forceinline__ void init_ring(const tc::Ring& ring) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < tc::kRingStages; ++s) {
      tc::mbar_init(&ring.full[s], 1);
      tc::mbar_init(&ring.empty[s], tc::kMmaWarps);
    }
    tc::mbar_fence_init();
  }
}

// The cuts outside the products (kCuts, by mode and route): layer 0 and the
// bias passes load a column's bias once for the block's one conditioning
// row and unroll its rows; the reverse products' pre hook takes softplus'
// of the activation it gathers, so no sweep turns them beforehand; K4's
// bias column sums run a thread per column; the first product's first
// slices are issued before layer 0.  Each was kept by a same-call A/B
// against the passes it replaced (PERF.md: kernel_ab --kernels low at
// kBF16Mma, every mode; --kernels fit32 in the fit modes at tc::kF32); K5
// at F32 and every mode at kTF32 keep those passes.
template <int MODE, int P>
constexpr bool kCuts = P == tc::kBF16Mma || ((MODE == kFitFwd || MODE == kFitBwd) &&
                                              P == tc::kF32);

// Zero columns [w, w rounded up to 8) of a [64][ld] activation: the
// products read activation columns up to the next multiple of 8.
__device__ __forceinline__ void zero_pad(float* h, int ld, int w) {
  const int pad = ((w + 7) & ~7) - w;
  for (int it = threadIdx.x; it < pad * kRows; it += blockDim.x)
    h[(it / pad) * ld + w + it % pad] = 0.f;
}

// Layer 0 of member m over a 64-point tile from its 3 point inputs xs
// ([3][64]): h = softplus(W0 x + b0[row]) into [64][ld], pad columns
// zeroed.  A thread per output column and 16-row block, its rows
// independent.  With kOnce (kCuts) the block's 64 points share one
// conditioning row (the entry points require row_len to be a multiple of
// 64), so a thread loads its column's bias once and runs its rows
// unrolled; else a load per point.
template <bool kOnce = false>
__device__ __forceinline__ void layer0_pass(const Trunk& tr, int m, const float* xs,
                                            const int* rows, float* h, int ld) {
  constexpr int T = kRows;
  const int H0 = (int)tr.n_out[0];
  const float beta = (float)tr.beta;
  const float inv_beta = 1.f / beta;
  const float* __restrict__ w = tr.w[0] + m * tr.w_ms[0];
  const float* __restrict__ b = tr.b[0] + m * tr.b_ms[0];
  const int64_t brs = tr.b_rs[0];
  for (int it = threadIdx.x; it < H0 * 4; it += blockDim.x) {
    const int o = it % H0;
    const int l0 = (it / H0) * 16;
    const float w0 = w[o * 3], w1 = w[o * 3 + 1], w2 = w[o * 3 + 2];
    if constexpr (kOnce) {
      const float bo = __ldg(b + rows[0] * brs + o);
#pragma unroll
      for (int l = l0; l < l0 + 16; ++l) {
        float z = w0 * xs[l];
        z = fmaf(w1, xs[T + l], z);
        z = fmaf(w2, xs[2 * T + l], z);
        h[l * ld + o] = tc::softplus_fast(z + bo, beta, inv_beta);
      }
    } else {
#pragma unroll 4
      for (int l = l0; l < l0 + 16; ++l) {
        float z = w0 * xs[l];
        z = fmaf(w1, xs[T + l], z);
        z = fmaf(w2, xs[2 * T + l], z);
        h[l * ld + o] = tc::softplus_fast(z + __ldg(b + rows[l] * brs + o), beta, inv_beta);
      }
    }
  }
  zero_pad(h, ld, H0);
}

// Hidden layer i of member m over the raw sums `out` ([64][ld]) in place:
// bias, the skip layer's point term and softplus, pad columns zeroed; a
// thread per column and 16-row block (balanced, unlike the MMA epilogue).
// With kOnce, as layer0_pass: the bias loaded once, the rows unrolled, and
// the point term only at the skip layer.
template <bool kOnce = false>
__device__ __forceinline__ void bias_pass(const Trunk& tr, int i, int m, const float* xs,
                                          const int* rows, float* out, int ld) {
  constexpr int T = kRows;
  const int H = (int)tr.n_out[i];
  const float beta = (float)tr.beta;
  const float inv_beta = 1.f / beta;
  const float* __restrict__ b = tr.b[i] + m * tr.b_ms[i];
  const int64_t brs = tr.b_rs[i];
  const float* __restrict__ wp = i == (int)tr.skip ? tr.wp + m * tr.wp_ms : nullptr;
  for (int it = threadIdx.x; it < H * 4; it += blockDim.x) {
    const int o = it % H;
    const int l0 = (it / H) * 16;
    float w0 = 0.f, w1 = 0.f, w2 = 0.f;
    if (wp != nullptr) {
      w0 = wp[o * 3];
      w1 = wp[o * 3 + 1];
      w2 = wp[o * 3 + 2];
    }
    if constexpr (kOnce) {
      const float bo = __ldg(b + rows[0] * brs + o);
      if (wp != nullptr) {
#pragma unroll
        for (int l = l0; l < l0 + 16; ++l) {
          float z = out[l * ld + o] + bo;
          z = fmaf(w0, xs[l], z);
          z = fmaf(w1, xs[T + l], z);
          z = fmaf(w2, xs[2 * T + l], z);
          out[l * ld + o] = tc::softplus_fast(z, beta, inv_beta);
        }
      } else {
#pragma unroll
        for (int l = l0; l < l0 + 16; ++l)
          out[l * ld + o] = tc::softplus_fast(out[l * ld + o] + bo, beta, inv_beta);
      }
    } else {
#pragma unroll 4
      for (int l = l0; l < l0 + 16; ++l) {
        float z = out[l * ld + o] + __ldg(b + rows[l] * brs + o);
        z = fmaf(w0, xs[l], z);
        z = fmaf(w1, xs[T + l], z);
        z = fmaf(w2, xs[2 * T + l], z);
        out[l * ld + o] = tc::softplus_fast(z, beta, inv_beta);
      }
    }
  }
  zero_pad(out, ld, H);
}

// dst[o] = sum over the 64 rows of d[t * ld + o], o < H, where kCuts
// (tc::colsum64 elsewhere): a thread per column, its rows in four
// interleaved partial sums added in a fixed order (deterministic), so the
// warps past the columns go on to point_grad at once.
__device__ __forceinline__ void colsum64_cols(const float* d, int ld, int H,
                                              float* __restrict__ dst) {
  for (int o = threadIdx.x; o < H; o += blockDim.x) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = 0; r < kRows; r += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] += d[(r + k) * ld + o];
    dst[o] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

// The block's work in MODE.  coords: [A][3][M]; dF: [A][M] (K4); active:
// [M / cull_tile][A]; F: [A][M] (K3, K5); dcoords: [A][3][M] (K4; G for
// K5); part0 / part_s: [A][M / 64][H0 or HS] (K4).  Grid (members, M / 64),
// members fastest, so the blocks in flight read all members' weights from
// L2 rather than all crowding one member's.  Shared memory: the
// activations (act_floats), xs [3][64], dg [3][64], dF [64], rows [64],
// then, 1 KB aligned, the ring (tc::kRingStages stages of `stage` floats)
// and its full and empty mbarriers.
template <int KS, int MODE, int P>
__device__ __forceinline__ void tile(const Trunk& tr, const Maps& maps,
                                     const float* __restrict__ coords,
                                     const float* __restrict__ dF,
                                     const int* __restrict__ active, float* __restrict__ F,
                                     float* __restrict__ dcoords, float* __restrict__ part0,
                                     float* __restrict__ part_s, int64_t M, int n_members,
                                     int cull_tile, int act_floats, int stage) {
  constexpr bool kReverse = MODE != kFitFwd;
  constexpr int T = kRows;
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
  float* out0 = MODE == kFitBwd ? part0 + (m * n_blk + blk) * H0 : nullptr;
  float* out_s = MODE == kFitBwd ? part_s + (m * n_blk + blk) * HS : nullptr;

  if (active[(p0 / cull_tile) * n_members + m] == 0) {
    if (t < T) {
      if (MODE != kFitBwd) F[m * M + p0 + t] = 0.f;
      if (kReverse)
        for (int c = 0; c < 3; ++c) dcoords[(m * 3 + c) * M + p0 + t] = 0.f;
    }
    if (MODE == kFitBwd) {
      for (int o = t; o < H0; o += blockDim.x) out0[o] = 0.f;
      for (int o = t; o < HS; o += blockDim.x) out_s[o] = 0.f;
    }
    return;
  }

  // activation i at float offset ho[i], row stride ld[i]: each in its own
  // buffer when a reverse sweep follows, else alternating between two.
  // Offsets, not pointers, so that every access stays a shared one.
  int ho[kMaxLayers];
  int ld[kMaxLayers];
  {
    int cur = 0;
    for (int i = 0; i < L - 1; ++i) {
      ld[i] = tc::act_ld((int)tr.n_out[i]);
      ho[i] = kReverse ? cur : (i & 1) * (act_floats / 2);
      cur += T * ld[i];
    }
  }
  float* xs = smem + act_floats;
  float* dg = xs + 3 * T;
  float* dfs = dg + 3 * T;
  int* rows = reinterpret_cast<int*>(dfs + T);
  tc::Ring ring = make_ring(dfs + 2 * T, stage);
  // the block's products in order: forward i = 1..L-2, then (reverse
  // modes) reverse i = L-2..1
  auto fwd = [&](int i) {
    return tc::Operand{&maps.fwd[i - 1], m * (int)tr.n_out[i], (int)tr.n_in[i],
                       (int)tr.n_out[i]};
  };
  auto rev = [&](int i) {
    return tc::Operand{&maps.rev[i - 1], m * (int)tr.n_in[i], (int)tr.n_out[i],
                       (int)tr.n_in[i]};
  };

  // phases of the block (tc::PhaseClock, a no-op in the default build)
  enum { kSetup, kLayer0, kFwdProducts, kBias, kSweep, kHead, kRevSums, kRevProducts, kTail };
  tc::PhaseClock clk;
  clk.start();
  if (t < T) {
    for (int c = 0; c < 3; ++c) {
      xs[c * T + t] = coords[(m * 3 + c) * M + p0 + t];
      dg[c * T + t] = 0.f;
    }
    if (MODE == kFitBwd) dfs[t] = dF[m * M + p0 + t];
    rows[t] = (int)((p0 + t) / tr.row_len);
  }
  init_ring(ring);
  __syncthreads();
  if constexpr (kCuts<MODE, P>) {
    // the first product's first slices land while layer 0 runs
    if (t == tc::kProducer && L > 2)
      tc::ring_issue<KS, tc::kRingStages, P>(ring, fwd(1), nullptr, tc::kRingStages - 1);
  }
  clk.mark(kSetup);

  // forward: layer 0 from the 3 point inputs, then the hidden products
  layer0_pass<kCuts<MODE, P>>(tr, m, xs, rows, smem + ho[0], ld[0]);
  __syncthreads();
  clk.mark(kLayer0);
  for (int i = 1; i < L - 1; ++i) {
    // each warp stores its raw sums, then the block applies bias, point
    // term and softplus in a balanced pass (a thread per column and 16-row
    // block) and, before a reverse sweep, turns the consumed input h_{i-1}
    // into softplus'(z_{i-1}) (where kCuts the reverse products' pre hook
    // does that as it gathers h_{i-1}, so no pass goes over it here)
    float* out = smem + ho[i];
    const int ldo = ld[i];
    tc::Operand next{};
    const bool more = i + 1 < L - 1 || kReverse;
    if (i + 1 < L - 1)
      next = fwd(i + 1);
    else if (kReverse)
      next = rev(L - 2);
    tc::mm64<KS, P>(smem + ho[i - 1], ld[i - 1], fwd(i), more ? &next : nullptr, ring,
                    [&](int, int) { return 0.f; },
                    [&](int l, int o, float acc, float) { out[l * ldo + o] = acc; });
    __syncthreads();
    clk.mark(kFwdProducts);
    bias_pass<kCuts<MODE, P>>(tr, i, m, xs, rows, out, ldo);
    clk.mark(kBias, true);
    if (kReverse && !kCuts<MODE, P>) {
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
    }
    __syncthreads();
    clk.mark(kSweep);
  }

  // the head product F (K3, K5) and the reverse seed (K4, K5) in one pass
  head_pass<MODE>(smem + ho[L - 2], ld[L - 2], (int)tr.n_out[L - 2],
                  tr.w[L - 1] + m * tr.w_ms[L - 1], dfs, beta,
                  MODE != kFitBwd ? F + m * M + p0 : nullptr);
  if (!kReverse) return;
  __syncthreads();
  clk.mark(kHead);

  // activation L-2 now holds d_{L-2} = u * softplus'(z), the others
  // softplus'(z_i) (h_i where kCuts); walk down to layer 0
  for (int i = L - 2; i >= 0; --i) {
    const int H = (int)tr.n_out[i];
    float* d = smem + ho[i];
    if (i == skip || i == 0) {
      // (K4) bias cotangent partials; d(coords) += d_i . Wp_i (3 point inputs)
      if constexpr (MODE == kFitBwd) {
        if constexpr (kCuts<MODE, P>)
          colsum64_cols(d, ld[i], H, i == 0 ? out0 : out_s);
        else
          tc::colsum64(d, ld[i], H, i == 0 ? out0 : out_s);
      }
      point_grad(d, ld[i], H, i == 0 ? tr.w[0] + m * tr.w_ms[0] : tr.wp + m * tr.wp_ms,
                 dg);
      clk.mark(kRevSums, true);
    }
    if (i > 0) {
      // u_{i-1} = d_i W_i, then d_{i-1} = u_{i-1} * softplus'(z_{i-1}) in place
      float* prev = smem + ho[i - 1];
      const int ldv = ld[i - 1];
      const tc::Operand next = i > 1 ? rev(i - 1) : tc::Operand{};
      tc::mm64<KS, P>(d, ld[i], rev(i), i > 1 ? &next : nullptr, ring,
                      [&](int l, int k) {
                        const float v = prev[l * ldv + k];
                        if constexpr (kCuts<MODE, P>)
                          return tc::softplus_grad_fast(v, beta);  // v = h_{i-1}
                        else
                          return v;
                      },
                      [&](int l, int k, float acc, float g) { prev[l * ldv + k] = acc * g; });
    }
    __syncthreads();
    clk.mark(kRevProducts);
  }
  if (t < T)
    for (int c = 0; c < 3; ++c) dcoords[(m * 3 + c) * M + p0 + t] = dg[c * T + t];
  clk.mark(kTail);
#ifdef NPHM_PHASE_CLOCKS
  if (t == 0) atomicAdd(&tc::phase_cycles[tc::kBlockSlot], 1ull);
#endif
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// A launch's shared memory: the activation floats, the ring's K slice
// width (the widest of max_ks, 16 and 8 whose ring fits beside the
// activations), the floats of one ring stage, and the bytes in all.
struct Launch {
  int act_floats;
  int ks;
  int stage;
  int smem;
};

// Size a launch over trunk *tr and encode its weights' tensor maps: the
// forward maps, and the reverse ones when `reverse` (K4-K6).  The
// activations take every layer's tile (reverse) or two of the widest, or,
// when act_bufs > 0, act_bufs of the widest (K6); point_floats floats of
// per-point values follow them, then the ring.  Returns 0, a runtime error
// code, or make_map's code for a refused descriptor.  The weights' leading
// dims ldw/ldwt are multiples of 8 with zero columns past the width (at
// route tc::kBF16Mma: bf16, multiples of 16, K in kPerm order, and a ring
// slice of ks words holds 2 ks of them), and every product is at most
// tc::kMaxN wide.  max_ks: the widest K slice the caller has an
// instantiation for (16, or 32 for K1).
inline int setup(const Trunk* tr, int n_members, bool reverse, Maps* maps, Launch* ln,
                 int act_bufs = 0, int point_floats = 8 * kRows, int max_ks = 16,
                 int route = tc::kF32) {
  const int L = (int)tr->n_layers;
  const bool bf16 = route == tc::kBF16Mma;
  int act_floats = 0, widest = 0, nmax = 8;
  for (int i = 0; i < L - 1; ++i) {
    const int a = kRows * tc::act_ld((int)tr->n_out[i]);
    act_floats += a;
    widest = a > widest ? a : widest;
    if (i > 0) {
      nmax = tr->n_out[i] > nmax ? (int)tr->n_out[i] : nmax;
      nmax = tr->n_in[i] > nmax ? (int)tr->n_in[i] : nmax;
    }
  }
  if (act_bufs > 0)
    act_floats = act_bufs * widest;
  else if (!reverse)
    act_floats = 2 * widest;
  if (nmax > tc::kMaxN) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int fixed = (int)sizeof(float) * (act_floats + point_floats) + 1024 +
                    16 * tc::kRingStages;
  auto ring_bytes = [&](int ks) {
    return (int)sizeof(float) * tc::kRingStages *
           (ks == 32 ? tc::stage_floats<32>(nmax)
                     : ks == 16 ? tc::stage_floats<16>(nmax) : tc::stage_floats<8>(nmax));
  };
  ln->act_floats = act_floats;
  ln->ks = max_ks;
  while (ln->ks > 8 && fixed + ring_bytes(ln->ks) > optin) ln->ks /= 2;
  ln->stage = ring_bytes(ln->ks) / ((int)sizeof(float) * tc::kRingStages);
  ln->smem = fixed + ring_bytes(ln->ks);
  const int box = bf16 ? 2 * ln->ks : ln->ks;
  for (int i = 1; i < L - 1; ++i) {
    const int n_in = (int)tr->n_in[i], n_out = (int)tr->n_out[i];
    int rc = tc::make_map(&maps->fwd[i - 1], tr->wt[i], (int)tr->ldwt[i],
                          (int64_t)n_members * n_out, (int)tr->ldwt[i], box, (n_out + 7) & ~7,
                          bf16);
    if (rc == 0 && reverse)
      rc = tc::make_map(&maps->rev[i - 1], tr->w[i], (int)tr->ldw[i],
                        (int64_t)n_members * n_in, (int)tr->ldw[i], box, (n_in + 7) & ~7, bf16);
    if (rc != 0) return rc;
  }
  return 0;
}

// f(std::integral_constant<int, R>()) for the route code `route` among the
// instantiated routes Rs (tc::Precision and the routes beside it, chosen by
// the host: ops/fit_fields.py ROUTES); cudaErrorInvalidValue for any other
// code, so a route the entry point does not instantiate never runs.
template <int... Rs, class F>
inline int with_route(int route, F f) {
  int rc = (int)cudaErrorInvalidValue;
  ((route == Rs ? (rc = f(std::integral_constant<int, Rs>()), true) : false) || ...);
  return rc;
}

// out[0..3] = registers a thread, local (spilled) bytes a thread, dynamic
// shared memory and resident blocks per SM of `kernel` launched with
// `threads` threads and `smem` bytes; returns a runtime error code.
template <class Kernel>
inline int occupancy(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

// Launch the instantiation for ln's slice width (k16 or k8) over (members,
// M / 64 tiles) with ln's shared memory; returns cudaGetLastError().
template <class Kernel, class... Args>
inline int launch(Kernel k16, Kernel k8, const Launch& ln, int n_members, int64_t M,
                  void* stream, Args... args) {
  const Kernel kernel = ln.ks == 16 ? k16 : k8;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ln.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_members, (unsigned)(M / kRows));
  kernel<<<grid, kThreads, ln.smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace field
}  // namespace nphm
