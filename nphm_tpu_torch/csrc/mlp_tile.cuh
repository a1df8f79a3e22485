// Shared device routines for the port's MLP kernels (sm_90a, fp32 SIMT).
//
// Every kernel of this package pushes a tile of points through a
// DeepSDF-style trunk whose conditioning was folded into biases on the host:
//
//   layer 0        : 3 point inputs            -> H0      (+ bias0, per row)
//   layers 1..L-2  : hidden                    -> hidden  (+ bias)
//   layer `skip`   : hidden + 3 point inputs   -> hidden  (+ biasS, per row)
//   layer L-1      : hidden                    -> n_head  (the head)
//
// Softplus(beta) follows every layer but the head.  Activations live in
// shared memory, feature-major (act[f * T + t] for lane t of a T-lane
// tile); weights are read from global memory and stay resident in the 50 MB
// L2 across blocks (the 39 expanded ensemble members are ~13 MB, the 6x512
// deformation trunk ~4.3 MB).  An ensemble is described by per-member
// strides, so one `Trunk` covers both a single trunk (strides 0) and all
// members of the NPHM ensemble.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nphm {

constexpr int kMaxLayers = 12;
constexpr int kMaxHead = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Host mirror: nphm_tpu_torch/ops/_build.py::Trunk (all fields 8 bytes).
struct Trunk {
  int64_t n_layers;  // L linear layers, layer L-1 is the head
  int64_t skip;      // index of the skip layer, 1 <= skip < L-1
  int64_t row_len;   // lanes per conditioning row: row(p) = p / row_len
  double beta;       // softplus sharpness
  int64_t n_in[kMaxLayers];   // contraction width (hidden part; 3 for layer 0)
  int64_t n_out[kMaxLayers];  // output width
  int64_t ldw[kMaxLayers];    // leading dim of w[i] (see below)
  int64_t w_ms[kMaxLayers];   // member stride of w[i], floats
  int64_t ldwt[kMaxLayers];   // leading dim of wt[i]
  int64_t wt_ms[kMaxLayers];  // member stride of wt[i]
  int64_t b_ms[kMaxLayers];   // member stride of b[i]
  int64_t b_rs[kMaxLayers];   // row stride of b[i] (0 = row-constant)
  int64_t wp_ms;              // member stride of wp
  // w[0]: [H0][3]; w[i], 0<i<L-1: W^T as [n_in][ldw]; w[L-1]: [n_in][n_head]
  const float* w[kMaxLayers];
  // wt[i], 0<i<L-1: W as [n_out][ldwt] (hidden columns), for reverse sweeps
  const float* wt[kMaxLayers];
  const float* b[kMaxLayers];  // may be null for the head
  const float* wp;             // skip layer's point weights [n_out][3]
};

__device__ __forceinline__ float softplus_beta(float x, float beta) {
  // jax.nn.softplus form (logaddexp), linear above beta*x = 20 like torch
  const float bx = beta * x;
  if (bx > 20.f) return x;
  return (fmaxf(bx, 0.f) + log1pf(expf(-fabsf(bx)))) / beta;
}

// d softplus / dz expressed through the activation h = softplus(z).
__device__ __forceinline__ float softplus_grad(float h, float beta) {
  return 1.f - expf(-beta * h);
}

// out[o][t] = epi(o, t, sum_k W[k * ldw + o] * in[k * T + t]) for o < n_out.
// Each thread owns a TO x TL register tile; the TL-lane groups of one output
// group sit in one warp, so each weight row is read once per block.
// Requires: ldw % 4 == 0, ldw >= ceil(n_out / TO) * TO (zero padded),
// W 16-byte aligned, `in` 16-byte aligned.
template <int T, int TO, int TL, class Epi>
__device__ __forceinline__ void tile_mm(const float* __restrict__ W, int ldw,
                                        int n_in, int n_out, const float* in,
                                        Epi epi) {
  static_assert(T % TL == 0 && TO % 4 == 0 && TL % 4 == 0, "tile shape");
  constexpr int LG = T / TL;
  const int n_og = (n_out + TO - 1) / TO;
  for (int item = threadIdx.x; item < n_og * LG; item += blockDim.x) {
    const int o0 = (item / LG) * TO;
    const int t0 = (item % LG) * TL;
    float acc[TO][TL];
#pragma unroll
    for (int j = 0; j < TO; ++j)
#pragma unroll
      for (int l = 0; l < TL; ++l) acc[j][l] = 0.f;
    const float* wrow = W + o0;
    const float* irow = in + t0;
#pragma unroll 2
    for (int k = 0; k < n_in; ++k) {
      float wv[TO];
      float iv[TL];
#pragma unroll
      for (int j = 0; j < TO; j += 4) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(wrow + (size_t)k * ldw + j));
        wv[j] = v.x; wv[j + 1] = v.y; wv[j + 2] = v.z; wv[j + 3] = v.w;
      }
#pragma unroll
      for (int l = 0; l < TL; l += 4) {
        const float4 v = *reinterpret_cast<const float4*>(irow + k * T + l);
        iv[l] = v.x; iv[l + 1] = v.y; iv[l + 2] = v.z; iv[l + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TO; ++j)
#pragma unroll
        for (int l = 0; l < TL; ++l) acc[j][l] = fmaf(wv[j], iv[l], acc[j][l]);
    }
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      if (o0 + j < n_out) {
#pragma unroll
        for (int l = 0; l < TL; ++l) epi(o0 + j, t0 + l, acc[j][l]);
      }
    }
  }
}

// Narrow head: out = epi(o, t, sum_k W[k * n_out + o] * in[k * T + t]) for
// n_out <= kMaxHead.  Warps split the contraction; partials meet in `part`
// ([kWarps][kMaxHead][T] floats).  Ends with every thread synchronised.
template <int T, class Epi>
__device__ __forceinline__ void tile_head(const float* __restrict__ W, int n_in,
                                          int n_out, const float* in,
                                          float* part, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = warp * n_in / kWarps;
  const int k1 = (warp + 1) * n_in / kWarps;
  for (int t = lane; t < T; t += 32) {
    float acc[kMaxHead] = {0.f, 0.f, 0.f, 0.f};
    for (int k = k0; k < k1; ++k) {
      const float x = in[k * T + t];
#pragma unroll
      for (int o = 0; o < kMaxHead; ++o)
        if (o < n_out) acc[o] = fmaf(__ldg(W + k * n_out + o), x, acc[o]);
    }
#pragma unroll
    for (int o = 0; o < kMaxHead; ++o)
      if (o < n_out) part[(warp * kMaxHead + o) * T + t] = acc[o];
  }
  __syncthreads();
  for (int it = threadIdx.x; it < n_out * T; it += blockDim.x) {
    const int o = it / T;
    const int t = it - o * T;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[(w * kMaxHead + o) * T + t];
    epi(o, t, s);
  }
  __syncthreads();
}

// Forward sweep of member m over one tile.  xs: [3][T] point inputs;
// rows: [T] conditioning row of each lane; hs[i]: destination of layer i's
// activation ([n_out_i][T]); head: [n_head][T] receives the head output
// (plus its bias when b[L-1] is set) unless `with_head` is false.
// Expects xs/rows visible to all threads; ends synchronised.
template <int T, int TO, int TL>
__device__ __forceinline__ void trunk_forward(const Trunk& tr, int m,
                                              const float* xs, const int* rows,
                                              float* const* hs, float* head,
                                              float* part, bool with_head) {
  const int L = (int)tr.n_layers;
  const float beta = (float)tr.beta;
  {
    const int H = (int)tr.n_out[0];
    const float* w = tr.w[0] + m * tr.w_ms[0];
    const float* b = tr.b[0] + m * tr.b_ms[0];
    const int64_t brs = tr.b_rs[0];
    float* out = hs[0];
    for (int it = threadIdx.x; it < H * T; it += blockDim.x) {
      const int o = it / T;
      const int t = it - o * T;
      float z = w[o * 3] * xs[t];
      z = fmaf(w[o * 3 + 1], xs[T + t], z);
      z = fmaf(w[o * 3 + 2], xs[2 * T + t], z);
      out[o * T + t] = softplus_beta(z + b[rows[t] * brs + o], beta);
    }
    __syncthreads();
  }
  for (int i = 1; i < L - 1; ++i) {
    const float* W = tr.w[i] + m * tr.w_ms[i];
    const float* b = tr.b[i] + m * tr.b_ms[i];
    const int64_t brs = tr.b_rs[i];
    float* out = hs[i];
    if (i == tr.skip) {
      const float* wp = tr.wp + m * tr.wp_ms;
      tile_mm<T, TO, TL>(W, (int)tr.ldw[i], (int)tr.n_in[i], (int)tr.n_out[i],
                         hs[i - 1], [&](int o, int t, float acc) {
                           float p = wp[o * 3] * xs[t];
                           p = fmaf(wp[o * 3 + 1], xs[T + t], p);
                           p = fmaf(wp[o * 3 + 2], xs[2 * T + t], p);
                           out[o * T + t] = softplus_beta(
                               acc + p + b[rows[t] * brs + o], beta);
                         });
    } else {
      tile_mm<T, TO, TL>(W, (int)tr.ldw[i], (int)tr.n_in[i], (int)tr.n_out[i],
                         hs[i - 1], [&](int o, int t, float acc) {
                           out[o * T + t] =
                               softplus_beta(acc + b[rows[t] * brs + o], beta);
                         });
    }
    __syncthreads();
  }
  if (with_head) {
    const float* W = tr.w[L - 1] + m * tr.w_ms[L - 1];
    const float* hb = tr.b[L - 1] ? tr.b[L - 1] + m * tr.b_ms[L - 1] : nullptr;
    tile_head<T>(W, (int)tr.n_in[L - 1], (int)tr.n_out[L - 1], hs[L - 2], part,
                 [&](int o, int t, float s) {
                   head[o * T + t] = hb ? s + hb[o] : s;
                 });
  }
}

}  // namespace nphm
