// Shared definitions for the port's MLP kernels (sm_90a).
//
// Every kernel of this package pushes a tile of points through a
// DeepSDF-style trunk whose conditioning was folded into biases on the host:
//
//   layer 0        : 3 point inputs            -> H0      (+ bias0, per row)
//   layers 1..L-2  : hidden                    -> hidden  (+ bias)
//   layer `skip`   : hidden + 3 point inputs   -> hidden  (+ biasS, per row)
//   layer L-1      : hidden                    -> n_head  (the head)
//
// Softplus(beta) follows every layer but the head.  An ensemble is
// described by per-member strides, so one `Trunk` covers both a single
// trunk (strides 0) and all members of the NPHM ensemble.  The products run
// on the tensor cores (tc_tile.cuh, field_tile.cuh); weights stay resident
// in the 50 MB L2 across blocks (the 39 expanded ensemble members are
// ~13 MB, the 6x512 deformation trunk ~4.3 MB).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nphm {

constexpr int kMaxLayers = 12;
constexpr int kMaxHead = 4;

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
  // w[0]: [H0][3]; w[i], 0<i<L-1: W^T as [n_in][ldw] (reverse products);
  // w[L-1]: [n_in][n_head]
  const float* w[kMaxLayers];
  // wt[i], 0<i<L-1: W as [n_out][ldwt] (hidden columns), forward products
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

// Fixed-order sum of per-block partials (no atomics, deterministic):
// out[c * out_ms + r * ncols + j] = sum over row r's blocks b (in order) of
// part[(c * n_blk + b) * n_part + col0 + j]; n_rows = 1 sums every block.
// One thread per output; internal linkage, as every .cu includes this file.
static __global__ void sum_block_partials(const float* __restrict__ part,
                                          float* __restrict__ out, int n_chunk,
                                          int64_t n_blk, int n_part, int col0,
                                          int ncols, int n_rows, int64_t out_ms) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n_chunk * n_rows * ncols) return;
  const int j = (int)(idx % ncols);
  const int64_t cr = idx / ncols;
  const int r = (int)(cr % n_rows);
  const int c = (int)(cr / n_rows);
  const int64_t bpr = n_blk / n_rows;
  const float* src = part + ((int64_t)c * n_blk + r * bpr) * n_part + col0 + j;
  float s = 0.f;
  for (int64_t b = 0; b < bpr; ++b) s += src[b * n_part];
  out[c * out_ms + (int64_t)r * ncols + j] = s;
}

}  // namespace nphm
