// K2: the whole warm Broyden root-find of g(x) = x + delta(x) - obs through
// the deformation trunk, one lane per (obs, point).
//
// Replaces nphm_tpu/ops/pallas_search.py::broyden_search_pallas (body
// _make_search_kernel).  A block owns a tile of 32 lanes (one warp's worth):
// residual init, then good-Broyden rank-1 inverse-Jacobian updates up to a
// runtime budget, with best-iterate tracking, convergence at `cvg`,
// divergence at `dvg`.  The block leaves its loop as soon as none of its
// lanes is active (a warp vote), and writes its executed iteration count;
// the wrapper takes the max over blocks.  Lanes past n_real (padding) never
// count as active.  Per-obs conditioning biases reach each lane through its
// row index (lane / row_len).
//
// Bound on this card: fp32 FMA throughput plus L2 reads of the 4.3 MB trunk
// (read once per block and trunk evaluation; the whole trunk stays
// L2-resident).  Design: two [512][32] activation buffers (128 KB) in
// shared memory, the per-lane Broyden state in the registers of warp 0,
// plain fp32 FMA throughout (bf16 or TF32 products stall the residuals
// above the 1e-6 convergence threshold).
#include "mlp_tile.cuh"

namespace {

constexpr int kLanes = 32;

__device__ __forceinline__ void matvec3(const float* j, const float* v, float* out) {
  for (int i = 0; i < 3; ++i) {
    float acc = j[3 * i] * v[0];
    acc += j[3 * i + 1] * v[1];
    acc += j[3 * i + 2] * v[2];
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(nphm::kThreads)
broyden_search_kernel(nphm::Trunk tr, const float* __restrict__ obs,
                      const float* __restrict__ x_init,
                      const float* __restrict__ j_init, float* __restrict__ xb_out,
                      float* __restrict__ bn_out, float* __restrict__ j_out,
                      float* __restrict__ act_out, int* __restrict__ iters_out,
                      int64_t n_real, int niter, float cvg, float dvg, float eps,
                      int hmax) {
  constexpr int T = kLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf_a = smem;
  float* buf_b = buf_a + hmax * T;
  float* xs = buf_b + hmax * T;
  float* head = xs + 3 * T;
  float* part = head + nphm::kMaxHead * T;
  int* rows = reinterpret_cast<int*>(part + nphm::kWarps * nphm::kMaxHead * T);
  __shared__ int any_active;

  float* hs[nphm::kMaxLayers];
  for (int i = 0; i < nphm::kMaxLayers; ++i) hs[i] = (i % 2 == 0) ? buf_a : buf_b;

  const int t = threadIdx.x;
  const int64_t p = (int64_t)blockIdx.x * T + t;
  const bool lane_owner = t < T;
  bool inb = false;
  float o[3], x[3], gx[3], upd[3], jm[9], xb[3], bn = 0.f;
  bool act = false;
  if (lane_owner) {
    inb = p < n_real;
    const int64_t pc = inb ? p : n_real - 1;
    for (int c = 0; c < 3; ++c) {
      o[c] = obs[pc * 3 + c];
      x[c] = x_init[pc * 3 + c];
      xs[c * T + t] = x[c];
    }
    for (int c = 0; c < 9; ++c) jm[c] = j_init[pc * 9 + c];
    rows[t] = (int)(pc / tr.row_len);
  }
  __syncthreads();
  nphm::trunk_forward<T, 8, 4>(tr, 0, xs, rows, hs, head, part, true);
  if (lane_owner) {
    for (int c = 0; c < 3; ++c) gx[c] = (x[c] + head[c * T + t]) - o[c];
    float jg[3];
    matvec3(jm, gx, jg);
    for (int c = 0; c < 3; ++c) {
      upd[c] = -jg[c];
      xb[c] = x[c];
    }
    bn = sqrtf(gx[0] * gx[0] + gx[1] * gx[1] + gx[2] * gx[2]);
    act = inb;
  }
  if (t < 32) {
    const int any = __any_sync(0xffffffffu, act);
    if (t == 0) any_active = any;
  }
  __syncthreads();

  int it = 0;
  while (it < niter && any_active) {
    float dx[3];
    if (lane_owner) {
      for (int c = 0; c < 3; ++c) {
        dx[c] = act ? upd[c] : 0.f;
        x[c] = x[c] + dx[c];
        xs[c * T + t] = x[c];
      }
    }
    __syncthreads();
    nphm::trunk_forward<T, 8, 4>(tr, 0, xs, rows, hs, head, part, true);
    if (lane_owner) {
      float dg[3], g2[3];
      for (int c = 0; c < 3; ++c) {
        const float gn = (x[c] + head[c * T + t]) - o[c];
        dg[c] = act ? gn - gx[c] : 0.f;
        g2[c] = gx[c] + dg[c];
      }
      const float n2 = sqrtf(g2[0] * g2[0] + g2[1] * g2[1] + g2[2] * g2[2]);
      const bool better = n2 < bn;
      const float bn2 = better ? n2 : bn;
      if (better)
        for (int c = 0; c < 3; ++c) xb[c] = x[c];
      const bool act2 = inb && bn2 > cvg && n2 < dvg;
      // good-Broyden rank-1 update of J^-1
      float vt[3], jdg[3], u[3];
      for (int c = 0; c < 3; ++c) {
        float acc = dx[0] * jm[c];
        acc += dx[1] * jm[3 + c];
        acc += dx[2] * jm[6 + c];
        vt[c] = acc;
      }
      matvec3(jm, dg, jdg);
      float den = vt[0] * dg[0];
      den += vt[1] * dg[1];
      den += vt[2] * dg[2];
      den = den >= 0.f ? den + eps : den - eps;
      for (int c = 0; c < 3; ++c) u[c] = (dx[c] - jdg[c]) / den;
      if (act)
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j) jm[3 * i + j] += u[i] * vt[j];
      float jg[3];
      matvec3(jm, g2, jg);
      for (int c = 0; c < 3; ++c) {
        gx[c] = g2[c];
        upd[c] = -jg[c];
      }
      bn = bn2;
      act = act2;
    }
    ++it;
    if (t < 32) {
      const int any = __any_sync(0xffffffffu, act);
      if (t == 0) any_active = any;
    }
    __syncthreads();
  }
  if (lane_owner) {
    for (int c = 0; c < 3; ++c) xb_out[p * 3 + c] = xb[c];
    for (int c = 0; c < 9; ++c) j_out[p * 9 + c] = jm[c];
    bn_out[p] = bn;
    act_out[p] = act ? 1.f : 0.f;
  }
  if (t == 0) iters_out[blockIdx.x] = it;
}

}  // namespace

static int nphm_search_smem_bytes(int hmax) {
  constexpr int T = kLanes;
  return (int)sizeof(float) *
         (2 * hmax * T + 3 * T + nphm::kMaxHead * T +
          nphm::kWarps * nphm::kMaxHead * T + T);
}

extern "C" int nphm_search_lanes_per_block() { return kLanes; }

// obs, x_init: [n_pad][3]; j_init: [n_pad][9] (n_pad a multiple of 32, rows
// past n_real are padding); outputs xb [n_pad][3], bn [n_pad], j [n_pad][9],
// act [n_pad], iters [n_pad / 32].
extern "C" int nphm_broyden_search(const nphm::Trunk* tr, const float* obs,
                                   const float* x_init, const float* j_init,
                                   float* xb, float* bn, float* j_out,
                                   float* act, int* iters, int64_t n_pad,
                                   int64_t n_real, int niter, float cvg,
                                   float dvg, float eps, int hmax,
                                   void* stream) {
  const int smem = nphm_search_smem_bytes(hmax);
  cudaError_t err = cudaFuncSetAttribute(
      broyden_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    // refused for a trunk wider than a block's shared memory (hidden 1024);
    // clear the error so the next launch's check does not report it again
    cudaGetLastError();
    return (int)err;
  }
  const int64_t blocks = n_pad / kLanes;
  broyden_search_kernel<<<(unsigned)blocks, nphm::kThreads, smem,
                          (cudaStream_t)stream>>>(
      *tr, obs, x_init, j_init, xb, bn, j_out, act, iters, n_real, niter, cvg,
      dvg, eps, hmax);
  return (int)cudaGetLastError();
}
