// K5 and K6: the training NPHM field, forward and double-backprop backward.
//
// Replace nphm_tpu/ops/pallas_train.py::_fwd_impl (body _make_fwd_kernel)
// and ::_bwd_impl (body _make_bwd_kernel), the two halves of the custom VJP
// _member_fields behind apply_nphm_train_pallas.
//
// K5: one block per (member, tile of kLanes points) runs the primal sweep
// with the latent folded into per-(member, row) biases, keeps every hidden
// activation in shared memory, writes the raw SDF F (head without its
// bias), then runs one reverse sweep seeded by the head weights with the
// cotangent overwriting each activation in place (K4's structure), and
// writes G = dF/dcoords.
//
// K6 is four steps per chunk of members, one block per (member, lane tile)
// in the first two:
//  - train_bwd_fwd_kernel recomputes the primal h_i and runs the tangent
//    forward seeded by dG (p_i, kept as q_i = softplus'(z_i) p_i), writing
//    the per-lane rows [h_i | q_i] of every hidden layer to a scratch;
//  - train_bwd_rev_kernel runs the dual reverse sweep of
//    phi = <dF, F> + <dG, G>, reading h_i and q_i back:
//        zbar_i = ubar_i softplus'(z_i) + vbar_i softplus''(z_i) p_i
//               = ubar_i softplus'(z_i) + vbar_i beta e^{-beta h_i} q_i
//        pbar_i = vbar_i softplus'(z_i)
//        ubar_{i-1} = W_i^T zbar_i,  vbar_{i-1} = W_i^T pbar_i
//    It writes d(coords) directly, per-block partial sums of every small
//    gradient (biases, point weights, head weights), and the per-lane rows
//    [zbar_i | pbar_i] of every hidden product i to the scratch, next to
//    its inputs [h_{i-1} | q_{i-1}].  Culled (member, cull tile) pairs
//    write zeros.
//  - sum_block_partials adds each row's (row biases) or each member's
//    blocks in a fixed order.
//  - lane_contract (split-K over the lanes, fixed split) and sum_splits
//    give dW_i = sum over lanes of zbar_i h_{i-1}^T + pbar_i q_{i-1}^T.
// No float atomics anywhere: every sum has a fixed order, so results are
// deterministic run to run.
//
// Bound on this card: fp32 FMA throughput.  K5 does ~2x the primal FMAs
// (81.8k per point and member at production width), K6 ~6x.  Design:
// activations stay in shared memory one or two layers at a time (K6's
// passes hold four [H][32] buffers, ~101 KB at H = 200, so two blocks fit
// an SM; the reverse pass reads each weight matrix once for both of its
// products); the activations the reverse sweep needs travel
// through the scratch the lane contraction reads anyway (~0.5 GB per member
// at the production batch, processed in member chunks); weights are read
// from L2.
#include "mlp_tile.cuh"

// Host mirror: nphm_tpu_torch/ops/train_fields.py::_Grads.  Every array is
// indexed by the global member.  (Outside the anonymous namespace: the C
// entry point takes it, and must keep external linkage.)
struct TrainGrads {
  float* dw[nphm::kMaxLayers];  // 0 < i < L-1: [A][n_out][n_in]
  float* db[nphm::kMaxLayers];  // 0 and skip: [A][n_rows][n_out]; else [A][n_out]
  float* dwp0;                  // [A][H0][3]
  float* dwps;                  // [A][HS][3]
  float* dwlast;                // [A][n_in of the head]
};

namespace {

constexpr int kLanes = 32;
constexpr int kSplitK = 16;
constexpr int kGemmTile = 64;
constexpr int kGemmK = 16;

__device__ __forceinline__ void load_lanes(const float* src, int m, int n_ch,
                                           int64_t M, int64_t p0, float* dst) {
  const int t = threadIdx.x;
  if (t < kLanes)
    for (int c = 0; c < n_ch; ++c)
      dst[c * kLanes + t] = src[((int64_t)m * n_ch + c) * M + p0 + t];
}

__global__ void __launch_bounds__(nphm::kThreads)
train_fwd_kernel(nphm::Trunk tr, const float* __restrict__ coords,
                 const int* __restrict__ active, float* __restrict__ F,
                 float* __restrict__ G, int64_t M, int n_members,
                 int cull_tile, int hsum) {
  constexpr int T = kLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = (int)tr.n_layers;
  const int skip = (int)tr.skip;
  const float beta = (float)tr.beta;
  const int m = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * T;
  const int t = threadIdx.x;
  if (active[(p0 / cull_tile) * n_members + m] == 0) {
    if (t < T) {
      F[(int64_t)m * M + p0 + t] = 0.f;
      for (int c = 0; c < 3; ++c) G[((int64_t)m * 3 + c) * M + p0 + t] = 0.f;
    }
    return;
  }
  float* hs[nphm::kMaxLayers];
  float* cur = smem;
  for (int i = 0; i < L - 1; ++i) {
    hs[i] = cur;
    cur += tr.n_out[i] * T;
  }
  float* xs = smem + hsum * T;
  float* dg = xs + 3 * T;
  float* head = dg + 3 * T;
  float* part = head + nphm::kMaxHead * T;
  int* rows = reinterpret_cast<int*>(part + nphm::kWarps * nphm::kMaxHead * T);

  load_lanes(coords, m, 3, M, p0, xs);
  if (t < T) rows[t] = (int)((p0 + t) / tr.row_len);
  __syncthreads();
  nphm::trunk_forward<T, 8, 4>(tr, m, xs, rows, hs, head, part, true);
  if (t < T) F[(int64_t)m * M + p0 + t] = head[t];

  // seed: d_{L-2} = wlast * softplus'(z_{L-2}), in place
  {
    const float* wl = tr.w[L - 1] + m * tr.w_ms[L - 1];
    const int H = (int)tr.n_out[L - 2];
    float* h = hs[L - 2];
    for (int it = t; it < H * T; it += blockDim.x)
      h[it] = wl[it / T] * nphm::softplus_grad(h[it], beta);
    for (int it = t; it < 3 * T; it += blockDim.x) dg[it] = 0.f;
    __syncthreads();
  }
  for (int i = L - 2; i >= 0; --i) {
    const int H = (int)tr.n_out[i];
    float* d = hs[i];
    if (i == skip || i == 0) {
      const float* wp = (i == 0) ? tr.w[0] + m * tr.w_ms[0] : tr.wp + m * tr.wp_ms;
      for (int it = t; it < 3 * T; it += blockDim.x) {
        const int c = it / T;
        const int l = it - c * T;
        float s = 0.f;
        for (int o = 0; o < H; ++o) s = fmaf(wp[o * 3 + c], d[o * T + l], s);
        dg[it] += s;
      }
    }
    if (i > 0) {
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
    for (int c = 0; c < 3; ++c) G[((int64_t)m * 3 + c) * M + p0 + t] = dg[c * T + t];
}

// Sum over one block's lanes of feature o of a [H][kLanes] buffer.  Lanes
// start at a per-feature offset so the threads of a warp hit distinct banks.
__device__ __forceinline__ float lane_sum(const float* x, int o) {
  float s = 0.f;
#pragma unroll 8
  for (int j = 0; j < kLanes; ++j) s += x[o * kLanes + ((j + o) & (kLanes - 1))];
  return s;
}

// Scratch rows of one chunk member, each of length 2M (lanes [0, M) then
// [M, 2M)): for every hidden product i (0 < i < L-1) its n_out rows
// [zbar_i | pbar_i] then its n_in rows [h_{i-1} | q_{i-1}]; after them the
// n_out rows [h_{L-2} | q_{L-2}] of the last hidden layer.
struct ScratchRows {
  int64_t zp[nphm::kMaxLayers];  // first [zbar_i | pbar_i] row of product i
  int64_t hq[nphm::kMaxLayers];  // first [h_i | q_i] row of hidden layer i
  int64_t total;
};

__device__ __forceinline__ ScratchRows scratch_rows(const nphm::Trunk& tr) {
  ScratchRows s;
  const int L = (int)tr.n_layers;
  int64_t r = 0;
  for (int i = 1; i < L - 1; ++i) {
    s.zp[i] = r;
    s.hq[i - 1] = r + tr.n_out[i];
    r += tr.n_out[i] + tr.n_in[i];
  }
  s.hq[L - 2] = r;
  s.total = r + tr.n_out[L - 2];
  return s;
}

// K6, first pass: recompute the primal h_i and run the tangent forward
// p_i seeded by dG, keeping q_i = softplus'(z_i) p_i; write [h_i | q_i] of
// every hidden layer to the scratch.  Shared memory holds two layers of h
// and q (ping-pong).  Culled (member, cull tile) pairs write zero rows.
__global__ void __launch_bounds__(nphm::kThreads, 2)
train_bwd_fwd_kernel(nphm::Trunk tr, const float* __restrict__ coords,
                     const float* __restrict__ dG, const int* __restrict__ active,
                     float* __restrict__ scr, int64_t M, int n_members,
                     int cull_tile, int hmax, int m0, int64_t scr_ms) {
  constexpr int T = kLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = (int)tr.n_layers;
  const int skip = (int)tr.skip;
  const float beta = (float)tr.beta;
  const int c_m = blockIdx.y;
  const int m = m0 + c_m;
  const int64_t p0 = (int64_t)blockIdx.x * T;
  const int64_t M2 = 2 * M;
  const int t = threadIdx.x;
  float* sc = scr + (int64_t)c_m * scr_ms;
  const ScratchRows sr = scratch_rows(tr);

  if (active[(p0 / cull_tile) * n_members + m] == 0) {
    for (int i = 0; i < L - 1; ++i) {
      float* R = sc + sr.hq[i] * M2;
      for (int it = t; it < (int)tr.n_out[i] * 2 * T; it += blockDim.x) {
        const int k = it / (2 * T);
        const int rem = it - k * 2 * T;
        const int half = rem / T;
        R[k * M2 + half * M + p0 + (rem - half * T)] = 0.f;
      }
    }
    return;
  }

  float* hb[2] = {smem, smem + hmax * T};
  float* qb[2] = {smem + 2 * hmax * T, smem + 3 * hmax * T};
  float* xs = smem + 4 * hmax * T;
  float* vs = xs + 3 * T;
  int* rows = reinterpret_cast<int*>(vs + 3 * T);
  load_lanes(coords, m, 3, M, p0, xs);
  load_lanes(dG, m, 3, M, p0, vs);
  if (t < T) rows[t] = (int)((p0 + t) / tr.row_len);
  __syncthreads();

  for (int i = 0; i < L - 1; ++i) {
    const int H = (int)tr.n_out[i];
    float* h = hb[i & 1];
    float* q = qb[i & 1];
    const float* b = tr.b[i] + m * tr.b_ms[i];
    const int64_t brs = tr.b_rs[i];
    if (i == 0) {
      const float* w = tr.w[0] + m * tr.w_ms[0];
      for (int it = t; it < H * T; it += blockDim.x) {
        const int o = it / T;
        const int l = it - o * T;
        float z = w[o * 3] * xs[l];
        z = fmaf(w[o * 3 + 1], xs[T + l], z);
        z = fmaf(w[o * 3 + 2], xs[2 * T + l], z);
        const float hv = nphm::softplus_beta(z + b[rows[l] * brs + o], beta);
        float p = w[o * 3] * vs[l];
        p = fmaf(w[o * 3 + 1], vs[T + l], p);
        p = fmaf(w[o * 3 + 2], vs[2 * T + l], p);
        h[it] = hv;
        q[it] = nphm::softplus_grad(hv, beta) * p;
      }
      __syncthreads();
    } else {
      const float* W = tr.w[i] + m * tr.w_ms[i];
      const float* wp = (i == skip) ? tr.wp + m * tr.wp_ms : nullptr;
      nphm::tile_mm<T, 8, 4>(W, (int)tr.ldw[i], (int)tr.n_in[i], H, hb[(i - 1) & 1],
                             [&](int o, int l, float acc) {
                               if (wp) {
                                 float p = wp[o * 3] * xs[l];
                                 p = fmaf(wp[o * 3 + 1], xs[T + l], p);
                                 p = fmaf(wp[o * 3 + 2], xs[2 * T + l], p);
                                 acc = acc + p;
                               }
                               h[o * T + l] =
                                   nphm::softplus_beta(acc + b[rows[l] * brs + o], beta);
                             });
      __syncthreads();
      nphm::tile_mm<T, 8, 4>(W, (int)tr.ldw[i], (int)tr.n_in[i], H, qb[(i - 1) & 1],
                             [&](int o, int l, float acc) {
                               if (wp) {
                                 acc = fmaf(wp[o * 3], vs[l], acc);
                                 acc = fmaf(wp[o * 3 + 1], vs[T + l], acc);
                                 acc = fmaf(wp[o * 3 + 2], vs[2 * T + l], acc);
                               }
                               const int k = o * T + l;
                               q[k] = nphm::softplus_grad(h[k], beta) * acc;
                             });
      __syncthreads();
    }
    float* R = sc + sr.hq[i] * M2;
    for (int it = t; it < H * T; it += blockDim.x) {
      const int k = it / T;
      const int l = it - k * T;
      R[k * M2 + p0 + l] = h[it];
      R[k * M2 + M + p0 + l] = q[it];
    }
  }
}

// K6, second pass: the dual reverse sweep, reading h_i and q_i back from
// the scratch.  Shared memory holds four [H][T] buffers: (zbar, pbar) of
// the current layer and of the next one down, swapping roles each layer.  Writes d(coords), the
// per-block partials and the [zbar_i | pbar_i] rows of every hidden
// product; culled pairs write zeros.
__global__ void __launch_bounds__(nphm::kThreads, 2)
train_bwd_rev_kernel(nphm::Trunk tr, const float* __restrict__ coords,
                     const float* __restrict__ dF, const float* __restrict__ dG,
                     const int* __restrict__ active, float* __restrict__ dcoords,
                     float* __restrict__ part, float* __restrict__ scr, int64_t M,
                     int n_members, int cull_tile, int hsum, int hmax, int m0,
                     int n_part, int64_t scr_ms) {
  constexpr int T = kLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = (int)tr.n_layers;
  const int skip = (int)tr.skip;
  const float beta = (float)tr.beta;
  const int c_m = blockIdx.y;
  const int m = m0 + c_m;
  const int64_t blk = blockIdx.x;
  const int64_t n_blk = gridDim.x;
  const int64_t p0 = blk * T;
  const int64_t M2 = 2 * M;
  const int t = threadIdx.x;
  float* pb = part + ((int64_t)c_m * n_blk + blk) * n_part;
  float* sc = scr + (int64_t)c_m * scr_ms;
  const ScratchRows sr = scratch_rows(tr);
  int boff[nphm::kMaxLayers];  // per-block partial offset of layer i's bias
  {
    int b = 0;
    for (int i = 0; i < L - 1; ++i) {
      boff[i] = b;
      b += (int)tr.n_out[i];
    }
  }
  const int H0 = (int)tr.n_out[0];
  const int HS = (int)tr.n_out[skip];
  const int off_wp0 = hsum;
  const int off_wps = off_wp0 + 3 * H0;
  const int off_wlast = off_wps + 3 * HS;

  if (active[(p0 / cull_tile) * n_members + m] == 0) {
    if (t < T)
      for (int c = 0; c < 3; ++c) dcoords[((int64_t)m * 3 + c) * M + p0 + t] = 0.f;
    for (int o = t; o < n_part; o += blockDim.x) pb[o] = 0.f;
    for (int i = 1; i < L - 1; ++i) {
      float* R = sc + sr.zp[i] * M2;
      for (int it = t; it < (int)tr.n_out[i] * 2 * T; it += blockDim.x) {
        const int k = it / (2 * T);
        const int rem = it - k * 2 * T;
        const int half = rem / T;
        R[k * M2 + half * M + p0 + (rem - half * T)] = 0.f;
      }
    }
    return;
  }

  float* zb = smem;                 // zbar_i
  float* pbuf = smem + hmax * T;    // pbar_i
  float* zn = smem + 2 * hmax * T;  // zbar_{i-1}
  float* pn = smem + 3 * hmax * T;  // pbar_{i-1}
  float* xs = smem + 4 * hmax * T;
  float* vs = xs + 3 * T;
  float* us = vs + 3 * T;
  float* dg = us + T;
  load_lanes(coords, m, 3, M, p0, xs);
  load_lanes(dG, m, 3, M, p0, vs);
  load_lanes(dF, m, 1, M, p0, us);
  for (int it = t; it < 3 * T; it += blockDim.x) dg[it] = 0.f;

  // seeds of the last hidden layer: ubar = wlast * dF, vbar = wlast; the
  // head-weight gradient sums h * dF + q over the block's lanes
  {
    const int Lh = L - 2;
    const int H = (int)tr.n_out[Lh];
    const float* wl = tr.w[L - 1] + m * tr.w_ms[L - 1];
    const float* R = sc + sr.hq[Lh] * M2;
    for (int it = t; it < H * T; it += blockDim.x) {
      const int k = it / T;
      const int l = it - k * T;
      zn[it] = R[k * M2 + p0 + l];
      zb[it] = R[k * M2 + M + p0 + l];
    }
    __syncthreads();
    for (int o = t; o < H; o += blockDim.x) {
      float s = 0.f;
      for (int j = 0; j < T; ++j) {
        const int l = (j + o) & (T - 1);
        s = fmaf(zn[o * T + l], us[l], s);
        s += zb[o * T + l];
      }
      pb[off_wlast + o] = s;
    }
    __syncthreads();
    for (int it = t; it < H * T; it += blockDim.x) {
      const int o = it / T;
      const int l = it - o * T;
      const float e = expf(-beta * zn[it]);
      const float sp = 1.f - e;
      const float qv = zb[it];
      zb[it] = wl[o] * us[l] * sp + wl[o] * beta * e * qv;
      pbuf[it] = wl[o] * sp;
    }
    __syncthreads();
  }

  for (int i = L - 2; i >= 0; --i) {
    const int H = (int)tr.n_out[i];
    for (int o = t; o < H; o += blockDim.x) pb[boff[i] + o] = lane_sum(zb, o);
    if (i == 0 || i == skip) {
      const float* wp = (i == 0) ? tr.w[0] + m * tr.w_ms[0] : tr.wp + m * tr.wp_ms;
      float* dst = pb + (i == 0 ? off_wp0 : off_wps);
      for (int it = t; it < 3 * H; it += blockDim.x) {
        const int o = it / 3;
        const int c = it - o * 3;
        float s = 0.f;
        for (int j = 0; j < T; ++j) {
          const int l = (j + o) & (T - 1);
          s = fmaf(zb[o * T + l], xs[c * T + l], s);
          s = fmaf(pbuf[o * T + l], vs[c * T + l], s);
        }
        dst[it] = s;
      }
      for (int it = t; it < 3 * T; it += blockDim.x) {
        const int c = it / T;
        const int l = it - c * T;
        float s = 0.f;
        for (int o = 0; o < H; ++o) s = fmaf(wp[o * 3 + c], zb[o * T + l], s);
        dg[it] += s;
      }
    }
    if (i > 0) {
      const int Hin = (int)tr.n_in[i];
      float* Ar = sc + sr.zp[i] * M2;
      const float* Hr = sc + sr.hq[i - 1] * M2;  // [h_{i-1} | q_{i-1}]
      for (int it = t; it < H * T; it += blockDim.x) {
        const int o = it / T;
        const int l = it - o * T;
        Ar[o * M2 + p0 + l] = zb[it];
        Ar[o * M2 + M + p0 + l] = pbuf[it];
      }
      // ubar_{i-1} = W^T zbar_i and vbar_{i-1} = W^T pbar_i through one read
      const float* Wt = tr.wt[i] + m * tr.wt_ms[i];
      nphm::tile_mm2<T, 8, 4>(Wt, (int)tr.ldwt[i], H, Hin, zb, pbuf,
                              [&](int j, int l, float ub, float vb) {
                                const int k = j * T + l;
                                const float hv = Hr[j * M2 + p0 + l];
                                const float qv = Hr[j * M2 + M + p0 + l];
                                const float e = expf(-beta * hv);
                                const float sp = 1.f - e;
                                zn[k] = ub * sp + vb * beta * e * qv;
                                pn[k] = vb * sp;
                              });
      float* z_old = zb;
      float* p_old = pbuf;
      zb = zn;
      pbuf = pn;
      zn = z_old;
      pn = p_old;
    }
    __syncthreads();
  }
  if (t < T)
    for (int c = 0; c < 3; ++c)
      dcoords[((int64_t)m * 3 + c) * M + p0 + t] = dg[c * T + t];
}

// K6's lane contraction: part[c][s][r][k] = sum over lanes j of split s of
// A[c][r][j] * B[c][k][j] (rows of length K, lanes contiguous).  One block
// owns a 64x64 output tile of one split; each thread a 4x4 register tile.
__global__ void __launch_bounds__(256)
lane_contract(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ part, int64_t K, int R, int C, int64_t ms) {
  __shared__ float As[kGemmK][kGemmTile + 4];
  __shared__ float Bs[kGemmK][kGemmTile + 4];
  const int tiles_c = (C + kGemmTile - 1) / kGemmTile;
  const int r0 = (blockIdx.x / tiles_c) * kGemmTile;
  const int c0 = (blockIdx.x % tiles_c) * kGemmTile;
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  const int64_t seg = K / kSplitK;
  const int64_t k_begin = s * seg;
  const float* a = A + c * ms;
  const float* b = B + c * ms;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int lrow = t / 4;
  const int lk = (t % 4) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_begin + seg; k0 += kGemmK) {
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + lrow < R)
      va = *reinterpret_cast<const float4*>(a + (int64_t)(r0 + lrow) * K + k0 + lk);
    if (c0 + lrow < C)
      vb = *reinterpret_cast<const float4*>(b + (int64_t)(c0 + lrow) * K + k0 + lk);
    As[lk][lrow] = va.x; As[lk + 1][lrow] = va.y;
    As[lk + 2][lrow] = va.z; As[lk + 3][lrow] = va.w;
    Bs[lk][lrow] = vb.x; Bs[lk + 1][lrow] = vb.y;
    Bs[lk + 2][lrow] = vb.z; Bs[lk + 3][lrow] = vb.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + ((int64_t)c * kSplitK + s) * R * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col < C) out[(int64_t)r * C + col] = acc[i][j];
    }
  }
}

// out[c * rc + e] = sum over splits s (in order) of part[(c * kSplitK + s) * rc + e]
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ out,
                           int n_chunk, int64_t rc) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_chunk * rc) return;
  const int64_t c = idx / rc;
  const int64_t e = idx - c * rc;
  const float* src = part + c * kSplitK * rc + e;
  float s = 0.f;
  for (int k = 0; k < kSplitK; ++k) s += src[k * rc];
  out[idx] = s;
}

int fwd_smem_bytes(int hsum) {
  constexpr int T = kLanes;
  return (int)sizeof(float) * (hsum * T + 6 * T + nphm::kMaxHead * T +
                               nphm::kWarps * nphm::kMaxHead * T + T);
}

int bwd_fwd_smem_bytes(int hmax) {
  constexpr int T = kLanes;
  return (int)sizeof(float) * (4 * hmax * T + 6 * T + T);
}

int bwd_rev_smem_bytes(int hmax) {
  constexpr int T = kLanes;
  return (int)sizeof(float) * (4 * hmax * T + 10 * T);
}

unsigned n_grid(int64_t n) { return (unsigned)((n + 255) / 256); }

}  // namespace

extern "C" int nphm_train_lanes_per_block() { return kLanes; }
extern "C" int nphm_train_split_k() { return kSplitK; }

// coords: [A][3][M]; active: [M / cull_tile][A] -> F [A][M], G [A][3][M].
extern "C" int nphm_train_fwd(const nphm::Trunk* tr, const float* coords,
                              const int* active, float* F, float* G, int64_t M,
                              int n_members, int cull_tile, int hsum,
                              void* stream) {
  const int smem = fwd_smem_bytes(hsum);
  cudaError_t err = cudaFuncSetAttribute(
      train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(M / kLanes), (unsigned)n_members);
  train_fwd_kernel<<<grid, nphm::kThreads, smem, (cudaStream_t)stream>>>(
      *tr, coords, active, F, G, M, n_members, cull_tile, hsum);
  return (int)cudaGetLastError();
}

// One chunk of members [m0, m0 + n_chunk) of the backward: + dF [A][M],
// dG [A][3][M] -> dcoords [A][3][M] and every gradient in *g.  Scratch:
// part [n_chunk][M / kLanes][n_part], scr [n_chunk][scr_rows][2M],
// gsp [n_chunk][max(kSplitK * max n_out * n_in, n_rows * widest partial
// group)] (the split-K partials, and first the per-row partial sums).
extern "C" int nphm_train_bwd(const nphm::Trunk* tr, const TrainGrads* g,
                              const float* coords, const float* dF,
                              const float* dG, const int* active,
                              float* dcoords, float* part, float* scr,
                              float* gsp, int64_t M, int n_members, int n_rows,
                              int cull_tile, int hsum, int hmax, int m0,
                              int n_chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int L = (int)tr->n_layers;
  const int skip = (int)tr->skip;
  const int H0 = (int)tr->n_out[0];
  const int HS = (int)tr->n_out[skip];
  const int Hl = (int)tr->n_out[L - 2];
  const int n_part = hsum + 3 * H0 + 3 * HS + Hl;
  int64_t scr_rows = tr->n_out[L - 2];
  for (int i = 1; i < L - 1; ++i) scr_rows += tr->n_out[i] + tr->n_in[i];
  const int64_t M2 = 2 * M;
  const int64_t scr_ms = scr_rows * M2;
  const int64_t n_blk = M / kLanes;
  if (M2 % ((int64_t)kSplitK * kGemmK) != 0 || M % kLanes != 0 || n_blk % n_rows != 0)
    return (int)cudaErrorInvalidValue;

  const int smem_f = bwd_fwd_smem_bytes(hmax);
  const int smem_r = bwd_rev_smem_bytes(hmax);
  cudaError_t err = cudaFuncSetAttribute(
      train_bwd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_f);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(train_bwd_rev_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_r);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)n_blk, (unsigned)n_chunk);
  train_bwd_fwd_kernel<<<grid, nphm::kThreads, smem_f, st>>>(
      *tr, coords, dG, active, scr, M, n_members, cull_tile, hmax, m0, scr_ms);
  train_bwd_rev_kernel<<<grid, nphm::kThreads, smem_r, st>>>(
      *tr, coords, dF, dG, active, dcoords, part, scr, M, n_members, cull_tile,
      hsum, hmax, m0, n_part, scr_ms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // small gradients from the per-block partials: row biases sum each row's
  // blocks; the rest sum each row's blocks into gsp, then the rows
  auto per_row = [&](int col0, int ncols, float* out) {
    nphm::sum_block_partials<<<n_grid((int64_t)n_chunk * n_rows * ncols), 256, 0, st>>>(
        part, out, n_chunk, n_blk, n_part, col0, ncols, n_rows, (int64_t)n_rows * ncols);
  };
  auto per_member = [&](int col0, int ncols, float* out) {
    per_row(col0, ncols, gsp);
    nphm::sum_block_partials<<<n_grid((int64_t)n_chunk * ncols), 256, 0, st>>>(
        gsp, out, n_chunk, n_rows, ncols, 0, ncols, 1, ncols);
  };
  int col = 0;
  for (int i = 0; i < L - 1; ++i) {
    const int H = (int)tr->n_out[i];
    if (i == 0 || i == skip)
      per_row(col, H, g->db[i] + (int64_t)m0 * n_rows * H);
    else
      per_member(col, H, g->db[i] + (int64_t)m0 * H);
    col += H;
  }
  per_member(hsum, 3 * H0, g->dwp0 + (int64_t)m0 * 3 * H0);
  per_member(hsum + 3 * H0, 3 * HS, g->dwps + (int64_t)m0 * 3 * HS);
  per_member(hsum + 3 * H0 + 3 * HS, Hl, g->dwlast + (int64_t)m0 * Hl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // hidden weight gradients: contract the scratch over the lanes
  int64_t r = 0;
  for (int i = 1; i < L - 1; ++i) {
    const int R = (int)tr->n_out[i];
    const int C = (int)tr->n_in[i];
    const float* A = scr + r * M2;
    const float* B = A + (int64_t)R * M2;
    const int tiles = ((R + kGemmTile - 1) / kGemmTile) * ((C + kGemmTile - 1) / kGemmTile);
    lane_contract<<<dim3((unsigned)tiles, kSplitK, (unsigned)n_chunk), 256, 0, st>>>(
        A, B, gsp, M2, R, C, scr_ms);
    const int64_t rc = (int64_t)R * C;
    sum_splits<<<n_grid(n_chunk * rc), 256, 0, st>>>(gsp, g->dw[i] + (int64_t)m0 * rc,
                                                     n_chunk, rc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    r += R + C;
  }
  return 0;
}
