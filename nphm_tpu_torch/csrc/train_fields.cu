// K5 and K6: the training NPHM field, forward and double-backprop backward.
//
// Replace nphm_tpu/ops/pallas_train.py::_fwd_impl (body _make_fwd_kernel)
// and ::_bwd_impl (body _make_bwd_kernel), the two halves of the custom VJP
// _member_fields behind apply_nphm_train_pallas.
//
// K5: one block per (member, 64-point tile) runs the primal sweep with the
// latent folded into per-(member, row) biases, keeps every hidden
// activation in shared memory, writes the raw SDF F (head without its
// bias), then runs one reverse sweep seeded by the head weights with the
// cotangent overwriting each activation in place, and writes G =
// dF/dcoords: K4's body with dF = 1 and no bias partials
// (field_tile.cuh, mode kTrainFwd, on the tensor cores).  Its first design
// (32-point blocks of 8 warps, fp32 SIMT products reading weights from L2):
// 75.57 ms at the training batch, 32 x 2048 points (NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// K6 is four steps per chunk of members, one block of 16 warps per
// (member, 64-point tile) in the first two, every product on the tensor
// cores in 3xTF32 (tc_tile.cuh):
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
//  - lane_contract (a fixed split of the lanes) and sum_splits give dW_i =
//    sum over lanes of zbar_i h_{i-1}^T + pbar_i q_{i-1}^T.
// No float atomics anywhere: every sum has a fixed order, so results are
// bit-identical run to run.  K5 and K6 are instantiated for three routes
// (the entry points take the code the host chose, ops/fit_fields.py
// ROUTES), and K6 launches over K5's trunk: tc::kF32 as above; tc::kTF32,
// one TF32 pass rounding each operand fragment; tc::kBF16Mma, bf16 weights
// and one m16n8k16 .bf16 MMA a product step in K5's sweeps, in K6's passes
// and in its lane contraction, whose [zbar | pbar] rows are stored in bf16
// (half their bytes; only the contraction reads them, and the plain version
// rounds them to bf16 there); its reverse pass asks L2 for its scratch
// gathers a product ahead (prefetch_rows).
//
// Bounds on this card: K5 ~2x and K6 ~6x the primal multiply-adds (81.8k
// per point and member at production width) as 3xTF32 at 495 TFLOP/s of
// TF32 (one pass at the lower precisions, at the bf16 rate for bf16); K6's
// scratch also moves ~1.6 GB a member at the training batch (1202 rows of
// 2 x 65536 lanes written, read back and contracted; ~1.37 GB at kBF16Mma).
// Measured at the training batch (NVIDIA H100 80GB HBM3, 700 W,
// `kernel_ab --kernels low`): at F32 its two passes take ~78% of K6 (the
// reverse one 44%), the contraction ~20%; the passes' scratch traffic
// 15-16 ms at every precision, their work outside the products ~60 ms of
// 94.  K6's design: its passes are field_tile.cuh's parts (mm64 fed by
// the TMA weight ring, the block-wide bias/softplus pass, fixed-order
// shuffle trees) over three rotating [64][act_ld(hmax)] activation buffers (four would not fit
// beside the ring): each hidden layer runs its two products on the same
// weights, and the reverse epilogues gather what they need of h and q from
// the scratch through mm64's pre hook.  The scratch is feature-major, so
// both operands of the contraction are K-major; its blocks own 64 rows by
// all columns of an output, so each scratch row is read from device memory
// about once.  Its first design (32-point SIMT blocks reading weights from
// L2, 64x64 SIMT contraction tiles): 186.44 ms at the training batch, 32 x
// 2048 points (NVIDIA H100 80GB HBM3, 700.00 W).
#include "field_tile.cuh"

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

namespace field = nphm::field;
namespace tc = nphm::tc;

constexpr int kSplitK = 32;       // lane splits of the contraction (fixed order)
constexpr int kPointFloats = 12 * field::kRows;  // per-point values of K6's passes
constexpr int kCtrSlice = 32;     // lanes per ring slice of the contraction
constexpr int kCtrStages = 4;     // its TMA ring depth
constexpr int kCtrRows = tc::kRows;  // output rows a contraction block owns

// K5 is field_tile.cuh's body in mode kTrainFwd (grid and shared memory
// there): 3xTF32 mma.sync over 64-point tiles of 16 warps, weights staged
// by TMA, the head product and the seed in one pass.
template <int KS, int P>
__global__ void __launch_bounds__(field::kThreads, 1)
train_fwd_kernel(nphm::Trunk tr, const __grid_constant__ field::Maps maps,
                 const float* __restrict__ coords, const int* __restrict__ active,
                 float* __restrict__ F, float* __restrict__ G, int64_t M, int n_members,
                 int cull_tile, int act_floats, int stage) {
  field::tile<KS, field::kTrainFwd, P>(tr, maps, coords, nullptr, active, F, G, nullptr,
                                       nullptr, M, n_members, cull_tile, act_floats, stage);
}

// Scratch rows of one chunk member, each of length 2M (lanes [0, M) then
// [M, 2M)): for every hidden product i (0 < i < L-1) its n_out rows
// [zbar_i | pbar_i] then its n_in rows [h_{i-1} | q_{i-1}]; after them the
// n_out rows [h_{L-2} | q_{L-2}] of the last hidden layer.  Feature-major,
// so the contraction reads both of its operands K-major (lanes contiguous).
struct ScratchRows {
  int64_t zp[nphm::kMaxLayers];  // first [zbar_i | pbar_i] row of product i
  int64_t hq[nphm::kMaxLayers];  // first [h_i | q_i] row of hidden layer i
  int64_t total;
};

__host__ __device__ __forceinline__ ScratchRows scratch_rows(const nphm::Trunk& tr) {
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

// The [64][ld] point-major tile x (width H) to scratch rows R[o * M2 + off
// + t], transposed on store: warp w takes features w, w + 16, ..., its
// lanes points t and t + 32, so each store is 128 contiguous bytes.  Rows
// that only the lane contraction reads ([zbar | pbar]) are stored as route
// P's contraction reads them: at tc::kBF16Mma rounded to bf16 over the
// first half of each row (lane t at bf16 element off + t), the 64 lanes in
// tc::kPerm order within each group of 16, a packed pair a thread.
template <int P = tc::kF32>
__device__ __forceinline__ void store_rows(const float* x, int ld, int H,
                                           float* __restrict__ R, int64_t M2, int64_t off) {
  const int lane = threadIdx.x & 31;
  if constexpr (P == tc::kBF16Mma) {
    const int g = (lane >> 3) * 16;
    const int t0 = g + tc::kPerm(2 * (lane & 7));
    const int t1 = g + tc::kPerm(2 * (lane & 7) + 1);
    for (int o = threadIdx.x >> 5; o < H; o += tc::kMmaWarps) {
      uint32_t* r = reinterpret_cast<uint32_t*>(R + o * M2) + off / 2;
      r[lane] = tc::pack_bf16(__float_as_uint(x[t0 * ld + o]), __float_as_uint(x[t1 * ld + o]));
    }
  } else {
    for (int o = threadIdx.x >> 5; o < H; o += tc::kMmaWarps) {
      float* r = R + o * M2 + off;
      r[lane] = x[lane * ld + o];
      r[lane + 32] = x[(lane + 32) * ld + o];
    }
  }
}

// Ask L2 for H scratch rows' two halves over the tile's 64 lanes (four
// 128-byte lines a row), which the reverse pass reads a product later:
// route tc::kBF16Mma prefetches the seeds' rows at the block's start and
// each product's [h | q] gather before the product ahead of it, so the
// gathers hit L2 instead of waiting on device memory (at tc::kTF32 the
// prefetch made K6 ~0.5 ms slower, so it stays off there).
__device__ __forceinline__ void prefetch_rows(const float* R, int H, int64_t M, int64_t p0) {
  for (int it = threadIdx.x; it < H * 4; it += blockDim.x) {
    const float* a = R + (it >> 2) * 2 * M + ((it >> 1) & 1) * M + p0 + (it & 1) * 32;
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a));
  }
}

// Zero both halves of H scratch rows over the tile's 64 lanes (culled
// pairs), in store_rows<P>'s layout.
template <int P = tc::kF32>
__device__ __forceinline__ void zero_rows(float* __restrict__ R, int H, int64_t M,
                                          int64_t p0) {
  constexpr int T = field::kRows;
  constexpr int W = P == tc::kBF16Mma ? T / 2 : T;  // 32-bit words of a half
  for (int it = threadIdx.x; it < H * 2 * W; it += blockDim.x) {
    const int k = it / (2 * W);
    const int rem = it - k * 2 * W;
    const int half = rem / W;
    const int64_t off = (half * M + p0) / (T / W);
    R[k * 2 * M + off + (rem - half * W)] = 0.f;
  }
}

// dst[o * 3 + c] = sum over the tile's 64 points t of z[t][o] xs[c][t] +
// p[t][o] vs[c][t] (a point-weight gradient): warp per column, its lanes
// points t and t + 32, each sum closed by a fixed-order shuffle tree.
__device__ __forceinline__ void point_wgrad(const float* z, const float* p, int ld, int H,
                                            const float* xs, const float* vs,
                                            float* __restrict__ dst) {
  constexpr int T = field::kRows;
  const int lane = threadIdx.x & 31;
  for (int o = threadIdx.x >> 5; o < H; o += tc::kMmaWarps) {
    float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      const float zv = z[t * ld + o], pv = p[t * ld + o];
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] = fmaf(pv, vs[c * T + t], fmaf(zv, xs[c * T + t], s[c]));
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = field::warp_sum(s[c]);
      if (lane == 0) dst[o * 3 + c] = v;
    }
  }
}

// K6, first pass, one block per (chunk member, 64-point tile): recompute
// the primal h_i and run the tangent forward p_i seeded by dG, keeping q_i
// = softplus'(z_i) p_i, and write [h_i | q_i] of every hidden layer to the
// scratch.  Each hidden layer runs two 3xTF32 products on the same staged
// weights: z_i = W_i h_{i-1} (bias, point term and softplus in a block-wide
// pass) and p_i = W_i q_{i-1} (point term and softplus'(z_i), read through
// mm64's pre hook, in the epilogue).  Three [64][act_ld(hmax)] buffers
// rotate: h_i goes to the free one, q_i to the one h_{i-1} vacated.
// Culled (member, cull tile) pairs write zero rows.
template <int KS, int P>
__global__ void __launch_bounds__(field::kThreads, 1)
train_bwd_fwd_kernel(nphm::Trunk tr, const __grid_constant__ field::Maps maps,
                     const float* __restrict__ coords, const float* __restrict__ dG,
                     const int* __restrict__ active, float* __restrict__ scr, int64_t M,
                     int n_members, int cull_tile, int buf_floats, int stage, int m0,
                     int64_t scr_ms) {
  constexpr int T = field::kRows;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = (int)tr.n_layers;
  const int skip = (int)tr.skip;
  const float beta = (float)tr.beta;
  const float inv_beta = 1.f / beta;
  const int c_m = blockIdx.x;
  const int m = m0 + c_m;
  const int64_t p0 = (int64_t)blockIdx.y * T;
  const int64_t M2 = 2 * M;
  const int t = threadIdx.x;
  float* sc = scr + (int64_t)c_m * scr_ms;
  const ScratchRows sr = scratch_rows(tr);

  if (active[(p0 / cull_tile) * n_members + m] == 0) {
    for (int i = 0; i < L - 1; ++i) zero_rows(sc + sr.hq[i] * M2, (int)tr.n_out[i], M, p0);
    return;
  }

  float* xs = smem + 3 * buf_floats;
  float* vs = xs + 3 * T;
  int* rows = reinterpret_cast<int*>(vs + 3 * T);
  tc::Ring ring = field::make_ring(smem + 3 * buf_floats + kPointFloats, stage);
  if (t < T) {
    for (int c = 0; c < 3; ++c) {
      xs[c * T + t] = coords[((int64_t)m * 3 + c) * M + p0 + t];
      vs[c * T + t] = dG[((int64_t)m * 3 + c) * M + p0 + t];
    }
    rows[t] = (int)((p0 + t) / tr.row_len);
  }
  field::init_ring(ring);
  __syncthreads();
  auto fwd = [&](int i) {
    return tc::Operand{&maps.fwd[i - 1], m * (int)tr.n_out[i], (int)tr.n_in[i],
                       (int)tr.n_out[i]};
  };

  // buffer offsets: h_{i-1}, q_{i-1}, free
  int hb = 0, qb = buf_floats, fb = 2 * buf_floats;
  {
    const int H = (int)tr.n_out[0];
    const int ld = tc::act_ld(H);
    const float* __restrict__ w = tr.w[0] + m * tr.w_ms[0];
    const float* __restrict__ b = tr.b[0] + m * tr.b_ms[0];
    const int64_t brs = tr.b_rs[0];
    float* h = smem + hb;
    float* q = smem + qb;
    for (int it = t; it < H * 4; it += blockDim.x) {
      const int o = it % H;
      const int l0 = (it / H) * 16;
      const float w0 = w[o * 3], w1 = w[o * 3 + 1], w2 = w[o * 3 + 2];
#pragma unroll 4
      for (int l = l0; l < l0 + 16; ++l) {
        float z = w0 * xs[l];
        z = fmaf(w1, xs[T + l], z);
        z = fmaf(w2, xs[2 * T + l], z);
        const float hv = tc::softplus_fast(z + __ldg(b + rows[l] * brs + o), beta, inv_beta);
        float p = w0 * vs[l];
        p = fmaf(w1, vs[T + l], p);
        p = fmaf(w2, vs[2 * T + l], p);
        h[l * ld + o] = hv;
        q[l * ld + o] = tc::softplus_grad_fast(hv, beta) * p;
      }
    }
    field::zero_pad(h, ld, H);
    field::zero_pad(q, ld, H);
    __syncthreads();
    float* R = sc + sr.hq[0] * M2;
    store_rows(h, ld, H, R, M2, p0);
    store_rows(q, ld, H, R, M2, M + p0);
  }

  for (int i = 1; i < L - 1; ++i) {
    const int H = (int)tr.n_out[i];
    const int ld = tc::act_ld(H);
    const int ldp = tc::act_ld((int)tr.n_out[i - 1]);
    float* h = smem + fb;    // h_i
    float* hq = smem + hb;   // h_{i-1}, then q_i
    const float* qp = smem + qb;  // q_{i-1}
    const tc::Operand op = fwd(i);
    const float* __restrict__ wp = i == skip ? tr.wp + m * tr.wp_ms : nullptr;
    tc::mm64<KS, P>(hq, ldp, op, &op, ring, [&](int, int) { return 0.f; },
                    [&](int l, int o, float acc, float) { h[l * ld + o] = acc; });
    __syncthreads();
    {
      const float* __restrict__ b = tr.b[i] + m * tr.b_ms[i];
      const int64_t brs = tr.b_rs[i];
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
          float z = h[l * ld + o] + __ldg(b + rows[l] * brs + o);
          z = fmaf(w0, xs[l], z);
          z = fmaf(w1, xs[T + l], z);
          z = fmaf(w2, xs[2 * T + l], z);
          h[l * ld + o] = tc::softplus_fast(z, beta, inv_beta);
        }
      }
      field::zero_pad(h, ld, H);
      field::zero_pad(hq, ld, H);
    }
    __syncthreads();
    const tc::Operand next = i + 1 < L - 1 ? fwd(i + 1) : tc::Operand{};
    tc::mm64<KS, P>(qp, ldp, op, i + 1 < L - 1 ? &next : nullptr, ring,
                    [&](int l, int o) { return tc::softplus_grad_fast(h[l * ld + o], beta); },
                    [&](int l, int o, float acc, float g) {
                      if (wp != nullptr) {
                        acc = fmaf(__ldg(wp + o * 3), vs[l], acc);
                        acc = fmaf(__ldg(wp + o * 3 + 1), vs[T + l], acc);
                        acc = fmaf(__ldg(wp + o * 3 + 2), vs[2 * T + l], acc);
                      }
                      hq[l * ld + o] = g * acc;
                    });
    __syncthreads();
    float* R = sc + sr.hq[i] * M2;
    store_rows(h, ld, H, R, M2, p0);
    store_rows(hq, ld, H, R, M2, M + p0);
    const int old_q = qb;
    qb = hb;
    hb = fb;
    fb = old_q;
  }
}

// K6, second pass, one block per (chunk member, 64-point tile): the dual
// reverse sweep of phi = <dF, F> + <dG, G>, reading h_i and q_i back:
//     zbar_i = ubar_i softplus'(z_i) + vbar_i beta e^{-beta h_i} q_i
//     pbar_i = vbar_i softplus'(z_i)
//     ubar_{i-1} = W_i^T zbar_i,  vbar_{i-1} = W_i^T pbar_i
// Each hidden product i runs two 3xTF32 products on the staged W_i^T: vbar
// first, stored raw in the free buffer, then ubar, whose epilogue gathers
// h_{i-1} and q_{i-1} from the scratch once (mm64's pre hook) and writes
// zbar_{i-1} over vbar and pbar_{i-1} into pbar_i's vacated buffer.  The seeds and
// the head-weight partials read the last layer's scratch rows in one
// warp-per-column pass; bias partials (tc::colsum64), point-weight partials
// (point_wgrad) and d(coords) (field::point_grad) close with fixed-order
// shuffle trees.  Writes d(coords), per-block partials and the [zbar_i |
// pbar_i] rows of every hidden product; culled pairs write zeros.
template <int KS, int P>
__global__ void __launch_bounds__(field::kThreads, 1)
train_bwd_rev_kernel(nphm::Trunk tr, const __grid_constant__ field::Maps maps,
                     const float* __restrict__ coords, const float* __restrict__ dF,
                     const float* __restrict__ dG, const int* __restrict__ active,
                     float* __restrict__ dcoords, float* __restrict__ part,
                     float* __restrict__ scr, int64_t M, int n_members, int cull_tile,
                     int hsum, int buf_floats, int stage, int m0, int n_part, int64_t scr_ms) {
  constexpr int T = field::kRows;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = (int)tr.n_layers;
  const int skip = (int)tr.skip;
  const float beta = (float)tr.beta;
  const int c_m = blockIdx.x;
  const int m = m0 + c_m;
  const int64_t blk = blockIdx.y;
  const int64_t p0 = blk * T;
  const int64_t M2 = 2 * M;
  const int t = threadIdx.x;
  const int lane = t & 31;
  float* pb = part + ((int64_t)c_m * gridDim.y + blk) * n_part;
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
    for (int i = 1; i < L - 1; ++i) zero_rows<P>(sc + sr.zp[i] * M2, (int)tr.n_out[i], M, p0);
    return;
  }

  if constexpr (P == tc::kBF16Mma)
    prefetch_rows(sc + sr.hq[L - 2] * M2, (int)tr.n_out[L - 2], M, p0);
  float* xs = smem + 3 * buf_floats;
  float* vs = xs + 3 * T;
  float* dg = vs + 3 * T;
  float* dfs = dg + 3 * T;
  tc::Ring ring = field::make_ring(smem + 3 * buf_floats + kPointFloats, stage);
  if (t < T) {
    for (int c = 0; c < 3; ++c) {
      xs[c * T + t] = coords[((int64_t)m * 3 + c) * M + p0 + t];
      vs[c * T + t] = dG[((int64_t)m * 3 + c) * M + p0 + t];
      dg[c * T + t] = 0.f;
    }
    dfs[t] = dF[(int64_t)m * M + p0 + t];
  }
  field::init_ring(ring);
  __syncthreads();
  auto rev = [&](int i) {
    return tc::Operand{&maps.rev[i - 1], m * (int)tr.n_in[i], (int)tr.n_out[i],
                       (int)tr.n_in[i]};
  };

  // buffer offsets: zbar_i, pbar_i, free
  int zo = 0, po = buf_floats, fo = 2 * buf_floats;
  // seeds of the last hidden layer (ubar = wlast dF, vbar = wlast) and the
  // head-weight partial sum over the tile of h dF + q: warp per column
  {
    const int H = (int)tr.n_out[L - 2];
    const int ld = tc::act_ld(H);
    const float* __restrict__ wl = tr.w[L - 1] + m * tr.w_ms[L - 1];
    const float* R = sc + sr.hq[L - 2] * M2;
    float* z = smem + zo;
    float* p = smem + po;
    for (int o = t >> 5; o < H; o += tc::kMmaWarps) {
      const float w = __ldg(wl + o);
      float s = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = lane + 32 * h;
        const float hv = R[o * M2 + p0 + l];
        const float qv = R[o * M2 + M + p0 + l];
        s = fmaf(hv, dfs[l], s) + qv;
        const float e = __expf(-beta * hv);
        z[l * ld + o] = w * dfs[l] * (1.f - e) + w * beta * e * qv;
        p[l * ld + o] = w * (1.f - e);
      }
      s = field::warp_sum(s);
      if (lane == 0) pb[off_wlast + o] = s;
    }
    field::zero_pad(z, ld, H);
    field::zero_pad(p, ld, H);
    __syncthreads();
  }

  for (int i = L - 2; i >= 0; --i) {
    const int H = (int)tr.n_out[i];
    const int ld = tc::act_ld(H);
    float* z = smem + zo;
    float* p = smem + po;
    tc::colsum64(z, ld, H, pb + boff[i]);
    if (i == 0 || i == skip) {
      point_wgrad(z, p, ld, H, xs, vs, pb + (i == 0 ? off_wp0 : off_wps));
      field::point_grad(z, ld, H, i == 0 ? tr.w[0] + m * tr.w_ms[0] : tr.wp + m * tr.wp_ms,
                        dg);
    }
    if (i > 0) {
      float* R = sc + sr.zp[i] * M2;
      store_rows<P>(z, ld, H, R, M2, p0);
      store_rows<P>(p, ld, H, R, M2, M + p0);
      const int Hin = (int)tr.n_in[i];
      const int ldv = tc::act_ld(Hin);
      const float* Hr = sc + sr.hq[i - 1] * M2;  // [h_{i-1} | q_{i-1}]
      if constexpr (P == tc::kBF16Mma) prefetch_rows(Hr, Hin, M, p0);
      float* u = smem + fo;  // vbar_{i-1}, then zbar_{i-1}
      const tc::Operand op = rev(i);
      field::zero_pad(u, ldv, Hin);
      tc::mm64<KS, P>(p, ld, op, &op, ring, [&](int, int) { return 0.f; },
                      [&](int l, int k, float acc, float) { u[l * ldv + k] = acc; });
      __syncthreads();
      field::zero_pad(p, ldv, Hin);  // pbar_i's buffer now takes pbar_{i-1}
      const tc::Operand next = i > 1 ? rev(i - 1) : tc::Operand{};
      tc::mm64<KS, P>(z, ld, op, i > 1 ? &next : nullptr, ring,
                      [&](int l, int k) {
                        return make_float2(Hr[k * M2 + p0 + l], Hr[k * M2 + M + p0 + l]);
                      },
                      [&](int l, int k, float acc, float2 hq) {
                        const float e = __expf(-beta * hq.x);
                        const float vb = u[l * ldv + k];
                        u[l * ldv + k] = acc * (1.f - e) + vb * beta * e * hq.y;
                        p[l * ldv + k] = vb * (1.f - e);
                      });
      const int old_z = zo;
      zo = fo;
      fo = old_z;
    }
    __syncthreads();
  }
  if (t < T)
    for (int c = 0; c < 3; ++c) dcoords[((int64_t)m * 3 + c) * M + p0 + t] = dg[c * T + t];
}

// Floats of a contraction ring stage's B slice: [round8(C)][kCtrSlice]
// lanes of the B rows, fp32 (bf16 at tc::kBF16Mma: half the floats).
__host__ __device__ __forceinline__ int ctr_b_floats(int C, int P) {
  return ((C + 7) & ~7) * kCtrSlice / (P == tc::kBF16Mma ? 2 : 1);
}

// Floats of one contraction ring stage: a [64][kCtrSlice] fp32 slice of
// the A rows, then the B slice, rounded up to 1 KB.
__host__ __device__ __forceinline__ int ctr_stage_floats(int C, int P) {
  return (kCtrRows * kCtrSlice + ctr_b_floats(C, P) + 255) & ~255;
}

// Bytes of shared memory of the contraction over trunk *tr at route P: its
// ring, sized for the widest B side (the hidden inputs; at tc::kBF16Mma
// the hidden outputs, whose [zbar | pbar] rows are the B side there), 1 KB
// alignment, the mbarriers.
inline int ctr_smem(const nphm::Trunk* tr, int P) {
  int cmax = 8;
  for (int i = 1; i < (int)tr->n_layers - 1; ++i) {
    const int c = (int)(P == tc::kBF16Mma ? tr->n_out[i] : tr->n_in[i]);
    cmax = c > cmax ? c : cmax;
  }
  return 4 * kCtrStages * ctr_stage_floats(cmax, P) + 1024 + 16 * kCtrStages;
}

// One warp's share of a contraction block: its NJ n8 tiles (grp + 8j) of
// the C columns over the m16 tiles of its 32 rows, as tc::mm64_warp (at
// route P), with both operands streamed through the ring.  At kBF16Mma the
// sides swap: A is the fp32 [h | q] rows, packed two a register in kPerm
// order as mm64 packs activations, B the bf16 [zbar | pbar] rows stored in
// that order, loaded as they are (the side re-read by each row tile is the
// half-size one), one m16n8k16 .bf16 MMA per 16 lanes, and the output is
// written transposed.
template <int NJ, int P>
__device__ __forceinline__ void contract_warp(const CUtensorMap* ma, const CUtensorMap* mb,
                                              int row_a, int row_b, int C, int sl0, int n_sl,
                                              float* buf, int stage, uint64_t* full,
                                              uint64_t* empty, float* __restrict__ out,
                                              int r0, int R) {
  const int warp = threadIdx.x >> 5;
  const int grp = warp >> 1;
  const int m_base = (warp & 1) * 32;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const uint32_t bytes = (uint32_t)(kCtrRows * kCtrSlice + ctr_b_floats(C, P)) * 4;
  float acc[NJ > 0 ? NJ : 1][tc::kMT][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mt = 0; mt < tc::kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;

  int issued = 0;
  for (int s = 0; s < n_sl; ++s) {
    if (threadIdx.x == tc::kProducer) {
      const int target = s + kCtrStages < n_sl ? s + kCtrStages : n_sl;
      for (; issued < target; ++issued) {
        const int st = issued % kCtrStages;
        if (issued >= kCtrStages) tc::mbar_wait(&empty[st], (issued / kCtrStages - 1) & 1);
        float* dst = buf + st * stage;
        tc::mbar_expect_tx(&full[st], bytes);
        tc::tma_load_2d(dst, ma, &full[st], (sl0 + issued) * kCtrSlice, row_a);
        tc::tma_load_2d(dst + kCtrRows * kCtrSlice, mb, &full[st], (sl0 + issued) * kCtrSlice,
                        row_b);
      }
    }
    const int st = s % kCtrStages;
    tc::mbar_wait(&full[st], (s / kCtrStages) & 1);
    const float* a = buf + st * stage;
    const float* b = a + kCtrRows * kCtrSlice;
    if constexpr (NJ > 0 && P == tc::kBF16Mma) {
      // B: the slice's bf16 rows are kCtrSlice / 2 words (64-byte swizzle),
      // both k16 steps in one ldmatrix x4
      uint32_t bf[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        tc::ldsm_x4(bf[j], b + tc::swz<kCtrSlice / 2>((grp + tc::kGroups * j) * 8 + (lane & 7),
                                                      (lane >> 3) << 2));
#pragma unroll
      for (int kh = 0; kh < kCtrSlice; kh += 16) {
        uint32_t af[tc::kMT][4];
#pragma unroll
        for (int mt = 0; mt < tc::kMT; ++mt) {
          uint32_t r[4], q[4];
          const int row = m_base + mt * 16 + (lane & 15);
          tc::ldsm_x4(r, a + tc::swz<kCtrSlice>(row, kh + ((lane >> 4) << 2)));
          tc::ldsm_x4(q, a + tc::swz<kCtrSlice>(row, kh + 8 + ((lane >> 4) << 2)));
          af[mt][0] = tc::pack_bf16(r[0], r[2]);
          af[mt][1] = tc::pack_bf16(r[1], r[3]);
          af[mt][2] = tc::pack_bf16(q[0], q[2]);
          af[mt][3] = tc::pack_bf16(q[1], q[3]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int mt = 0; mt < tc::kMT; ++mt)
            tc::mma_bf16(acc[j][mt], af[mt], bf[j][kh / 8], bf[j][kh / 8 + 1]);
      }
    } else if constexpr (NJ > 0) {
#pragma unroll
      for (int kh = 0; kh < kCtrSlice; kh += 16) {
        // B fragments of 16 lanes: bf[j][2 * (kk / 8) + {0, 1}]
        uint32_t bf[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          tc::ldsm_x4(bf[j], b + tc::swz<kCtrSlice>((grp + tc::kGroups * j) * 8 + (lane & 7),
                                                    kh + ((lane >> 3) << 2)));
#pragma unroll
        for (int kk = 0; kk < 16; kk += 8) {
          uint32_t ab[tc::kMT][4], as[tc::kMT][4], bb[NJ][2], bs[NJ][2];
#pragma unroll
          for (int mt = 0; mt < tc::kMT; ++mt) {
            uint32_t r[4];
            tc::ldsm_x4(r, a + tc::swz<kCtrSlice>(m_base + mt * 16 + (lane & 15),
                                                  kh + kk + ((lane >> 4) << 2)));
#pragma unroll
            for (int e = 0; e < 4; ++e) tc::load_operand<P>(r[e], ab[mt][e], as[mt][e]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            tc::load_operand<P>(bf[j][kk / 4], bb[j][0], bs[j][0]);
            tc::load_operand<P>(bf[j][kk / 4 + 1], bb[j][1], bs[j][1]);
          }
          if constexpr (P == tc::kF32) {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int mt = 0; mt < tc::kMT; ++mt) tc::mma_tf32(acc[j][mt], as[mt], bb[j]);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int mt = 0; mt < tc::kMT; ++mt) tc::mma_tf32(acc[j][mt], ab[mt], bs[j]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int mt = 0; mt < tc::kMT; ++mt) tc::mma_tf32(acc[j][mt], ab[mt], bb[j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mt = 0; mt < tc::kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (grp + tc::kGroups * j) * 8 + 2 * tig + (e & 1);
        const int r = r0 + m_base + mt * 16 + gid + 8 * (e >> 1);
        if (n < C && r < R)
          out[P == tc::kBF16Mma ? (int64_t)n * R + r : (int64_t)r * C + n] = acc[j][mt][e];
      }
}

// K6's lane contraction on the tensor cores: part[c][s][r][k] = sum over
// the lanes of split s of S[c][row_a + r][j] * S[c][row_b + k][j], for r <
// R, k < C, with S the scratch of chunk member c ([scr_rows][2M], both
// operands K-major: lanes contiguous).  One block per (64 output rows,
// split, member): it owns all C columns (up to tc::kMaxN), so each B row is
// read from device memory about once and re-read from L2 by the block's
// neighbours over the other row tiles (row tiles fastest in the grid).
// Both operands stream by TMA (128-byte swizzle) through a kCtrStages
// ring, mma.sync at precision P as mm64; the splits' partials are summed
// in a fixed order by sum_splits.
template <int P>
__global__ void __launch_bounds__(field::kThreads, 1)
lane_contract(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
              float* __restrict__ part, int scr_rows, int row_a, int row_b, int R, int C,
              int n_sl_total, int stage) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  float* buf = base + ((1024u - (tc::smem_u32(base) & 1023u)) & 1023u) / sizeof(float);
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + kCtrStages * stage);
  uint64_t* empty = full + kCtrStages;
  const int r0 = blockIdx.x * kCtrRows;
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  const int per = (n_sl_total + kSplitK - 1) / kSplitK;
  const int sl0 = s * per;
  const int n_sl = sl0 < n_sl_total ? min(per, n_sl_total - sl0) : 0;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kCtrStages; ++k) {
      tc::mbar_init(&full[k], 1);
      tc::mbar_init(&empty[k], tc::kMmaWarps);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();
  float* out = part + ((int64_t)c * kSplitK + s) * R * C;
  const int ra = c * scr_rows + row_a + r0;
  const int rb = c * scr_rows + row_b;
  const int grp = threadIdx.x >> 6;
  const int NT = (C + 7) >> 3;
  const int nj = NT > grp ? (NT - grp + tc::kGroups - 1) / tc::kGroups : 0;
  switch (nj) {
    case 0: contract_warp<0, P>(&ma, &mb, ra, rb, C, sl0, n_sl, buf, stage, full, empty, out, r0, R); break;
    case 1: contract_warp<1, P>(&ma, &mb, ra, rb, C, sl0, n_sl, buf, stage, full, empty, out, r0, R); break;
    case 2: contract_warp<2, P>(&ma, &mb, ra, rb, C, sl0, n_sl, buf, stage, full, empty, out, r0, R); break;
    case 3: contract_warp<3, P>(&ma, &mb, ra, rb, C, sl0, n_sl, buf, stage, full, empty, out, r0, R); break;
    default: contract_warp<tc::kNT, P>(&ma, &mb, ra, rb, C, sl0, n_sl, buf, stage, full, empty, out, r0, R); break;
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

unsigned n_grid(int64_t n) { return (unsigned)((n + 255) / 256); }

}  // namespace

extern "C" int nphm_train_fwd_lanes_per_block() { return field::kRows; }
extern "C" int nphm_train_lanes_per_block() { return field::kRows; }
extern "C" int nphm_train_split_k() { return kSplitK; }

#ifdef NPHM_PHASE_CLOCKS
// out[tc::kPhaseSlots] = this file's phase clocks (tc::PhaseClock), summed
// over the blocks since the last reset; zeroed after the read when `reset`.
extern "C" int nphm_train_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tc::phase_cycles, sizeof(tc::phase_cycles));
  if (err == cudaSuccess && reset) {
    const unsigned long long zeros[tc::kPhaseSlots] = {};
    err = cudaMemcpyToSymbol(tc::phase_cycles, zeros, sizeof(zeros));
  }
  return (int)err;
}
#endif

// coords: [A][3][M]; active: [M / cull_tile][A] -> F [A][M], G [A][3][M].
// M and cull_tile are multiples of 64; every hidden product is at most
// tc::kMaxN wide; route: tc::kF32, kTF32 or kBF16Mma (the hidden weights
// of *tr then bf16, field::setup).
extern "C" int nphm_train_fwd(const nphm::Trunk* tr, const float* coords,
                              const int* active, float* F, float* G, int64_t M,
                              int n_members, int cull_tile, int route, void* stream) {
  if (M % field::kRows != 0 || cull_tile % field::kRows != 0 ||
      tr->row_len % field::kRows != 0)
    return (int)cudaErrorInvalidValue;
  field::Maps maps = {};
  field::Launch ln;
  const int rc = field::setup(tr, n_members, true, &maps, &ln, 0, 8 * field::kRows, 16, route);
  if (rc != 0) return rc;
  return field::with_route<tc::kF32, tc::kTF32, tc::kBF16Mma>(route, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return field::launch(train_fwd_kernel<16, P>, train_fwd_kernel<8, P>, ln, n_members, M,
                         stream, *tr, maps, coords, active, F, G, M, n_members, cull_tile,
                         ln.act_floats, ln.stage);
  });
}

// One chunk of members [m0, m0 + n_chunk) of the backward: + dF [A][M],
// dG [A][3][M] -> dcoords [A][3][M] and every gradient in *g.  Scratch:
// part [n_chunk][M / 64][n_part], scr [n_chunk][scr_rows][2M], gsp
// [n_chunk][max(kSplitK * max n_out * n_in, n_rows * widest partial
// group)] (the split partials, and first the per-row partial sums).  M and
// cull_tile are multiples of 64, each row's lanes of 64; every hidden
// product is at most tc::kMaxN wide.
template <int P>
static int train_bwd(const nphm::Trunk* tr, const TrainGrads* g, const float* coords,
                     const float* dF, const float* dG, const int* active, float* dcoords,
                     float* part, float* scr, float* gsp, int64_t M, int n_members, int n_rows,
                     int cull_tile, int hsum, int m0, int n_chunk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int L = (int)tr->n_layers;
  const int skip = (int)tr->skip;
  const int H0 = (int)tr->n_out[0];
  const int HS = (int)tr->n_out[skip];
  const int Hl = (int)tr->n_out[L - 2];
  const int n_part = hsum + 3 * H0 + 3 * HS + Hl;
  const ScratchRows sr = scratch_rows(*tr);
  const int64_t M2 = 2 * M;
  const int64_t scr_ms = sr.total * M2;
  const int64_t n_blk = M / field::kRows;
  if (M % field::kRows != 0 || cull_tile % field::kRows != 0 || n_blk % n_rows != 0)
    return (int)cudaErrorInvalidValue;

  // the two passes: field_tile.cuh's launch sizing with three activation
  // buffers and K6's per-point values
  field::Maps maps = {};
  field::Launch ln;
  int rc = field::setup(tr, n_members, true, &maps, &ln, 3, kPointFloats, 16, P);
  if (rc != 0) return rc;
  const int buf_floats = ln.act_floats / 3;
  rc = field::launch(train_bwd_fwd_kernel<16, P>, train_bwd_fwd_kernel<8, P>, ln, n_chunk, M,
                     stream, *tr, maps, coords, dG, active, scr, M, n_members, cull_tile,
                     buf_floats, ln.stage, m0, scr_ms);
  if (rc != 0) return rc;
  rc = field::launch(train_bwd_rev_kernel<16, P>, train_bwd_rev_kernel<8, P>, ln, n_chunk, M,
                     stream, *tr, maps, coords, dF, dG, active, dcoords, part, scr, M,
                     n_members, cull_tile, hsum, buf_floats, ln.stage, m0, n_part, scr_ms);
  if (rc != 0) return rc;

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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // hidden weight gradients: contract the scratch over the lanes
  const int smem = ctr_smem(tr, P);
  err = cudaFuncSetAttribute(lane_contract<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)n_chunk * sr.total;
  const int n_sl = (int)((M2 + kCtrSlice - 1) / kCtrSlice);
  CUtensorMap ma, mb;
  rc = tc::make_map(&ma, scr, (int)M2, rows, (int)M2, kCtrSlice, kCtrRows);
  if (rc != 0) return rc;
  for (int i = 1; i < L - 1; ++i) {
    const int R = (int)tr->n_out[i];
    const int C = (int)tr->n_in[i];
    if constexpr (P == tc::kBF16Mma) {
      // rows: the fp32 [h | q] rows (ma); columns: the [zbar | pbar] rows,
      // bf16 over the first half of each 2M-float row (store_rows)
      rc = tc::make_map(&mb, scr, (int)M2, rows, 2 * M2, kCtrSlice, (R + 7) & ~7, true);
      if (rc != 0) return rc;
      const dim3 grid((unsigned)((C + kCtrRows - 1) / kCtrRows), kSplitK, (unsigned)n_chunk);
      lane_contract<P><<<grid, field::kThreads, smem, st>>>(
          ma, mb, gsp, (int)sr.total, (int)sr.hq[i - 1], (int)sr.zp[i], C, R, n_sl,
          ctr_stage_floats(R, P));
    } else {
      rc = tc::make_map(&mb, scr, (int)M2, rows, (int)M2, kCtrSlice, (C + 7) & ~7);
      if (rc != 0) return rc;
      const dim3 grid((unsigned)((R + kCtrRows - 1) / kCtrRows), kSplitK,
                      (unsigned)n_chunk);
      lane_contract<P><<<grid, field::kThreads, smem, st>>>(
          ma, mb, gsp, (int)sr.total, (int)sr.zp[i], (int)sr.hq[i - 1], R, C, n_sl,
          ctr_stage_floats(C, P));
    }
    const int64_t rc_el = (int64_t)R * C;
    sum_splits<<<n_grid(n_chunk * rc_el), 256, 0, st>>>(
        gsp, g->dw[i] + (int64_t)m0 * rc_el, n_chunk, rc_el);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// occupancy(out[4]) of K5 (`which` 0) or of K6's first pass (1), second
// pass (2) or lane contraction (3) at `route` as they launch over trunk *tr
// (field::occupancy): registers, local bytes, shared memory, blocks per
// SM.
extern "C" int nphm_train_occupancy(const nphm::Trunk* tr, int n_members, int which,
                                    int route, int* out) {
  field::Maps maps = {};
  field::Launch ln;
  if (which == 0) {
    const int rc =
        field::setup(tr, n_members, true, &maps, &ln, 0, 8 * field::kRows, 16, route);
    if (rc != 0) return rc;
    return field::with_route<tc::kF32, tc::kTF32, tc::kBF16Mma>(route, [&](auto p) {
      constexpr int P = decltype(p)::value;
      return field::occupancy(ln.ks == 16 ? train_fwd_kernel<16, P> : train_fwd_kernel<8, P>,
                              field::kThreads, ln.smem, out);
    });
  }
  const int rc = field::setup(tr, n_members, true, &maps, &ln, 3, kPointFloats, 16, route);
  if (rc != 0) return rc;
  return field::with_route<tc::kF32, tc::kTF32, tc::kBF16Mma>(route, [&](auto p) {
    constexpr int P = decltype(p)::value;
    if (which == 3)
      return field::occupancy(lane_contract<P>, field::kThreads, ctr_smem(tr, P), out);
    if (which == 1)
      return field::occupancy(ln.ks == 16 ? train_bwd_fwd_kernel<16, P>
                                          : train_bwd_fwd_kernel<8, P>,
                              field::kThreads, ln.smem, out);
    return field::occupancy(ln.ks == 16 ? train_bwd_rev_kernel<16, P>
                                        : train_bwd_rev_kernel<8, P>,
                            field::kThreads, ln.smem, out);
  });
}

// The backward at route `route`: train_bwd<P> above at tc::kF32, kTF32
// or kBF16Mma (bf16 hidden weights, field::setup).
extern "C" int nphm_train_bwd(const nphm::Trunk* tr, const TrainGrads* g,
                              const float* coords, const float* dF,
                              const float* dG, const int* active,
                              float* dcoords, float* part, float* scr,
                              float* gsp, int64_t M, int n_members, int n_rows,
                              int cull_tile, int hsum, int m0, int n_chunk, int route,
                              void* stream) {
  return field::with_route<tc::kF32, tc::kTF32, tc::kBF16Mma>(route, [&](auto p) {
    return train_bwd<decltype(p)::value>(tr, g, coords, dF, dG, active, dcoords, part, scr,
                                         gsp, M, n_members, n_rows, cull_tile, hsum, m0,
                                         n_chunk, stream);
  });
}
