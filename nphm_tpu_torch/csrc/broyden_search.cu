// K2: the whole warm Broyden root-find of g(x) = x + delta(x) - obs through
// the deformation trunk, one lane per (obs, point), on the tensor cores.
//
// Replaces nphm_tpu/ops/pallas_search.py::broyden_search_pallas (body
// _make_search_kernel).  A block owns a tile of 32 lanes: residual init,
// then good-Broyden rank-1 inverse-Jacobian updates up to a runtime budget,
// with best-iterate tracking, convergence at `cvg`, divergence at `dvg`.
// The block leaves its loop as soon as none of its lanes is active (a warp
// vote), and writes its executed iteration count; the wrapper takes the max
// over blocks.  Lanes come in groups (a batched fit's subjects) of
// group_real lanes, each padded to group_pad (a multiple of 32), so no
// tile holds lanes of two groups; padding lanes never count as active.
// Per-obs conditioning biases reach each lane through its row index
// (compact lane / row_len).
//
// Bound on this card: at the fit's 5000 lanes and ~3 trunk evaluations a
// lane, the 3xTF32 products (1.07 M multiply-adds an evaluation at the
// 6x512 trunk) take ~0.2 ms at 495 TFLOP/s of TF32, and the trunk's 4.3 MB
// of weights, read from L2 once per block and evaluation (~2 GB a call),
// about as long again.  Design:
// - every hidden product is 3xTF32 mma.sync m16n8k8 (tc_tile.cuh's split in
//   registers, ldmatrix fragments): fp32 within ~2^-21 a product, so the
//   residuals still reach the 1e-6 threshold (one TF32 or bf16 pass stalls
//   them above it);
// - one [32][act_ld(512)] point-major activation tile (66 KB) serves as the
//   input and the output of a layer: a warp holds all of its outputs (both
//   256-wide halves of a 512-wide layer, 64 sums a thread) in registers
//   until a block barrier says every warp has read the input;
// - the K-major weights (wt, [n_out][ldwt]) stream by TMA through a
//   2-stage ring of [256][16] slices (16 KB, 64-byte swizzle), one
//   producer thread issuing ahead into the layer's second half and the
//   next layer;
// - so a block takes ~102 KB and 8 warps: two blocks share an SM, and the
//   fit's 157 tiles run in one wave over the 132 SMs.  Measured in one
//   call against the alternatives (NVIDIA H100 80GB HBM3, 700.00 W; cold
//   search at the fit's shapes): this ring 1.37 ms; four [256][8] stages
//   1.70 (five 1.74); one block an SM with a deeper ring (sixteen or eight
//   [256][8] stages, six [256][16]) 2.60, 2.57, 1.86 ms.  The per-slice
//   barrier work costs more than the copies' latency;
// - the per-lane Broyden state lives in shared memory, touched only by
//   warp 0 between trunk evaluations: in registers it would stay live
//   across the products, whose accumulators already take half of a
//   thread's 128 registers at two blocks an SM;
// - layer 0 (3 point inputs), the skip layer's point term, bias and
//   softplus (tc::softplus_fast: 5% faster than the libm form) are fp32 in
//   the products' epilogues; the 3-output head is a
//   warp-per-4-rows dot closed by a fixed-order shuffle tree.
// Every sum has a fixed order: two calls are bit-identical.
//
// First design (fp32 SIMT, 256 threads a block with two [512][32] buffers,
// weights read with __ldg): 4.26 ms at the fit's shapes (NVIDIA H100 80GB
// HBM3, 700.00 W).
#include "mlp_tile.cuh"
#include "tc_tile.cuh"

namespace {

namespace tc = nphm::tc;

constexpr int kLanes = 32;                     // lanes (points) of a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKS = 16;                        // K slice of a ring stage
constexpr int kStages = 2;                     // ring depth
constexpr int kBlocksPerSM = 2;                // blocks an SM holds (registers, smem)
constexpr int kHalf = 256;                     // outputs of one half product: a box's rows
constexpr int kNJ = kHalf / 8 / kWarps;        // n8 tiles a warp owns in a half
constexpr int kMaxWidth = 2 * kHalf;           // widest non-head layer
constexpr int kProducer = 32 * (kWarps - 1);   // the thread that issues the TMA copies

// Per-lane Broyden state in shared memory, [field][kLanes].
enum : int { kO = 0, kX = 3, kGx = 6, kUpd = 9, kDx = 12, kJ = 15, kXb = 24, kBn = 27, kFields = 28 };

// TMA descriptors of each hidden layer i (1 <= i <= L-2): wt[i] as
// [n_out][ldwt], boxes of kKS columns x the rows of the first 256 outputs
// (half[0]) and of the rest (half[1], layers wider than 256).
struct Maps {
  CUtensorMap half[2][nphm::kMaxLayers - 2];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float softplus(float x, float beta) {
  return tc::softplus_fast(x, beta, 1.f / beta);
}

__device__ __forceinline__ void matvec3(const float* j, const float* v, float* out) {
  for (int i = 0; i < 3; ++i) {
    float acc = j[3 * i] * v[0];
    acc += j[3 * i + 1] * v[1];
    acc += j[3 * i + 2] * v[2];
    out[i] = acc;
  }
}

// One half of a hidden product: acc[j][mt] (j < NJ) += A[32][K] B^T over the
// n8 tiles warp + 8j of `op`'s rows, both m16 tiles.  Every warp walks the
// ring (NJ = 0 too): it waits for each slice and releases it.
template <int NJ>
__device__ __forceinline__ void half_loop(float (&acc)[kNJ][2][4], const float* A, int lda,
                                          const tc::Operand& op, const tc::Operand* next,
                                          tc::Ring& ring) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int K8 = (op.K + 7) & ~7;
  const int n_sl = tc::n_slices<kKS>(op.K);
  // ldmatrix rows: A rows (lane & 15) (+16), k half (lane >> 4); B rows
  // nt*8 + (lane & 7), k chunk (lane >> 3) (an x2 reads lanes 0-15's)
  const float* a_lane = A + (lane & 15) * lda + ((lane >> 4) << 2);
  const int b_row = lane & 7;
  const int b_chunk = (lane >> 3) << 2;
  for (int s = 0; s < n_sl; ++s) {
    const uint32_t g = ring.slices + s;
    if (threadIdx.x == kProducer) tc::ring_issue<kKS, kStages>(ring, op, next, g + kStages);
    tc::mbar_wait(&ring.full[g % kStages], (g / kStages) & 1);
    if constexpr (NJ > 0) {
      const float* buf = ring.buf + (g % kStages) * ring.stage;
      const int k0 = s * kKS;
      // B fragments of the slice: bf[j][2 * (kk / 8) + {0, 1}]
      uint32_t bf[NJ][kKS / 4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* bp = buf + tc::swz<kKS>((warp + kWarps * j) * 8 + b_row, b_chunk);
        if (kKS == 16) {
          tc::ldsm_x4(*reinterpret_cast<uint32_t(*)[4]>(&bf[j][0]), bp);
        } else {
          tc::ldsm_x2(*reinterpret_cast<uint32_t(*)[2]>(&bf[j][0]), bp);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 8) {
        if (k0 + kk < K8) {
          uint32_t ab[2][4], as[2][4], bb[NJ][2], bs[NJ][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t r[4];
            tc::ldsm_x4(r, a_lane + mt * 16 * lda + k0 + kk);
#pragma unroll
            for (int e = 0; e < 4; ++e) tc::split_mma(r[e], ab[mt][e], as[mt][e]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            tc::split_mma(bf[j][kk / 4], bb[j][0], bs[j][0]);
            tc::split_mma(bf[j][kk / 4 + 1], bb[j][1], bs[j][1]);
          }
          // small*big, big*small, then big*big: each pass's MMAs independent
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) tc::mma_tf32(acc[j][mt], as[mt], bb[j]);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) tc::mma_tf32(acc[j][mt], ab[mt], bs[j]);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) tc::mma_tf32(acc[j][mt], ab[mt], bb[j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&ring.empty[g % kStages]);
  }
  ring.slices += n_sl;
}

__device__ __forceinline__ int warp_tiles(int N) {
  const int warp = threadIdx.x >> 5;
  const int nt = (N + 7) >> 3;
  return nt > warp ? (nt - warp + kWarps - 1) / kWarps : 0;
}

// A hidden product in place: for t < 32, n < N = ops[0].N (+ ops[1].N),
// epi(t, n, sum_k A[t][k] W[n][k]) may overwrite A.  The halves run in
// turn, their sums held in registers; a block barrier after the last
// slice orders every read of A before the first store.
template <class Epi>
__device__ __forceinline__ void product(float* A, int lda, const tc::Operand (&ops)[2],
                                        int n_ops, const tc::Operand* next, tc::Ring& ring,
                                        Epi epi) {
  float acc[2][kNJ][2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][mt][e] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h < n_ops) {
      const tc::Operand* nx = h + 1 < n_ops ? &ops[h + 1] : next;
      switch (warp_tiles(ops[h].N)) {
        case 0: half_loop<0>(acc[h], A, lda, ops[h], nx, ring); break;
        case 1: half_loop<1>(acc[h], A, lda, ops[h], nx, ring); break;
        case 2: half_loop<2>(acc[h], A, lda, ops[h], nx, ring); break;
        case 3: half_loop<3>(acc[h], A, lda, ops[h], nx, ring); break;
        default: half_loop<kNJ>(acc[h], A, lda, ops[h], nx, ring); break;
      }
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  // fragment element e of tile (j, mt): row mt*16 + gid + 8 (e >> 1),
  // column (warp + 8j) * 8 + 2 tig + (e & 1) of the half
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h < n_ops) {
      const int nj = warp_tiles(ops[h].N);
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        if (j < nj) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int n = (warp + kWarps * j) * 8 + 2 * tig + (e & 1);
              if (n < ops[h].N) epi(mt * 16 + gid + 8 * (e >> 1), h * kHalf + n, acc[h][j][mt][e]);
            }
        }
      }
    }
  }
}

// Zero columns [w, round8(w)) of the [32][ld] tile: the products read
// activation columns up to the next multiple of 8.
__device__ __forceinline__ void zero_pad(float* h, int ld, int w) {
  const int pad = ((w + 7) & ~7) - w;
  for (int it = threadIdx.x; it < pad * kLanes; it += kThreads)
    h[(it / pad) * ld + w + it % pad] = 0.f;
}

// head[c][t] = delta_c(x_t) for c < 3: the trunk at the block's lanes xs
// ([3][32]), conditioning rows `rows`.  Every thread calls it; it ends
// synchronised.
__device__ __forceinline__ void trunk_eval(const nphm::Trunk& tr, const Maps& maps,
                                           tc::Ring& ring, float* act, int ld,
                                           const float* xs, const int* rows, float* head) {
  const int L = (int)tr.n_layers;
  const int skip = (int)tr.skip;
  const float beta = (float)tr.beta;
  const int t = threadIdx.x;
  {
    // layer 0 from the 3 point inputs: a thread per output column and
    // 8-row block
    const int H = (int)tr.n_out[0];
    const float* __restrict__ w = tr.w[0];
    const float* __restrict__ b = tr.b[0];
    const int64_t brs = tr.b_rs[0];
    for (int it = t; it < H * (kLanes / 8); it += kThreads) {
      const int o = it % H;
      const int l0 = (it / H) * 8;
      const float w0 = __ldg(w + o * 3), w1 = __ldg(w + o * 3 + 1), w2 = __ldg(w + o * 3 + 2);
#pragma unroll 4
      for (int l = l0; l < l0 + 8; ++l) {
        float z = w0 * xs[l];
        z = fmaf(w1, xs[kLanes + l], z);
        z = fmaf(w2, xs[2 * kLanes + l], z);
        act[l * ld + o] = softplus(z + __ldg(b + rows[l] * brs + o), beta);
      }
    }
    zero_pad(act, ld, H);
    __syncthreads();
  }
  for (int i = 1; i < L - 1; ++i) {
    const int N = (int)tr.n_out[i];
    const int K = (int)tr.n_in[i];
    const tc::Operand ops[2] = {
        tc::Operand{&maps.half[0][i - 1], 0, K, N < kHalf ? N : kHalf},
        tc::Operand{&maps.half[1][i - 1], kHalf, K, N - kHalf}};
    // the ring runs on into the next layer's first half; not past the last
    // hidden layer, so no copy is in flight when the block exits
    const bool more = i + 1 < L - 1;
    const int n_next = more ? (int)tr.n_out[i + 1] : 0;
    const tc::Operand next{&maps.half[0][more ? i : 0], 0, more ? (int)tr.n_in[i + 1] : 0,
                           n_next < kHalf ? n_next : kHalf};
    const float* __restrict__ b = tr.b[i];
    const int64_t brs = tr.b_rs[i];
    const float* __restrict__ wp = i == skip ? tr.wp : nullptr;
    product(act, ld, ops, N > kHalf ? 2 : 1, more ? &next : nullptr, ring,
            [&](int l, int o, float acc) {
              float z = acc + __ldg(b + rows[l] * brs + o);
              if (wp != nullptr) {
                z = fmaf(__ldg(wp + o * 3), xs[l], z);
                z = fmaf(__ldg(wp + o * 3 + 1), xs[kLanes + l], z);
                z = fmaf(__ldg(wp + o * 3 + 2), xs[2 * kLanes + l], z);
              }
              act[l * ld + o] = softplus(z, beta);
            });
    zero_pad(act, ld, N);
    __syncthreads();
  }
  {
    // the head's first 3 outputs: warp w owns rows 4w .. 4w + 3, its lanes
    // stride over the inputs, each sum closes with a shuffle tree
    constexpr int R = kLanes / kWarps;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int K = (int)tr.n_in[L - 1];
    const int nh = (int)tr.n_out[L - 1];
    const float* __restrict__ W = tr.w[L - 1];
    float acc[R][3];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.f;
    for (int o = lane; o < K; o += 32) {
      const float w0 = __ldg(W + o * nh), w1 = __ldg(W + o * nh + 1),
                  w2 = __ldg(W + o * nh + 2);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = act[(warp * R + r) * ld + o];
        acc[r][0] = fmaf(v, w0, acc[r][0]);
        acc[r][1] = fmaf(v, w1, acc[r][1]);
        acc[r][2] = fmaf(v, w2, acc[r][2]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float s = warp_sum(acc[r][c]);
        if (lane == 0) head[c * kLanes + warp * R + r] = s + __ldg(tr.b[L - 1] + c);
      }
  }
  __syncthreads();
}

__device__ __forceinline__ void load(const float* S, int f, int n, float* v) {
  for (int c = 0; c < n; ++c) v[c] = S[(f + c) * kLanes + threadIdx.x];
}

__device__ __forceinline__ void store(float* S, int f, int n, const float* v) {
  for (int c = 0; c < n; ++c) S[(f + c) * kLanes + threadIdx.x] = v[c];
}

// Shared memory: the activation tile [32][ld], the lane state [kFields][32],
// head [4][32], rows [32], then, 1 KB aligned, the ring (kStages stages of
// `stage` floats) and its full and empty mbarriers.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
broyden_search_kernel(nphm::Trunk tr, const __grid_constant__ Maps maps,
                      const float* __restrict__ obs, const float* __restrict__ x_init,
                      const float* __restrict__ j_init, float* __restrict__ xb_out,
                      float* __restrict__ bn_out, float* __restrict__ j_out,
                      float* __restrict__ act_out, int* __restrict__ iters_out,
                      int64_t group_pad, int64_t group_real, int niter, float cvg,
                      float dvg, float eps, int ld, int stage) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);
  float* S = act + kLanes * ld;
  float* head = S + kFields * kLanes;
  int* rows = reinterpret_cast<int*>(head + 4 * kLanes);
  __shared__ int any_active;
  tc::Ring ring;
  {
    float* base = reinterpret_cast<float*>(rows + kLanes);
    ring.buf = base + ((1024u - (tc::smem_u32(base) & 1023u)) & 1023u) / sizeof(float);
    ring.stage = stage;
    ring.full = reinterpret_cast<uint64_t*>(ring.buf + kStages * stage);
    ring.empty = ring.full + kStages;
    ring.slices = ring.issued = 0;
  }

  const int t = threadIdx.x;
  const int64_t p = (int64_t)blockIdx.x * kLanes + t;
  const bool lane_owner = t < kLanes;
  const int64_t grp = p / group_pad, q = p - grp * group_pad;
  const bool inb = lane_owner && q < group_real;
  if (lane_owner) {
    // compact index of the lane's input: a padding lane repeats its
    // group's last real lane
    const int64_t pc = grp * group_real + (q < group_real ? q : group_real - 1);
    for (int c = 0; c < 3; ++c) {
      S[(kO + c) * kLanes + t] = obs[pc * 3 + c];
      S[(kX + c) * kLanes + t] = x_init[pc * 3 + c];
    }
    for (int c = 0; c < 9; ++c) S[(kJ + c) * kLanes + t] = j_init[pc * 9 + c];
    rows[t] = (int)(pc / tr.row_len);
  }
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&ring.full[s], 1);
      tc::mbar_init(&ring.empty[s], kWarps);
    }
    tc::mbar_fence_init();
  }
  __syncthreads();

  const float* xs = S + kX * kLanes;
  trunk_eval(tr, maps, ring, act, ld, xs, rows, head);
  bool act_lane = false;
  if (lane_owner) {
    float o[3], x[3], jm[9], gx[3], jg[3], upd[3];
    load(S, kO, 3, o);
    load(S, kX, 3, x);
    load(S, kJ, 9, jm);
    for (int c = 0; c < 3; ++c) gx[c] = (x[c] + head[c * kLanes + t]) - o[c];
    matvec3(jm, gx, jg);
    for (int c = 0; c < 3; ++c) upd[c] = -jg[c];
    store(S, kGx, 3, gx);
    store(S, kUpd, 3, upd);
    store(S, kXb, 3, x);
    S[kBn * kLanes + t] = sqrtf(gx[0] * gx[0] + gx[1] * gx[1] + gx[2] * gx[2]);
    act_lane = inb;
  }
  if (t < 32) {
    const int any = __any_sync(0xffffffffu, act_lane);
    if (t == 0) any_active = any;
  }
  __syncthreads();

  int it = 0;
  while (it < niter && any_active) {
    if (lane_owner) {
      float x[3], upd[3], dx[3];
      load(S, kX, 3, x);
      load(S, kUpd, 3, upd);
      for (int c = 0; c < 3; ++c) {
        dx[c] = act_lane ? upd[c] : 0.f;
        x[c] = x[c] + dx[c];
      }
      store(S, kX, 3, x);
      store(S, kDx, 3, dx);
    }
    __syncthreads();
    trunk_eval(tr, maps, ring, act, ld, xs, rows, head);
    if (lane_owner) {
      float o[3], x[3], gx[3], dx[3], jm[9], xb[3];
      load(S, kO, 3, o);
      load(S, kX, 3, x);
      load(S, kGx, 3, gx);
      load(S, kDx, 3, dx);
      load(S, kJ, 9, jm);
      load(S, kXb, 3, xb);
      const float bn = S[kBn * kLanes + t];
      float dg[3], g2[3];
      for (int c = 0; c < 3; ++c) {
        const float gn = (x[c] + head[c * kLanes + t]) - o[c];
        dg[c] = act_lane ? gn - gx[c] : 0.f;
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
      if (act_lane)
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j) jm[3 * i + j] += u[i] * vt[j];
      float jg[3], upd[3];
      matvec3(jm, g2, jg);
      for (int c = 0; c < 3; ++c) upd[c] = -jg[c];
      store(S, kGx, 3, g2);
      store(S, kUpd, 3, upd);
      store(S, kJ, 9, jm);
      store(S, kXb, 3, xb);
      S[kBn * kLanes + t] = bn2;
      act_lane = act2;
    }
    ++it;
    if (t < 32) {
      const int any = __any_sync(0xffffffffu, act_lane);
      if (t == 0) any_active = any;
    }
    __syncthreads();
  }
  if (lane_owner) {
    for (int c = 0; c < 3; ++c) xb_out[p * 3 + c] = S[(kXb + c) * kLanes + t];
    for (int c = 0; c < 9; ++c) j_out[p * 9 + c] = S[(kJ + c) * kLanes + t];
    bn_out[p] = S[kBn * kLanes + t];
    act_out[p] = act_lane ? 1.f : 0.f;
  }
  if (t == 0) iters_out[blockIdx.x] = it;
}

// Size the launch over trunk *tr and encode its weights' tensor maps: the
// activation tile's row stride, the floats of one ring stage and the bytes
// of shared memory.  Returns 0, cudaErrorInvalidValue for a layer wider
// than kMaxWidth (the NPM family's 8x1024 offsets trunk), or make_map's
// code for a refused descriptor.
int search_setup(const nphm::Trunk* tr, Maps* maps, int* ld, int* stage, int* smem) {
  const int L = (int)tr->n_layers;
  int hmax = 8, nmax = 8;
  for (int i = 0; i < L - 1; ++i) {
    hmax = tr->n_out[i] > hmax ? (int)tr->n_out[i] : hmax;
    if (i > 0) nmax = tr->n_out[i] > nmax ? (int)tr->n_out[i] : nmax;
  }
  if (hmax > kMaxWidth || tr->n_out[L - 1] < 3) return (int)cudaErrorInvalidValue;
  *ld = tc::act_ld(hmax);
  *stage = tc::stage_floats<kKS>(nmax < kHalf ? nmax : kHalf);
  *smem = (int)sizeof(float) * (kLanes * *ld + (kFields + 5) * kLanes + kStages * *stage) +
          1024 + 16 * kStages;
  for (int i = 1; i < L - 1; ++i) {
    const int N = (int)tr->n_out[i];
    const int ldwt = (int)tr->ldwt[i];
    int rc = tc::make_map(&maps->half[0][i - 1], tr->wt[i], ldwt, N, ldwt, kKS,
                          ((N < kHalf ? N : kHalf) + 7) & ~7);
    if (rc == 0 && N > kHalf)
      rc = tc::make_map(&maps->half[1][i - 1], tr->wt[i], ldwt, N, ldwt, kKS,
                        (N - kHalf + 7) & ~7);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" int nphm_search_lanes_per_block() { return kLanes; }

// obs, x_init: [n_real][3]; j_init: [n_real][9], n_real = groups *
// group_real lanes, compact; the launch covers n_pad = groups * group_pad
// lanes (group_pad a multiple of 32, lanes group_real .. group_pad - 1 of a
// group are padding); outputs xb [n_pad][3], bn [n_pad], j [n_pad][9],
// act [n_pad], iters [n_pad / 32].  Hidden layers read wt [n_out][ldwt]
// (ldwt a multiple of 8, zero columns past n_in).
extern "C" int nphm_broyden_search(const nphm::Trunk* tr, const float* obs,
                                   const float* x_init, const float* j_init,
                                   float* xb, float* bn, float* j_out,
                                   float* act, int* iters, int64_t n_pad,
                                   int64_t group_pad, int64_t group_real, int niter,
                                   float cvg, float dvg, float eps, void* stream) {
  Maps maps = {};
  int ld = 0, stage = 0, smem = 0;
  const int rc = search_setup(tr, &maps, &ld, &stage, &smem);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      broyden_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    // clear the error so the next launch's check does not report it again
    cudaGetLastError();
    return (int)err;
  }
  const int64_t blocks = n_pad / kLanes;
  broyden_search_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      *tr, maps, obs, x_init, j_init, xb, bn, j_out, act, iters, group_pad, group_real, niter,
      cvg, dvg, eps, ld, stage);
  return (int)cudaGetLastError();
}
