// Tensor-core building blocks (sm_90a) for fp32-accurate products: 3xTF32.
//
// A TF32 product keeps 10 explicit mantissa bits of each operand, ~1e-3
// relative over a long sum.  Splitting each operand into a TF32 "big" part
// and the TF32 rounding of its remainder ("small"), and summing
// big*big + big*small + small*big in fp32, keeps ~21 bits; the dropped
// small*small term is ~2^-22 of the product.  Rounding is cvt.rna (nearest,
// ties away from zero), the same rule as ops/tf32.py::tf32_round.
//
// Two routes to the tensor cores live here:
// - warp-level mma.sync m16n8k8 .tf32 with operands split in registers
//   (split_mma), and mm64, a block-level product over a 64-row tile held in
//   shared memory with the K-major B operand staged by TMA through a
//   three-stage swizzled ring, fragments loaded with ldmatrix (K1, K3-K5,
//   field_tile.cuh, and K6's two passes; K6's lane contraction streams
//   both operands through a ring of its own, train_fields.cu; K2 runs a
//   32-row product in place on the same parts, broyden_search.cu);
// - warpgroup-level wgmma m64n128k8 .tf32 reading 128-byte-swizzled K-major
//   operands that TMA (cp.async.bulk.tensor) stages, signalled through
//   mbarriers (K7).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nphm {
namespace tc {

// ---------------------------------------------------------------------------
// TF32 split
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

__device__ __forceinline__ void split_tf32(float x, float& big, float& small) {
  uint32_t b, s;
  split_tf32(x, b, s);
  big = __uint_as_float(b);
  small = __uint_as_float(s);
}

// The split for operands fed straight to mma.sync, in three instructions
// (cvt.rna with its NaN/Inf guards is nine): big is x rounded to nearest,
// ties away, by adding half a TF32 unit and clearing the 13 low bits; small
// is the exact remainder x - big, passed whole, and the MMA reads it
// truncated to TF32.  Error per product: |small| <= 2^-11 |x| loses at most
// 2^-21 |x| to that truncation, plus the dropped small*small (2^-22).
__device__ __forceinline__ void split_mma(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Softplus(beta) and its derivative through the activation h = softplus(z)
// (1 - e^{-beta h}) with the fast exp/log intrinsics: within ~1e-7 of
// mlp_tile.cuh's softplus_beta and of 1 - expf(-beta h) (absolute, over the
// outputs of a layer), far inside the kernels' 1e-4 gates.
__device__ __forceinline__ float softplus_fast(float x, float beta, float inv_beta) {
  const float bx = beta * x;
  if (bx > 20.f) return x;
  return (fmaxf(bx, 0.f) + __logf(1.f + __expf(-fabsf(bx)))) * inv_beta;
}

__device__ __forceinline__ float softplus_grad_fast(float h, float beta) {
  return 1.f - __expf(-beta * h);
}

// ---------------------------------------------------------------------------
// Shared-memory addresses, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of the given parity has completed.  A wait of more
// than ~2^35 cycles (~20 s) traps: a lost arrival becomes a launch error
// rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// One box of a 2-D tensor map into shared memory; completion is counted in
// bytes on `bar`.  c0 is the inner (contiguous) coordinate.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma: m64n128k8 .tf32, both operands K-major in 128-byte-swizzled shared
// memory (rows of 32 floats, 8-row groups 1024 bytes apart, tile 1024-byte
// aligned).  A step of 8 along K advances the start address by 32 bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* smem) {
  uint64_t d = (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4);  // start address
  d |= (uint64_t)1 << 16;             // leading byte offset (unused: K-major, swizzled)
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset: next 8-row group
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the async MMA.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x128] += A[64x8] * B[8x128]; accumulator layout: warp w of the group
// owns rows 16w + lane/4 (+8), register 4j + {0,1,2,3} holds columns
// 8j + 2*(lane%4) + {0,1} of rows {r, r, r+8, r+8}.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k8 .tf32 and the block-level 64-row product
// ---------------------------------------------------------------------------

// d += a * b on the tensor cores.  Not volatile: the compiler may interleave
// independent products, which hides the MMA latency of dependent chains.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kRows = 64;                  // rows (points) of an mm64 tile
constexpr int kMmaWarps = 16;              // warps of an mm64 block
constexpr int kGroups = 8;                 // n8-tile groups (two warps each)
constexpr int kMT = 2;                     // m16 tiles per warp (half the rows)
constexpr int kRingStages = 3;             // TMA ring depth: slices issued 2 ahead
constexpr int kNT = 4;                     // n8 tiles per warp
constexpr int kMaxN = kGroups * kNT * 8;   // widest product: 256 outputs

// Row stride (floats) of a [64][w] activation tile in shared memory: w
// rounded to the MMA's K step of 8, plus 4, so that the eight 16-byte rows
// an ldmatrix phase reads fall in distinct banks.
__host__ __device__ __forceinline__ int act_ld(int w) { return ((w + 7) & ~7) + 4; }

// Floats of one ring stage of mm64<KS> for products up to n outputs: the
// [round8(n)][KS] slice TMA writes, rounded up to 1 KB so that every stage
// starts on the swizzle pattern's period.
template <int KS>
__host__ __device__ __forceinline__ int stage_floats(int n) {
  return (((n + 7) & ~7) * KS + 255) & ~255;
}

// Float offset of the 16-byte chunk holding (n, c..c+3), c a multiple of 4,
// in a [rows][KS] slice that TMA wrote with the KS * 4-byte swizzle: the
// chunk index is XORed with address bits 7.. (128B: three bits, 64B: two,
// 32B: one), so the eight rows an ldmatrix phase reads fall in distinct
// banks.
template <int KS>
__device__ __forceinline__ int swz(int n, int c) {
  if (KS == 32) return n * 32 + ((((c >> 2) ^ n) & 7) << 2);
  if (KS == 16) return n * 16 + ((((c >> 2) ^ (n >> 1)) & 3) << 2);
  return n * 8 + ((((c >> 2) ^ (n >> 2)) & 1) << 2);
}

template <int KS>
__host__ __device__ __forceinline__ int n_slices(int K) {
  return (((K + 7) & ~7) + KS - 1) / KS;
}

// Four 8x4 tiles of 32-bit values (ldmatrix's 8x8 b16 matrices): thread
// lane receives element (lane / 4, lane % 4) of tile q in r[q]; lanes 8q..
// 8q+7 give the addresses of tile q's eight 16-byte rows.  That is the
// m16n8k8 .tf32 fragment layout of A (tiles: rows 0-7 / 8-15 x k 0-3 / 4-7)
// and of B (n rows x k 0-3 / 4-7).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void split_mma(uint32_t x, uint32_t& big, uint32_t& small) {
  split_mma(__uint_as_float(x), big, small);
}

// One product's B operand for mm64: K-major rows row0 .. row0 + N - 1 of
// the tensor behind `map` (boxes of KS columns x round8(N) rows,
// tc::make_map), K deep.
struct Operand {
  const CUtensorMap* map;
  int row0;
  int K;
  int N;
};

// The TMA ring mm64 stages B through: kRingStages stages of `stage` floats
// (1 KB aligned), `full` barriers (one arrival: the producer's, plus the
// bytes), `empty` barriers (one arrival per warp).  `slices` counts the K
// slices consumed so far and `issued` (meaningful in the producer thread)
// the slices issued; both persist across products, so the producer runs
// into the next product's first slices while the current one finishes.
struct Ring {
  float* buf;
  int stage;
  uint64_t* full;
  uint64_t* empty;
  uint32_t slices;
  uint32_t issued;
};

// The thread that issues the TMA copies: lane 0 of the last warp, whose n8
// tiles are the fewest.
constexpr int kProducer = 32 * (kMmaWarps - 1);

// Producer: issue ring slices up to global index `target` (exclusive) that
// belong to `cur` (whose first slice is ring.slices) or to `next`; a stage
// is reused once every warp has released its previous slice.  S: the
// ring's depth (K2 runs a deeper ring of narrower stages).
template <int KS, int S = kRingStages>
__device__ __forceinline__ void ring_issue(Ring& ring, const Operand& cur,
                                           const Operand* next, uint32_t target) {
  const uint32_t n_cur = (uint32_t)n_slices<KS>(cur.K);
  while (ring.issued < target) {
    const uint32_t g = ring.issued;
    const bool in_cur = g < ring.slices + n_cur;
    if (!in_cur &&
        (next == nullptr || g - ring.slices - n_cur >= (uint32_t)n_slices<KS>(next->K)))
      return;
    const Operand& b = in_cur ? cur : *next;
    const int s = (int)(in_cur ? g - ring.slices : g - ring.slices - n_cur);
    const int st = (int)(g % S);
    if (g >= (uint32_t)S) mbar_wait(&ring.empty[st], (g / S - 1) & 1);
    mbar_expect_tx(&ring.full[st], (uint32_t)(((b.N + 7) & ~7) * KS * 4));
    tma_load_2d(ring.buf + st * ring.stage, b.map, &ring.full[st], s * KS, b.row0);
    ++ring.issued;
  }
}

// One warp's share of mm64: its NJ n8 tiles (grp + 8j, j < NJ) over the
// m16 tiles m_base / 16 + {0, 1}; NJ is uniform in the warp, so the MMAs
// run without per-tile predicates.  NJ = 0 still takes part in the ring.
template <int KS, int NJ, class Pre, class Epi>
__device__ __forceinline__ void mm64_warp(const float* A, int lda, const Operand& b,
                                          const Operand* next, Ring& ring, Pre& pre,
                                          Epi& epi) {
  const int warp = threadIdx.x >> 5;
  const int grp = warp >> 1;          // n8 tiles grp + 8j
  const int m_base = (warp & 1) * 32;  // rows m_base .. m_base + 31
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int N = b.N;
  const int K8 = (b.K + 7) & ~7;
  const int n_sl = n_slices<KS>(b.K);
  // ldmatrix row addresses: A rows m_base + mt*16 + (lane & 15), k half
  // (lane >> 4); B rows nt*8 + (lane & 7), k chunk (lane >> 3)
  const float* a_lane = A + (m_base + (lane & 15)) * lda + ((lane >> 4) << 2);
  const int b_row = lane & 7;
  const int b_chunk = (lane >> 3) << 2;

  float acc[NJ > 0 ? NJ : 1][kMT][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;

  // B fragments load KH columns of a slice at a time (one ldmatrix x4 or x2)
  constexpr int KH = KS < 16 ? KS : 16;
  for (int s = 0; s < n_sl; ++s) {
    const uint32_t g = ring.slices + s;
    if (threadIdx.x == kProducer) ring_issue<KS>(ring, b, next, g + kRingStages);
    mbar_wait(&ring.full[g % kRingStages], (g / kRingStages) & 1);
    const float* buf = ring.buf + (g % kRingStages) * ring.stage;
#pragma unroll
    for (int h = 0; h < KS / KH; ++h) {
      const int k0 = s * KS + h * KH;
      // B fragments of these KH columns: bf[j][2 * (kk / 8) + {0, 1}]
      uint32_t bf[NJ > 0 ? NJ : 1][KH / 4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* bp = buf + swz<KS>((grp + kGroups * j) * 8 + b_row, h * KH + b_chunk);
        if (KH == 16) {
          ldsm_x4(*reinterpret_cast<uint32_t(*)[4]>(&bf[j][0]), bp);
        } else {
          ldsm_x2(*reinterpret_cast<uint32_t(*)[2]>(&bf[j][0]), bp);
        }
      }
      if constexpr (NJ > 0) {
#pragma unroll
        for (int kk = 0; kk < KH; kk += 8) {
          if (k0 + kk < K8) {
            uint32_t ab[kMT][4], as[kMT][4], bb[NJ > 0 ? NJ : 1][2], bs[NJ > 0 ? NJ : 1][2];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              uint32_t r[4];
              ldsm_x4(r, a_lane + mt * 16 * lda + k0 + kk);
#pragma unroll
              for (int e = 0; e < 4; ++e) split_mma(r[e], ab[mt][e], as[mt][e]);
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              split_mma(bf[j][kk / 4], bb[j][0], bs[j][0]);
              split_mma(bf[j][kk / 4 + 1], bb[j][1], bs[j][1]);
            }
            // small*big, big*small, then big*big: each pass's MMAs independent
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[j][mt], as[mt], bb[j]);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[j][mt], ab[mt], bs[j]);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[j][mt], ab[mt], bb[j]);
          }
        }
      }
    }
    // release the stage once the slice's loads have long completed
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[g % kRingStages]);
  }

  // the epilogue: gather, then compute and store (fragment element e of
  // tile (j, mt) is row t + 8 * (e >> 1), column n + (e & 1))
  using Aux = decltype(pre(0, 0));
  Aux aux[NJ > 0 ? NJ : 1][kMT][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (grp + kGroups * j) * 8 + 2 * tig + (e & 1);
        const int t = m_base + mt * 16 + gid + 8 * (e >> 1);
        aux[j][mt][e] = n < N ? pre(t, n) : Aux{};
      }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (grp + kGroups * j) * 8 + 2 * tig + (e & 1);
        const int t = m_base + mt * 16 + gid + 8 * (e >> 1);
        if (n < N) epi(t, n, acc[j][mt][e], aux[j][mt][e]);
      }
}

// For t < 64, n < N: epi(t, n, sum_k A[t * lda + k] * B[n][k], pre(t, n)),
// with 3xTF32 mma.sync.  pre runs for every output before any epi, so its
// loads are not held behind epi's stores; it may return any value type
// (K6's reverse pass gathers two floats).  A: [64][lda] in shared memory,
// 16-byte aligned, columns [K, K rounded up to 8) zero, lda = act_ld(K or
// wider).  B (`b`): rows past N in a box are multiplied but never stored,
// columns past the map's extent read as zeros.  The K slices stream through
// `ring` by TMA, the producer thread issuing two ahead and on into `next` (the
// block's following product, or null); warps release each slice on its
// empty barrier, so they drift apart by up to the ring's depth instead of
// meeting at a barrier per slice.  Fragments load with ldmatrix and split
// in registers; the three TF32 products run as three passes over all of a
// warp's tiles, so no MMA waits on the one before it.  Warp w owns m16
// tiles 2 (w & 1) + {0, 1} of the n8 tiles (w >> 1) + 8j: each staged B
// fragment serves 32 points of a warp, 16 warps keep four on each
// scheduler.  Requires N <= kMaxN and blockDim.x == 32 * kMmaWarps; every
// thread must call it, and the caller synchronises the block before it
// writes what A holds or reads what epi wrote.
template <int KS, class Pre, class Epi>
__device__ __forceinline__ void mm64(const float* A, int lda, const Operand& b,
                                     const Operand* next, Ring& ring, Pre pre, Epi epi) {
  const int grp = threadIdx.x >> 6;
  const int NT = (b.N + 7) >> 3;
  const int nj = NT > grp ? (NT - grp + kGroups - 1) / kGroups : 0;
  switch (nj) {
    case 0: mm64_warp<KS, 0>(A, lda, b, next, ring, pre, epi); break;
    case 1: mm64_warp<KS, 1>(A, lda, b, next, ring, pre, epi); break;
    case 2: mm64_warp<KS, 2>(A, lda, b, next, ring, pre, epi); break;
    case 3: mm64_warp<KS, 3>(A, lda, b, next, ring, pre, epi); break;
    default: mm64_warp<KS, kNT>(A, lda, b, next, ring, pre, epi); break;
  }
  ring.slices += n_slices<KS>(b.K);
}

// dst[o] = sum over the 64 rows of d[t * ld + o], o < H: one warp per
// column, a fixed-order shuffle tree (deterministic, no atomics).
__device__ __forceinline__ void colsum64(const float* d, int ld, int H,
                                         float* __restrict__ dst) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int o = warp; o < H; o += blockDim.x >> 5) {
    float s = d[lane * ld + o] + d[(lane + 32) * ld + o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dst[o] = s;
  }
}

// ---------------------------------------------------------------------------
// Host: TMA descriptors
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library needs no -lcuda.
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows][ld] fp32 matrix read in boxes of box_cols (32, 16 or 8) x
// box_rows, swizzled across the box's box_cols * 4-byte rows (128, 64 or 32
// bytes); columns >= cols and rows >= rows read as zeros.  Returns 0, a
// runtime error code, or 10000 + the driver's code for a refused
// descriptor.  The encoder needs a current context, which a thread that has
// not touched the device yet (autograd's backward thread) lacks:
// cudaSetDevice makes the primary one current.
inline int make_map(CUtensorMap* map, const float* ptr, int cols, int64_t rows, int ld,
                    int box_cols, int box_rows) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 32   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)ptr, dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

}  // namespace tc
}  // namespace nphm
