// K3 and K4: the fit-specialised NPHM field, forward and backward.
//
// Replace nphm_tpu/ops/pallas_train.py::_fit_fwd_impl (body
// _make_fit_fwd_kernel) and ::_fit_bwd_impl (body _make_fit_bwd_kernel), the
// two halves of the custom VJP _member_f behind apply_nphm_fit_pallas.
//
// K3: one block per (member, 64-point tile) computes the member's raw SDF F
// (head without its bias) at member-local coordinates, with the latent
// folded into per-(member, row) biases.  A (member, cull tile) pair outside
// the cull radius writes 0.
//
// K4: from F's cotangent dF, one block per (member, 64-point tile)
// recomputes the forward (keeping every hidden activation in shared memory)
// and runs one reverse sweep with the transposed weights: d(coords) is
// written directly, and the per-row bias cotangents of layer 0 and of the
// skip layer go to per-block partials [A][n_blocks][H], which a second pass
// (mlp_tile.cuh's sum_block_partials, shared with K6) sums over each row's
// blocks in a fixed order (deterministic, unlike atomics).  Weight
// cotangents are not computed: the decoder is frozen during a fit.
//
// Both are field_tile.cuh's body on the tensor cores (modes kFitFwd and
// kFitBwd: 3xTF32 mma.sync over 16 warps, weights staged by TMA), each
// instantiated for three routes (the entry points take the route code the
// host chose, ops/fit_fields.py ROUTES): tc::kF32, kTF32 (operands rounded
// per fragment for one TF32 pass) and kBF16Mma (bf16 weights rounded once
// per call, one m16n8k16 .bf16 MMA a product step, in K4's reverse sweep
// too); K4 launches over K3's trunk at every route.  Bounds on this card,
// tensor-core operations run as 3xTF32 at 495 TFLOP/s of TF32 (one pass at
// the lower precisions, at the bf16 rate for bf16): K3 ~81k multiply-adds
// per point and member, K4 ~161k (the recomputed forward and the reverse
// sweep).
//
// What bounds them: at F32 both run ~5-6x that bound.  The MMAs are about
// a third of a K4 block (a copy without them ran in 0.64 of the time); the
// rest is the passes outside the products and the weight slices' staging,
// one 64-point tile a block reusing each slice 64 times.  The fit modes at
// F32 therefore take the bf16 route's cuts outside the products (kCuts in
// field_tile.cuh: the bias loaded once a block, the first slices issued
// before layer 0, and in K4 softplus' taken in the reverse gather and a
// thread per bias column): 0.90x (K3) and 0.91x (K4) of mma.sync without
// them at the batched fit's shape (PERF.md).
//
// mma.sync rather than wgmma: wgmma takes its .tf32 A operand from shared
// memory (both halves of 184 KB of activations: no room) or from registers,
// and its N is an instruction constant.  A wgmma m64nNk8 .tf32 product with
// A split in registers and B as TF32 halves split once on the host, staged
// by TMA (the four warpgroups dividing N's n8 tiles), was built and
// measured: its MMAs cost little, but the ring then carries both halves of
// every slice, twice the bytes, and one producer thread's copies paced the
// block.  K4, whose activations leave room only for three 8-column stages
// of both halves, ran 1.2-1.5x slower in every variant; K3 with the same
// cuts ran 0.99x mma.sync's time at the batched shape but 1.07x at the
// serial fit's 5 x 1024 and slowed the batched fit, so both stay on
// mma.sync, which tiles any width in 8-wide steps and splits both operands
// where they are loaded.  At bf16 the same holds (kBF16Mma): the
// activations and K4's cotangents stay fp32 for the bias and softplus
// passes, the head and the bias and point sums, so the A operand packs from
// them in registers, and the weights, rounded once on the host, halve the
// ring's bytes a K step.
//
// First designs: 32-point blocks of 8 warps, an fp32 register-tiled product
// reading weights from L2 with __ldg; K4 with serial bias and d(coords)
// loops.  At M = 5x1024 (NVIDIA H100 80GB HBM3, 700.00 W): K3 2.89 ms, K4
// 5.83 ms.
#include "field_tile.cuh"

namespace {

namespace field = nphm::field;
namespace tc = nphm::tc;

template <int KS, int P>
__global__ void __launch_bounds__(field::kThreads, 1)
fit_fwd_kernel(nphm::Trunk tr, const __grid_constant__ field::Maps maps,
               const float* __restrict__ coords, const int* __restrict__ active,
               float* __restrict__ F, int64_t M, int n_members, int cull_tile,
               int act_floats, int stage) {
  field::tile<KS, field::kFitFwd, P>(tr, maps, coords, nullptr, active, F, nullptr,
                                     nullptr, nullptr, M, n_members, cull_tile, act_floats,
                                     stage);
}

template <int KS, int P>
__global__ void __launch_bounds__(field::kThreads, 1)
fit_bwd_kernel(nphm::Trunk tr, const __grid_constant__ field::Maps maps,
               const float* __restrict__ coords, const float* __restrict__ dF,
               const int* __restrict__ active, float* __restrict__ dcoords,
               float* __restrict__ part0, float* __restrict__ part_s, int64_t M,
               int n_members, int cull_tile, int act_floats, int stage) {
  field::tile<KS, field::kFitBwd, P>(tr, maps, coords, dF, active, nullptr, dcoords,
                                     part0, part_s, M, n_members, cull_tile, act_floats,
                                     stage);
}

}  // namespace

extern "C" int nphm_fit_lanes_per_block() { return field::kRows; }

#ifdef NPHM_PHASE_CLOCKS
// out[tc::kPhaseSlots] = this file's phase clocks (tc::PhaseClock), summed
// over the blocks since the last reset; zeroed after the read when `reset`.
extern "C" int nphm_fit_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tc::phase_cycles, sizeof(tc::phase_cycles));
  if (err == cudaSuccess && reset) {
    const unsigned long long zeros[tc::kPhaseSlots] = {};
    err = cudaMemcpyToSymbol(tc::phase_cycles, zeros, sizeof(zeros));
  }
  return (int)err;
}
#endif

// coords: [A][3][M]; active: [M / cull_tile][A]; F: [A][M].  M and
// cull_tile are multiples of 64; route: tc::kF32, kTF32 or kBF16Mma (the
// hidden weights of *tr then bf16, field::setup).
extern "C" int nphm_fit_fwd(const nphm::Trunk* tr, const float* coords,
                            const int* active, float* F, int64_t M,
                            int n_members, int cull_tile, int route, void* stream) {
  if (M % field::kRows != 0 || cull_tile % field::kRows != 0 ||
      tr->row_len % field::kRows != 0)
    return (int)cudaErrorInvalidValue;
  field::Maps maps = {};
  field::Launch ln;
  const int rc = field::setup(tr, n_members, false, &maps, &ln, 0, 8 * field::kRows, 16, route);
  if (rc != 0) return rc;
  return field::with_route<tc::kF32, tc::kTF32, tc::kBF16Mma>(route, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return field::launch(fit_fwd_kernel<16, P>, fit_fwd_kernel<8, P>, ln, n_members, M,
                         stream, *tr, maps, coords, active, F, M, n_members, cull_tile,
                         ln.act_floats, ln.stage);
  });
}

// occupancy(out[4]) of K3 (`backward` 0) or K4 (1) at `route` as they
// launch over trunk *tr (field::occupancy): registers, local bytes,
// shared memory, blocks per SM.
extern "C" int nphm_fit_occupancy(const nphm::Trunk* tr, int n_members, int backward,
                                  int route, int* out) {
  field::Maps maps = {};
  field::Launch ln;
  const int rc = field::setup(tr, n_members, backward != 0, &maps, &ln, 0, 8 * field::kRows,
                              16, route);
  if (rc != 0) return rc;
  return field::with_route<tc::kF32, tc::kTF32, tc::kBF16Mma>(route, [&](auto p) {
    constexpr int P = decltype(p)::value;
    if (backward)
      return field::occupancy(ln.ks == 16 ? fit_bwd_kernel<16, P> : fit_bwd_kernel<8, P>,
                              field::kThreads, ln.smem, out);
    return field::occupancy(ln.ks == 16 ? fit_fwd_kernel<16, P> : fit_fwd_kernel<8, P>,
                            field::kThreads, ln.smem, out);
  });
}

// + dF [A][M] -> dcoords [A][3][M], d_bias0 [A][n_rows][H0], d_bias_s
// [A][n_rows][HS]; part0/part_s: scratch [A][M / 64][H].  The weights are
// staged in K slices of 16 where that ring fits in shared memory beside the
// activations (the NPHM ensemble: ~222 KB), else of 8.
extern "C" int nphm_fit_bwd(const nphm::Trunk* tr, const float* coords, const float* dF,
                            const int* active, float* dcoords, float* part0,
                            float* part_s, float* d_bias0, float* d_bias_s, int64_t M,
                            int n_members, int n_rows, int cull_tile, int route,
                            void* stream) {
  if (M % field::kRows != 0 || cull_tile % field::kRows != 0 ||
      tr->row_len % field::kRows != 0)
    return (int)cudaErrorInvalidValue;
  field::Maps maps = {};
  field::Launch ln;
  int rc = field::setup(tr, n_members, true, &maps, &ln, 0, 8 * field::kRows, 16, route);
  if (rc != 0) return rc;
  rc = field::with_route<tc::kF32, tc::kTF32, tc::kBF16Mma>(route, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return field::launch(fit_bwd_kernel<16, P>, fit_bwd_kernel<8, P>, ln, n_members, M,
                         stream, *tr, maps, coords, dF, active, dcoords, part0, part_s, M,
                         n_members, cull_tile, ln.act_floats, ln.stage);
  });
  if (rc != 0) return rc;
  // each row's bias cotangent: that row's block partials in a fixed order
  const int64_t n_blk = M / field::kRows;
  const int skip = (int)tr->skip;
  const int H0 = (int)tr->n_out[0];
  const int HS = (int)tr->n_out[skip];
  int64_t total = (int64_t)n_members * n_rows * H0;
  nphm::sum_block_partials<<<(unsigned)((total + 255) / 256), 256, 0,
                             (cudaStream_t)stream>>>(
      part0, d_bias0, n_members, n_blk, H0, 0, H0, n_rows, (int64_t)n_rows * H0);
  total = (int64_t)n_members * n_rows * HS;
  nphm::sum_block_partials<<<(unsigned)((total + 255) / 256), 256, 0,
                             (cudaStream_t)stream>>>(
      part_s, d_bias_s, n_members, n_blk, HS, 0, HS, n_rows, (int64_t)n_rows * HS);
  return (int)cudaGetLastError();
}
