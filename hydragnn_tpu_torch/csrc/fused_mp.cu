// Fused message passing: gather, edge op, segment reduce in one kernel.
//
// Replaces the TPU kernel of hydragnn_tpu/ops/fused_mp.py,
// fused_message_reduce (_fused_impl, fused_mp.py:212-334; its pallas_call at
// :322), for four of its edge ops:
//
//   K3 "moments"    (_op_moments, :82-94; wrapper fused_gather_moments, :501-517)
//   K4 "copy"       (_op_copy, :67-69; fused_gather_sum, :463-472)
//   K5 "copy_count" (_op_copy_count, :72-74; fused_gather_mean, :475-486)
//   K6 "mul"        (_op_mul, :77-79; fused_gather_weighted_sum, :489-498)
//
// (The fifth op, "egnn", is K7 in fused_egnn.cu.) For every edge e and
// column d < D, with x = table[senders[e], d], or 0 when senders[e] is
// outside [0, N), and, when receivers[e] is inside [0, S), into row
// out[receivers[e]]:
//
//   K3: z = (x + ze[e, d]) * mask[e]  (ze may be absent);  z_out[e, d] = z
//       for every edge; row [sum z (D) | sum z^2 (D) | sum mask (1)], each
//       part 16-byte aligned within the row
//   K4: row [sum x * mask[e] (D)]
//   K5: row [sum x * mask[e] (D) | sum mask (1)]
//   K6: row [sum x * w[e, d] (D)]   (w comes masked)
//
// The count columns sum the mask: they count real edges, as the TPU ops do.
// Accumulation is f32. Atomics add in a run-dependent order; the tolerance
// against the plain versions is relative, about
// 1e-5 * (max |partial sum| + 1).
//
// What bounds them on the card: bytes. Per element they do one or two
// operations on 4 bytes read; the least time is the inputs (the node table
// once, the mask or w, both id arrays) read once and the output written
// once, over 3.35 TB/s. The gathered rows themselves (E * D * 4 bytes, 70.8
// MB at the main path's widest K4 call) come from the on-chip caches: the
// node table (5.9 MB) stays in the 50 MB L2. K3 also reads ze and writes
// z once, E * D * 4 bytes each, which set its least time.
//
// K3, K4, K5 and K6: one gather-reduce kernel laid out for this card
// (gather_reduce.cuh; K2 runs it too, on rows read in order). What held
// the first designs (one thread per (edge, column) element) back was not
// the bytes but the per-element work and the scalar global atomics: 17.7 M
// per call at K4's widest shape, 35.4 M at K3's (a sum and a square per
// element). A block stages a tile of consecutive edges' ids and mask in
// shared memory. A group of lanes then walks consecutive edges of the tile
// across a slab of 256 columns in 16-byte chunks, lanes apart, so a row's
// 1 KB comes in as contiguous pieces and one edge's ids, mask and run test
// serve 256 columns; two edges' rows are in flight per lane. A row gathered
// for the edge before is reused while the sender repeats, and the rows add
// in registers while the receiver repeats (K1's run reduction,
// csrc/segment.cu); at a change of receiver the run goes out with one
// atomic per chunk (16 bytes on the vector path). The id order only
// decides how often a row is reused or a run flushed: any order is right.
//
// K4 and K5: 128-edge tiles, 16 lanes x 4 chunks per slab, 8 edges per
// group. On the served layout (each graph's edges contiguous, half of them
// in runs of 6 senders, half in runs of 6 receivers) that skips 5 of 6
// gathers on one half and 5 of 6 atomics on the other. Two blocks share an
// SM (95 registers, no spills; held to three, the loop spills and runs
// slower). What bounds them is the gather of the rows from the caches. A
// shared-memory window of receivers ran slower on the card, as f32 sums
// (shared f32 atomics compile to compare-and-swap loops on sm_90) and as a
// counting sort (the sort cost more than the few atomics it saved).
//
// K3 (and K2): the moments keep two sums per chunk, z = (x (+ ze)) * mask
// and z^2, so a group is 32 lanes x 2 chunks (80 registers, no spills;
// with 16 x 4 the loop spilled). At a change of receiver a run goes out to
// both halves of the row, so here the atomics set the pace: knocking them
// out of the unsorted walk saved 32 of its 68 us at D = 256 on an NVIDIA
// H100 80GB HBM3 at 700 W, as do all times here (PERF.md). On
// wide rows (8 lanes or more) a block therefore takes 256 edges and sorts
// them by receiver first (a bitonic sort of (receiver, position) keys in
// shared memory): a receiver's scattered edges in the tile then make one
// run, which cut the call from 66 to 55 us; sender runs are lost, but the
// node table comes from L2. On narrow rows the sort costs more than it
// saves (D = 1: 9 us unsorted, 24 sorted), so they walk in tile order with
// 4 edges per group. z, E * D * 4 bytes (70.8 MB at D = 256, more than the
// L2 holds), goes out with evict-first stores, so that the node table
// stays in L2 (12 us faster than plain stores), and ze is read the same
// way. K3's count (like K5's) rides along as one more register, flushed by
// lane 0 of the slab-0 block.
//
// The output rows are padded (ldo) so that every part of a row starts 16
// bytes apart from the row's start: K5's [sum (D) | count] with ldo a
// multiple of 4, K3's [sum (D) | pad | sum of squares (D) | pad | count |
// pad] with the squares at sq_off and the count at cnt_off (the wrapper's
// layout, ops/segment_kernels.moments_layout). K5's C entry then divides
// the sums by the count in place. Without the float4 path (D % 4 != 0, or
// a pointer not 16-byte aligned) lanes own single floats. A bool mask is
// read as bytes. The C entries zero their own output on the caller's
// stream.
//
// K6 (SchNet's filtered sum): the same kernel, Op::kMul. Per edge a group
// streams the edge's own weight row w[e] (read once, evict-first, as K3's
// ze) beside the gathered row h[s] and sums the products in registers
// while the receiver repeats: 128-edge tiles, two chunks per lane, two
// edges in flight. No mask (w comes masked) and no count. At the served
// width (50 filters: 200-byte rows, 8-byte aligned but not 16) lanes own
// 8-byte chunks (float2, with sm_90's float2 atomicAdd), 16 lanes to an
// edge; D % 4 == 0 takes float4, other widths single floats. Its bound is
// bytes, mostly w: E * D * 4 from device memory (13.8 of the 16.7 MB at
// the served shape); the gathered rows come from L2. What held it back on
// the card was not the bytes but a call's fixed cost and the walk's
// instructions: at the served shape, of ~10 us, knocking out w's stream
// saved ~0.6 us, the atomics ~1.6, while zeroing the output and launching
// two kernels took ~3.7 before any edge was walked. So the output is
// zeroed by a small kernel, not a memset, and the gather kernel is
// launched as its programmatic dependent: it starts while the zeros are
// written, stages its ids, and waits for them (griddepcontrol.wait) only
// before the walk (2 us less than a memset and a plain launch). Sorting a
// tile by receiver, as K3 does, cost more than the atomics it saved; so
// did reusing a gathered row while the sender repeats. PERF.md has the
// variants.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

// ---- K3, K4, K5, K6 --------------------------------------------------

using hg::Chunk;
using hg::GatherArgs;
using hg::Op;

// K5's mean, in place: columns [0, D) of every row divided by the row's
// count at column D, at least 1 (a NaN count stays NaN, as torch.clamp).
template <typename T>
__global__ void mean_rows_kernel(float* __restrict__ out, int64_t S, int D, int ldo) {
  using C = Chunk<T>;
  const int chunks = D / C::kWidth;
  const int64_t n = S * chunks;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / chunks;
    float* p = out + r * ldo + (i - r * chunks) * C::kWidth;
    const float cnt = out[r * ldo + D];
    C::divide(p, cnt < 1.f ? 1.f : cnt);
  }
}

// K4 (count 0, ldo >= D) and K5 (count 1, ldo >= D + 1, then the mean):
// zero `out` [S, ldo], then launch.
int gather_copy(const void* x, const void* mask, int mask_is_bool, const void* senders,
                const void* receivers, void* out, long long E, int N, int D, int S,
                int ldo, int count, void* stream) {
  if (D < 0 || ldo < D + count || E < 0 || N < 0 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = hg::zero_rows(out, S, ldo, st);
  if (err != cudaSuccess) return (int)err;
  if (E == 0 || S == 0 || D + count == 0) return (int)cudaGetLastError();
  const GatherArgs a{(const float*)x, nullptr, mask, mask_is_bool,
                     (const int32_t*)senders, (const int32_t*)receivers, (float*)out, nullptr,
                     E, N, D, S, ldo, 0, count ? D : -1, 0, 0, 0, 0};
  err = hg::launch_gather<Op::kSum>(a, st);
  if (err != cudaSuccess || !count || D == 0) return (int)err;
  const bool vec = D % 4 == 0 && ldo % 4 == 0 && hg::aligned(out, 16);
  const int64_t n = (int64_t)S * (vec ? D / 4 : D);
  if (vec)
    mean_rows_kernel<float4><<<(unsigned)grid_for(n), kThreads, 0, st>>>((float*)out, S, D, ldo);
  else
    mean_rows_kernel<float><<<(unsigned)grid_for(n), kThreads, 0, st>>>((float*)out, S, D, ldo);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. yj [N, D], ze [E, D] or null, mask [E] (bool bytes when mask_is_bool,
// else f32) -> z [E, D], written for every edge, and out [S, ldo]: columns
// [0, D) the sum of z, [sq_off, sq_off + D) the sum of z^2, cnt_off the sum
// of the mask; zeroed here on `stream`
extern "C" int hg_fused_gather_moments_f32(const void* yj, const void* ze, const void* mask,
                                           int mask_is_bool, const void* senders,
                                           const void* receivers, void* out, void* z,
                                           long long E, int N, int D, int S, int ldo,
                                           int sq_off, int cnt_off, void* stream) {
  const GatherArgs a{(const float*)yj, (const float*)ze, mask, mask_is_bool,
                     (const int32_t*)senders, (const int32_t*)receivers, (float*)out, (float*)z,
                     E, N, D, S, ldo, sq_off, cnt_off, 0, 0, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(ze != nullptr ? hg::launch_moments<Op::kMomentsZe>(a, st)
                             : hg::launch_moments<Op::kMoments>(a, st));
}

// x [N, D], mask [E] (bool bytes when mask_is_bool, else f32) -> out [S, ldo],
// columns [0, D) the sum; zeroed here on `stream`
extern "C" int hg_fused_gather_sum_f32(const void* x, const void* mask, int mask_is_bool,
                                       const void* senders, const void* receivers,
                                       void* out, long long E, int N, int D, int S,
                                       int ldo, void* stream) {
  return gather_copy(x, mask, mask_is_bool, senders, receivers, out, E, N, D, S, ldo, 0,
                     stream);
}

// as hg_fused_gather_sum_f32, and column D the sum of the mask; columns
// [0, D) then hold the mean, the sum over max(count, 1)
extern "C" int hg_fused_gather_count_f32(const void* x, const void* mask, int mask_is_bool,
                                         const void* senders, const void* receivers,
                                         void* out, long long E, int N, int D, int S,
                                         int ldo, void* stream) {
  return gather_copy(x, mask, mask_is_bool, senders, receivers, out, E, N, D, S, ldo, 1,
                     stream);
}

// K6. h [N, D], w [E, D] -> out [S, D], the sum of h[senders[e]] * w[e] at
// receivers[e]; zeroed here on `stream`
extern "C" int hg_fused_gather_mul_f32(const void* h, const void* w,
                                       const void* senders,
                                       const void* receivers, void* out,
                                       long long E, int N, int D, int S,
                                       void* stream) {
  if (D < 0 || E < 0 || N < 0 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = hg::zero_for_dependent((float*)out, (int64_t)S * D, st);
  if (err != cudaSuccess) return (int)err;
  if (E == 0 || S == 0 || D == 0) return (int)cudaGetLastError();
  const GatherArgs a{(const float*)h, (const float*)w, nullptr, 0,
                     (const int32_t*)senders, (const int32_t*)receivers, (float*)out, nullptr,
                     E, N, D, S, D, 0, -1, 0, 0, 0, 0};
  return (int)hg::launch_gather<Op::kMul>(a, st);
}
