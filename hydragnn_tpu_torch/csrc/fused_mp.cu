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
//   K3: z = (x + ze[e, d]) * mask[e]  (ze may be absent);  z_out[e, d] = z;
//       packed row [sum z (D) | sum z^2 (D) | sum mask (1)]
//   K4: row [sum x * mask[e] (D)]
//   K5: row [sum x * mask[e] (D) | sum mask (1)]
//   K6: row [sum x * w[e, d] (D)]   (w comes masked)
//
// The count columns sum the mask: they count real edges, as the TPU ops do.
// Accumulation is f32; `out` must be zeroed by the caller.
//
// What bounds them on the card: bytes. Per element they do one or two
// operations on 4 bytes read; the least time is the inputs (the node table
// once, the mask or w, both id arrays) read once and the output written
// once, over 3.35 TB/s.
//
// Design: one thread per (edge, column) element, a grid-stride loop. The
// gathered row (and ze, w, z rows) are read and written by neighbouring
// threads at neighbouring addresses, so every access is coalesced; the
// reduction is one f32 atomicAdd per output element (K3: two, plus the
// count by the column-0 thread) into the receiver's row. The packed widths
// 2D+1 (K3) and D+1 (K5) are odd, so the output is addressed with scalar
// accesses, and D = 1 or an odd D (SchNet's 50 filters) needs no special
// case. K4-K6 share one kernel templated over the op. On the TPU the node
// table sat in VMEM and the gather was a one-hot matrix product; here the
// gather is a direct load that the 50 MB L2 cache serves (5.9 MB at the
// main path's widest table). Where the TPU kernel took the edge encoding and
// the mask as one packed [E, D+1] operand, K3 takes them as two, so the
// caller never concatenates an [E, D] array. Atomics add in a run-dependent
// order; the tolerance against the plain versions is relative, about
// 1e-5 * (max |partial sum| + 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void fused_gather_moments_kernel(
    const float* __restrict__ yj, const float* __restrict__ ze,
    const float* __restrict__ mask, const int32_t* __restrict__ senders,
    const int32_t* __restrict__ receivers, float* __restrict__ out,
    float* __restrict__ z_out, int64_t E, int N, int D, int S) {
  const int64_t n = E * D;
  const int64_t width = 2 * (int64_t)D + 1;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i / D;
    const int d = (int)(i - e * D);
    const int32_t s = senders[e];
    float x = (s >= 0 && s < N) ? yj[(int64_t)s * D + d] : 0.0f;
    if (ze != nullptr) x += ze[i];
    const float m = mask[e];
    const float z = x * m;
    z_out[i] = z;
    const int32_t r = receivers[e];
    if (r < 0 || r >= S) continue;
    float* row = out + (int64_t)r * width;
    atomicAdd(row + d, z);
    atomicAdd(row + D + d, z * z);
    if (d == 0) atomicAdd(row + 2 * D, m);
  }
}

enum class Op { kCopy, kCopyCount, kMul };

// K4 / K5 / K6. `ef` is the [E] mask (copy, copy_count) or the [E, D]
// weights (mul).
template <Op OP>
__global__ void fused_gather_reduce_kernel(
    const float* __restrict__ x, const float* __restrict__ ef,
    const int32_t* __restrict__ senders, const int32_t* __restrict__ receivers,
    float* __restrict__ out, int64_t E, int N, int D, int S) {
  const int64_t n = E * D;
  const int64_t width = OP == Op::kCopyCount ? (int64_t)D + 1 : D;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i / D;
    const int d = (int)(i - e * D);
    const int32_t s = senders[e];
    const float xv = (s >= 0 && s < N) ? x[(int64_t)s * D + d] : 0.0f;
    const float f = OP == Op::kMul ? ef[i] : ef[e];
    const int32_t r = receivers[e];
    if (r < 0 || r >= S) continue;
    float* row = out + (int64_t)r * width;
    atomicAdd(row + d, xv * f);
    if (OP == Op::kCopyCount && d == 0) atomicAdd(row + D, f);
  }
}

int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

template <Op OP>
int launch_gather_reduce(const void* x, const void* ef, const void* senders,
                         const void* receivers, void* out, long long E, int N,
                         int D, int S, void* stream) {
  const int64_t n = (int64_t)E * D;
  if (n > 0) {
    fused_gather_reduce_kernel<OP>
        <<<(unsigned)grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)x, (const float*)ef, (const int32_t*)senders,
            (const int32_t*)receivers, (float*)out, E, N, D, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hg_fused_gather_moments_f32(const void* yj, const void* ze,
                                           const void* mask,
                                           const void* senders,
                                           const void* receivers, void* out,
                                           void* z, long long E, int N, int D,
                                           int S, void* stream) {
  const int64_t n = (int64_t)E * D;
  if (n > 0) {
    fused_gather_moments_kernel<<<(unsigned)grid_for(n), kThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)yj, (const float*)ze, (const float*)mask,
        (const int32_t*)senders, (const int32_t*)receivers, (float*)out,
        (float*)z, E, N, D, S);
  }
  return (int)cudaGetLastError();
}

// x [N, D], mask [E] -> out [S, D]
extern "C" int hg_fused_gather_sum_f32(const void* x, const void* mask,
                                       const void* senders,
                                       const void* receivers, void* out,
                                       long long E, int N, int D, int S,
                                       void* stream) {
  return launch_gather_reduce<Op::kCopy>(x, mask, senders, receivers, out, E,
                                         N, D, S, stream);
}

// x [N, D], mask [E] -> out [S, D + 1]
extern "C" int hg_fused_gather_count_f32(const void* x, const void* mask,
                                         const void* senders,
                                         const void* receivers, void* out,
                                         long long E, int N, int D, int S,
                                         void* stream) {
  return launch_gather_reduce<Op::kCopyCount>(x, mask, senders, receivers,
                                              out, E, N, D, S, stream);
}

// h [N, D], w [E, D] -> out [S, D]
extern "C" int hg_fused_gather_mul_f32(const void* h, const void* w,
                                       const void* senders,
                                       const void* receivers, void* out,
                                       long long E, int N, int D, int S,
                                       void* stream) {
  return launch_gather_reduce<Op::kMul>(h, w, senders, receivers, out, E, N,
                                        D, S, stream);
}
