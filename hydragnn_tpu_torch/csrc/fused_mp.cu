// PNA's statistics pass in one kernel: gather, edge op, segment reduce.
//
// Replaces the TPU kernel of hydragnn_tpu/ops/fused_mp.py: fused_message_reduce
// with the "moments" edge op (_fused_impl, fused_mp.py:212-334; op
// _op_moments, :82-94; wrapper fused_gather_moments, :501-517).
//
// For every edge e and column d < D:
//   x     = yj[senders[e], d], or 0 when senders[e] is outside [0, N)
//   z     = (x + ze[e, d]) * mask[e]     (ze may be absent: z = x * mask[e])
//   z_out[e, d] = z
//   and, when receivers[e] is inside [0, S), into the packed row
//   out[receivers[e]] = [sum z (D) | sum z^2 (D) | sum mask (1)].
// The count column sums the mask: it counts real edges, as the TPU op does.
// Accumulation is f32; `out` must be zeroed by the caller.
//
// What bounds it on the card: bytes. Per element it does a handful of
// operations on 4 bytes read and 4 written; the least time is the inputs
// (yj once, ze, mask, both id arrays) read once and z plus the packed
// output written once, over 3.35 TB/s.
//
// Design: one thread per (edge, column) element, a grid-stride loop. The
// gathered row, the optional ze row and the z row are read and written by
// neighbouring threads at neighbouring addresses, so every access is
// coalesced; the reduction is three f32 atomicAdds per element (one more for
// the count, by the column-0 thread) into the receiver's packed row. The
// packed width 2D+1 is odd, so the output is addressed with scalar accesses
// and D = 1 needs no special case. On the TPU the node table sat in VMEM
// and the gather was a one-hot matrix product; here the gather is a direct
// load that the 50 MB L2 cache serves (yj is 5.9 MB at the main path's
// shapes). Where the TPU kernel took the edge encoding and the mask as one
// packed [E, D+1] operand, this one takes them as two, so the caller never
// concatenates an [E, D] array. Atomics add in a run-dependent order; the
// tolerance against the plain version is relative, about
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

}  // namespace

extern "C" int hg_fused_gather_moments_f32(const void* yj, const void* ze,
                                           const void* mask,
                                           const void* senders,
                                           const void* receivers, void* out,
                                           void* z, long long E, int N, int D,
                                           int S, void* stream) {
  const int64_t n = (int64_t)E * D;
  if (n > 0) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    fused_gather_moments_kernel<<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const float*)yj, (const float*)ze, (const float*)mask,
        (const int32_t*)senders, (const int32_t*)receivers, (float*)out,
        (float*)z, E, N, D, S);
  }
  return (int)cudaGetLastError();
}
