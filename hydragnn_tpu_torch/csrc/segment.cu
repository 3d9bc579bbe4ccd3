// Segment reductions of an [E, D] f32 array by int32 segment ids, on Hopper.
//
// Replaces the TPU kernels of hydragnn_tpu/ops/pallas_segment.py:
//   * hg_segment_sum_f32     <- segment_sum_onehot (_sum_kernel /
//                               _segment_sum_fwd_impl, pallas_segment.py:101-135)
//   * hg_segment_moments_f32 <- segment_moments (_moments_kernel /
//                               _moments_impl, pallas_segment.py:171-218)
//
// Contract (the same as the TPU kernels'): out[s] = sum over edges e with
// ids[e] == s of data[e]; ids outside [0, S) add nothing. The moments entry
// also gives sq[s] = sum of data[e]^2 and cnt[s] = the number of in-range
// ids equal to s, unweighted (the one-hot row sums of _onehot,
// pallas_segment.py:90-94: the padding node counts the padded edges).
// Accumulation is f32. The outputs must be zeroed by the caller.
//
// What bounds it on the card: bytes. Each element is read once and does one
// add (two and a multiply for the moments), far below the H100's ratio of
// operations to bytes, so the least time is (E*D + E) * 4 bytes read plus
// the outputs written, over 3.35 TB/s.
//
// Design: one thread per (edge, column) element over the flat [E, D] array,
// a grid-stride loop, and an f32 atomicAdd into row ids[e] of the output.
// Neighbouring threads read neighbouring columns of one edge row and add
// into neighbouring columns of one output row, so loads and atomics are
// coalesced for D = 256 and for D = 1 alike. The TPU kernel's one-hot
// matrix product (a way to feed its matrix unit) does not carry over: here
// a scatter is a direct atomic. Atomics add in a run-dependent order, so
// two runs may differ in the last bits; the tolerance against the plain
// version is relative, about 1e-5 * (max |partial sum| + 1). Sorted ids
// (pooling) make many threads add into one row; that contention is the
// first thing a faster version removes (a segmented reduction in
// registers before one atomic per run of equal ids).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

int64_t blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

__global__ void segment_sum_kernel(const float* __restrict__ data,
                                   const int32_t* __restrict__ ids,
                                   float* __restrict__ out, int64_t E, int D,
                                   int S) {
  const int64_t n = E * D;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i / D;
    const int d = (int)(i - e * D);
    const int32_t s = ids[e];
    if (s >= 0 && s < S) atomicAdd(out + (int64_t)s * D + d, data[i]);
  }
}

__global__ void segment_moments_kernel(const float* __restrict__ data,
                                       const int32_t* __restrict__ ids,
                                       float* __restrict__ sum,
                                       float* __restrict__ cnt,
                                       float* __restrict__ sq, int64_t E,
                                       int D, int S) {
  const int64_t n = E * D;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i / D;
    const int d = (int)(i - e * D);
    const int32_t s = ids[e];
    if (s < 0 || s >= S) continue;
    const float v = data[i];
    const int64_t o = (int64_t)s * D + d;
    atomicAdd(sum + o, v);
    atomicAdd(sq + o, v * v);
    if (d == 0) atomicAdd(cnt + s, 1.0f);
  }
}

}  // namespace

extern "C" int hg_segment_sum_f32(const void* data, const void* ids, void* out,
                                  long long E, int D, int S, void* stream) {
  const int64_t n = (int64_t)E * D;
  if (n > 0) {
    segment_sum_kernel<<<(unsigned)blocks_for(n), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)data, (const int32_t*)ids, (float*)out, E, D, S);
  }
  return (int)cudaGetLastError();
}

extern "C" int hg_segment_moments_f32(const void* data, const void* ids,
                                      void* sum, void* cnt, void* sq,
                                      long long E, int D, int S,
                                      void* stream) {
  const int64_t n = (int64_t)E * D;
  if (n > 0) {
    segment_moments_kernel<<<(unsigned)blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)data, (const int32_t*)ids, (float*)sum, (float*)cnt,
        (float*)sq, E, D, S);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
