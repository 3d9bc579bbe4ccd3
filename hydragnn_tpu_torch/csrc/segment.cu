// Segment reductions of an [E, D] f32 array by int32 segment ids, on Hopper.
//
// Replaces the TPU kernels of hydragnn_tpu/ops/pallas_segment.py:
//   * hg_segment_sum_f32     <- segment_sum_onehot (_sum_kernel /
//                               _segment_sum_fwd_impl, pallas_segment.py:101-135)
//   * hg_segment_moments_f32 <- segment_moments (_moments_kernel /
//                               _moments_impl, pallas_segment.py:171-218)
//
// Contract (the same as the TPU kernels'): out[s] = sum over edges e with
// ids[e] == s of data[e]; ids outside [0, S) add nothing, in any order of
// ids. The moments entry also gives sq[s] = sum of data[e]^2 and cnt[s] =
// the number of in-range ids equal to s, unweighted (the one-hot row sums
// of _onehot, pallas_segment.py:90-94: the padding node counts the padded
// edges), packed in one row [sum (D) | pad | sum of squares (D) | pad |
// count | pad] whose parts start 16 bytes apart from the row's start (the
// wrapper's layout, ops/segment_kernels.moments_layout). Accumulation is
// f32. Both entries zero their output themselves (cudaMemsetAsync on the
// caller's stream).
//
// What bounds both on the card: bytes. Each element is read once and does
// one add (two and a multiply for the moments), far below the H100's ratio
// of operations to bytes, so the least time is (E*D + E) * 4 bytes read
// plus the outputs written, over 3.35 TB/s. What held the first version of
// the sum back was not the bytes but the atomics: one f32 atomic per
// element, and on sorted ids (pooling: ~89 consecutive rows per graph) all
// of a row's atomics land on one output row.
//
// Design of the sum (K1): a segmented reduction in registers. The [E, D]
// array is cut into slices of R consecutive rows (R = 8..32, chosen so
// that the grid fills the card's SMs). A thread owns one slice and one column
// chunk: a float4 when D % 4 == 0 and both pointers are 16-byte aligned,
// one float otherwise. Neighbouring threads take neighbouring chunks of
// the same slice, so each row's loads are coalesced and its id is one
// broadcast load. The thread walks its rows in order, four loads in
// flight, and adds in registers while the id stays the same; at a change
// of id, and at the end of its rows, it makes one atomic for the run
// (Hopper's vector atomicAdd on float4 in global memory on the vector
// path). An out-of-range id ends a run and adds nothing. Unsorted ids stay
// correct: they only flush more often. With sorted pool ids the atomics
// drop by R; on the receivers of the served graphs half the edges come in
// runs of 6 equal ids. For D = 1 a thread takes R consecutive rows of the
// one column. Atomics add in a run-dependent order, so two runs may differ
// in the last bits; the tolerance against the plain version is relative,
// about 1e-5 * (max |partial sum| + 1).
//
// Design of the moments (K2): the gather-reduce kernel of K3-K6
// (gather_reduce.cuh, Op::kRows), reading the rows in order instead of
// gathering them; fused_mp.cu's header describes it. The first design, a
// thread per (edge, column) element with a 64-bit divide and three scalar
// atomics, spent ~95 us of its 109 at the served receivers shape before
// any atomic (a knockout; NVIDIA H100 80GB HBM3 at 700 W, as all times
// here, PERF.md). On wide rows a block sorts 256 consecutive ids, a group
// of 32 lanes walks 32 of them in that order across a 256-column slab, 2
// chunks of 16 bytes per lane, sums and squares in registers while the id
// repeats, and at a change of id makes one 16-byte atomic per chunk to
// each half; lane 0 of the slab-0 block adds the run's length to the
// count: 45 us at D = 256 (K1 reads the same bytes in 40). K1's layout
// above, with squares and a count, took 59 us there unsorted (the kernel
// laid out as K4 unsorted: 58), and 8.9 us at D = 1 against 8.0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_reduce.cuh"
#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

int64_t blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

constexpr int kUnroll = 4;  // rows whose loads are in flight together

__device__ __forceinline__ bool in_range(int32_t s, int S) { return s >= 0 && s < S; }

template <typename T>
struct Vec;  // the column chunk a thread owns: 4 floats or 1

template <>
struct Vec<float4> {
  static constexpr int kWidth = 4;
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(float4& a, const float4& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  static __device__ __forceinline__ void flush(float* p, const float4& v) {
    atomicAdd(reinterpret_cast<float4*>(p), v);  // sm_90: one vector atomic
  }
};

template <>
struct Vec<float> {
  static constexpr int kWidth = 1;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ void add(float& a, float b) { a += b; }
  static __device__ __forceinline__ void flush(float* p, float v) { atomicAdd(p, v); }
};

// One thread: rows [slice * R, slice * R + R) of column chunk c; R % kUnroll == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) segment_sum_runs_kernel(
    const float* __restrict__ data, const int32_t* __restrict__ ids,
    float* __restrict__ out, int64_t E, int D, int S, int R, int64_t items) {
  using V = Vec<T>;
  const int chunks = D / V::kWidth;
  for (int64_t item = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; item < items;
       item += (int64_t)gridDim.x * blockDim.x) {
    const int64_t slice = item / chunks;
    const int col = (int)(item - slice * chunks) * V::kWidth;
    const int64_t e0 = slice * R;
    const int64_t e1 = e0 + R < E ? e0 + R : E;
    int32_t cur = -1;
    T acc = V::zero();
    for (int64_t e = e0; e < e1; e += kUnroll) {
      int32_t s[kUnroll];
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = e + u < e1 ? __ldg(ids + e + u) : -1;
        v[u] = e + u < e1
                   ? __ldg(reinterpret_cast<const T*>(data + (e + u) * D + col))
                   : V::zero();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s[u] != cur) {
          if (in_range(cur, S)) V::flush(out + (int64_t)cur * D + col, acc);
          cur = s[u];
          acc = V::zero();
        }
        if (in_range(s[u], S)) V::add(acc, v[u]);
      }
    }
    if (in_range(cur, S)) V::flush(out + (int64_t)cur * D + col, acc);
  }
}

// Rows per thread: as many as still leave 512 threads for each of the
// card's SMs, between 8 and 32 and a multiple of kUnroll (longer slices
// mean fewer atomics on sorted ids).
int rows_per_thread(int64_t E, int chunks, int sms) {
  const int64_t want = (int64_t)(sms > 0 ? sms : 1) * 512;
  int64_t r = (E * chunks) / want;
  r = r < 8 ? 8 : (r > 32 ? 32 : r);
  return (int)(r - r % kUnroll);
}

template <typename T>
void launch_sum(const float* data, const int32_t* ids, float* out, int64_t E,
                int D, int S, int sms, cudaStream_t stream) {
  const int chunks = D / Vec<T>::kWidth;
  const int R = rows_per_thread(E, chunks, sms);
  const int64_t items = (E + R - 1) / R * chunks;
  segment_sum_runs_kernel<T><<<(unsigned)blocks_for(items), kThreads, 0, stream>>>(
      data, ids, out, E, D, S, R, items);
}

}  // namespace

// data [E, D] f32, ids [E] i32 -> out [S, D] f32, zeroed here on `stream`.
extern "C" int hg_segment_sum_f32(const void* data, const void* ids, void* out,
                                  long long E, int D, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t out_bytes = (size_t)S * (size_t)D * sizeof(float);
  if (out_bytes > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, st);
    if (err != cudaSuccess) return (int)err;
  }
  if ((int64_t)E * D > 0) {
    int dev = 0;
    const cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const int sms = hg::sm_count(dev);
    const bool vec = D % 4 == 0 && (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0;
    if (vec)
      launch_sum<float4>((const float*)data, (const int32_t*)ids, (float*)out, E, D, S, sms, st);
    else
      launch_sum<float>((const float*)data, (const int32_t*)ids, (float*)out, E, D, S, sms, st);
  }
  return (int)cudaGetLastError();
}

// data [E, D] f32, ids [E] i32 -> out [S, ldo] f32, zeroed here on
// `stream`: columns [0, D) the sum, [sq_off, sq_off + D) the sum of
// squares, cnt_off the number of in-range ids.
extern "C" int hg_segment_moments_f32(const void* data, const void* ids, void* out,
                                      long long E, int D, int S, int ldo, int sq_off,
                                      int cnt_off, void* stream) {
  const hg::GatherArgs a{(const float*)data, nullptr, nullptr, 0, nullptr,
                         (const int32_t*)ids, (float*)out, nullptr, E, 0, D, S, ldo,
                         sq_off, cnt_off, 0, 0, 0, 0};
  return (int)hg::launch_moments<hg::Op::kRows>(a, (cudaStream_t)stream);
}

extern "C" const char* hg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
