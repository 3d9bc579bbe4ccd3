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
// Accumulation is f32. Atomics add in a run-dependent order; the tolerance
// against the plain versions is relative, about
// 1e-5 * (max |partial sum| + 1).
//
// What bounds them on the card: bytes. Per element they do one or two
// operations on 4 bytes read; the least time is the inputs (the node table
// once, the mask or w, both id arrays) read once and the output written
// once, over 3.35 TB/s. The gathered rows themselves (E * D * 4 bytes, 70.8
// MB at the main path's widest K4 call) come from the on-chip caches: the
// node table (5.9 MB) stays in the 50 MB L2.
//
// K3 and K6: one thread per (edge, column) element, a grid-stride loop; one
// f32 atomicAdd per output element (K3: two, plus the count by the column-0
// thread) into the receiver's row, whose packed width 2D+1 (K3) is odd, so
// the output is addressed with scalar accesses. `out` must be zeroed by the
// caller. Where the TPU kernel took the edge encoding and the mask as one
// packed [E, D+1] operand, K3 takes them as two, so the caller never
// concatenates an [E, D] array.
//
// K4 and K5: one gather-reduce kernel laid out for this card. What held the
// one-thread-per-element design back was not the bytes but its 17.7 M
// scalar global atomics per call at the main path's widest shape. A block
// takes a tile of 128 consecutive edges and stages their ids and mask in
// shared memory. A group of up to 16 lanes then walks 8 consecutive edges
// (at D >= 64) across a whole slab of 256 columns: each lane owns 4 chunks
// of 16 bytes, 16 lanes apart, so a row's 1 KB comes in as four contiguous
// 256-byte pieces and one edge's ids, mask and run test serve 256 columns;
// two edges' rows are in flight per lane. A row gathered for the edge
// before is reused while the sender repeats, and the rows add in registers
// while the receiver repeats (K1's run reduction, csrc/segment.cu); at a
// change of receiver the run goes out with one atomic per chunk (16 bytes
// on the vector path). On the served layout (each graph's edges
// contiguous, half of them in runs of 6 senders, half in runs of 6
// receivers) that skips 5 of 6 gathers on one half and 5 of 6 atomics on
// the other. The id order only decides how often a row is reused or a run
// flushed: any order is right. Two blocks share an SM (no spills; held to
// three, the loop spills and runs slower). What bounds the kernel now is
// the gather of the rows from the caches. A shared-memory window of
// receivers ran slower on the card, both as f32 sums (shared f32 atomics
// compile to compare-and-swap loops on sm_90) and as a counting sort of the
// tile by receiver (the sort costs more than the atomics it saves, and it
// breaks up the sender runs). Without the float4 path (D % 4 != 0, or rows
// not 16-byte aligned) lanes own single floats, up to 32 of them; D = 1 is
// one lane per edge. K5's count rides along as one more register, flushed
// by lane 0 of the slab-0 block; its output rows are padded to a multiple
// of 4 floats (ldo), so the data chunks stay 16-byte aligned, and a second
// kernel then divides the sums by the count in place. A bool mask is read
// as bytes. The C entries zero their own output on the caller's stream.

#include <climits>
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

// K6: h [N, D] gathered, times w [E, D], summed at the receivers.
__global__ void fused_gather_mul_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const int32_t* __restrict__ senders, const int32_t* __restrict__ receivers,
    float* __restrict__ out, int64_t E, int N, int D, int S) {
  const int64_t n = E * D;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i / D;
    const int d = (int)(i - e * D);
    const int32_t s = senders[e];
    const float xv = (s >= 0 && s < N) ? x[(int64_t)s * D + d] : 0.0f;
    const int32_t r = receivers[e];
    if (r < 0 || r >= S) continue;
    atomicAdd(out + (int64_t)r * D + d, xv * w[i]);
  }
}

int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

// ---- K4 / K5 -----------------------------------------------------------

constexpr int kCopyThreads = 256;
constexpr int kCopyBlocks = 2;  // resident blocks per SM: up to 128 registers, no spills
constexpr int kTile = 128;      // consecutive edges per block
constexpr int kPerLane = 4;     // chunks a lane owns in a slab, lanes apart
constexpr int kInFlight = 2;    // edges a lane has in flight (8 chunks)

template <typename T>
struct Chunk;  // 4 floats or 1

template <>
struct Chunk<float4> {
  static constexpr int kWidth = 4;
  static constexpr int kMaxLanes = 16;  // 16 x 4 chunks: a slab of 256 columns
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(float4& a, const float4& v, float m) {
    a.x += v.x * m; a.y += v.y * m; a.z += v.z * m; a.w += v.w * m;
  }
  static __device__ __forceinline__ void flush(float* p, const float4& v) {
    atomicAdd(reinterpret_cast<float4*>(p), v);  // sm_90: one vector atomic
  }
  static __device__ __forceinline__ void divide(float* p, float c) {
    float4 v = *reinterpret_cast<float4*>(p);
    v.x /= c; v.y /= c; v.z /= c; v.w /= c;
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Chunk<float> {
  static constexpr int kWidth = 1;
  static constexpr int kMaxLanes = 32;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(float& a, float v, float m) { a += v * m; }
  static __device__ __forceinline__ void flush(float* p, float v) { atomicAdd(p, v); }
  static __device__ __forceinline__ void divide(float* p, float c) { *p /= c; }
};

// One block: edges [tile * kTile, + kTile) and the column chunks of one
// slab, kPerLane * lanes of them; lane l of a group owns chunks l, l +
// lanes, l + 2 * lanes, ... of the slab, so each of its loads is one
// contiguous run of the row across the group. lanes is a power of two
// dividing kCopyThreads.
template <typename T>
__global__ void __launch_bounds__(kCopyThreads, kCopyBlocks) gather_copy_kernel(
    const float* __restrict__ x, const void* __restrict__ mask, int mask_is_bool,
    const int32_t* __restrict__ senders, const int32_t* __restrict__ receivers,
    float* __restrict__ out, int64_t E, int N, int D, int S, int ldo, int count,
    int lanes, int slabs) {
  using C = Chunk<T>;
  __shared__ int32_t s_snd[kTile], s_rcv[kTile];
  __shared__ float s_m[kTile];

  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x / slabs;
  const int slab = (int)(blockIdx.x - tile * slabs);
  const int64_t e0 = tile * kTile;

  // 1. stage the tile's ids (out of range: -1) and mask
  for (int i = tid; i < kTile; i += kCopyThreads) {
    const int64_t e = e0 + i;
    int32_t s = -1, r = -1;
    float m = 0.f;
    if (e < E) {
      s = __ldg(senders + e);
      r = __ldg(receivers + e);
      m = mask_is_bool ? (__ldg(static_cast<const uint8_t*>(mask) + e) ? 1.f : 0.f)
                       : __ldg(static_cast<const float*>(mask) + e);
    }
    s_snd[i] = (s >= 0 && s < N) ? s : -1;  // gathers a zero row
    s_rcv[i] = (r >= 0 && r < S) ? r : -1;  // adds nothing
    s_m[i] = m;
  }
  __syncthreads();

  // 2. each group walks its consecutive edges: a row gathered for the edge
  //    before is reused while the sender repeats, and the rows add in
  //    registers while the receiver repeats, one global atomic per run and
  //    chunk
  const int g = tid / lanes, l = tid - g * lanes;
  const int groups = kCopyThreads / lanes;
  const int per = kTile > groups ? kTile / groups : 1;
  const int q0 = g * per, q1 = min(q0 + per, kTile);
  const int chunks = D / C::kWidth;
  int col[kPerLane];
  bool active[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = (slab * kPerLane + k) * lanes + l;
    col[k] = c * C::kWidth;
    active[k] = c < chunks;
  }
  const bool counts = count && slab == 0 && l == 0;
  T acc[kPerLane], last[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) acc[k] = last[k] = C::zero();
  float cnt = 0.f;
  int cur = -1, s_last = -1;
  auto flush = [&]() {
    if (cur < 0) return;
    float* row = out + (int64_t)cur * ldo;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      if (active[k]) C::flush(row + col[k], acc[k]);
    if (counts) atomicAdd(row + D, cnt);
  };
  for (int q = q0; q < q1; q += kInFlight) {
    int32_t r[kInFlight];
    float m[kInFlight];
    T v[kInFlight][kPerLane];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const bool in = q + u < q1;
      const int32_t s = in ? s_snd[q + u] : -1;
      r[u] = in ? s_rcv[q + u] : -1;
      m[u] = in ? s_m[q + u] : 0.f;
      const bool fresh = s != s_last;
      const float* xs = x + (int64_t)s * D;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const T prev = u == 0 ? last[k] : v[u > 0 ? u - 1 : 0][k];
        v[u][k] = !fresh ? prev : (active[k] && s >= 0 ? C::load(xs + col[k]) : C::zero());
      }
      s_last = s;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (r[u] < 0) continue;  // adds nothing
      if (r[u] != cur) {
        flush();
        cur = r[u];
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) acc[k] = C::zero();
        cnt = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) C::add(acc[k], v[u][k], m[u]);
      cnt += m[u];
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) last[k] = v[kInFlight - 1][k];
  }
  flush();
}

template <typename T>
cudaError_t launch_copy(const float* x, const void* mask, int mask_is_bool,
                        const int32_t* senders, const int32_t* receivers, float* out,
                        int64_t E, int N, int D, int S, int ldo, int count,
                        cudaStream_t stream) {
  using C = Chunk<T>;
  const int chunks = D / C::kWidth;
  int lanes = 1;
  while (lanes * kPerLane < chunks && lanes < C::kMaxLanes) lanes *= 2;
  const int per_slab = lanes * kPerLane;
  const int slabs = chunks > 0 ? (chunks + per_slab - 1) / per_slab : 1;  // D = 0: the count
  const int64_t blocks = (E + kTile - 1) / kTile * slabs;
  gather_copy_kernel<T><<<(unsigned)blocks, kCopyThreads, 0, stream>>>(
      x, mask, mask_is_bool, senders, receivers, out, E, N, D, S, ldo, count, lanes, slabs);
  return cudaGetLastError();
}

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
  const size_t out_bytes = (size_t)S * (size_t)ldo * sizeof(float);
  if (out_bytes > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (E == 0 || S == 0 || D + count == 0) return (int)cudaGetLastError();
  const bool vec = D % 4 == 0 && D > 0 && ldo % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int32_t* snd = (const int32_t*)senders;
  const int32_t* rcv = (const int32_t*)receivers;
  cudaError_t err =
      vec ? launch_copy<float4>((const float*)x, mask, mask_is_bool, snd, rcv, (float*)out, E,
                                N, D, S, ldo, count, st)
          : launch_copy<float>((const float*)x, mask, mask_is_bool, snd, rcv, (float*)out, E,
                               N, D, S, ldo, count, st);
  if (err != cudaSuccess || !count || D == 0) return (int)err;
  const int64_t n = (int64_t)S * (vec ? D / 4 : D);
  if (vec)
    mean_rows_kernel<float4><<<(unsigned)grid_for(n), kThreads, 0, st>>>((float*)out, S, D, ldo);
  else
    mean_rows_kernel<float><<<(unsigned)grid_for(n), kThreads, 0, st>>>((float*)out, S, D, ldo);
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

// h [N, D], w [E, D] -> out [S, D]
extern "C" int hg_fused_gather_mul_f32(const void* h, const void* w,
                                       const void* senders,
                                       const void* receivers, void* out,
                                       long long E, int N, int D, int S,
                                       void* stream) {
  const int64_t n = (int64_t)E * D;
  if (n > 0) {
    fused_gather_mul_kernel<<<(unsigned)grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)h, (const float*)w, (const int32_t*)senders,
        (const int32_t*)receivers, (float*)out, E, N, D, S);
  }
  return (int)cudaGetLastError();
}
