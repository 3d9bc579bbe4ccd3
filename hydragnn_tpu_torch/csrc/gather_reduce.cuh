// The gather-reduce kernel of K2, K3, K4, K5 and K6: rows reduced into
// output rows by receiver id, each run of equal ids in registers, one
// vector atomic per run and column chunk (per half of the row for the
// moments). Included by fused_mp.cu (K3-K6: the rows gathered from a node
// table by sender) and segment.cu (K2: the rows of an [E, D] array, read
// in order). fused_mp.cu's header describes the design and what the card
// showed of it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hg {

constexpr int kGatherThreads = 256;
constexpr int kGatherBlocks = 2;  // resident blocks per SM: up to 128 registers, no spills
constexpr int kTile = 128;        // consecutive edges per block, at least
constexpr int kMaxTile = 1024;    // ... and at most (the moments on narrow rows)
constexpr int kSortTile = 256;    // the moments on wide rows: a tile sorted by receiver
constexpr int kSortLanes = 8;     // ... from this many lanes per group on

template <typename T>
struct Chunk;  // 4 floats, 2 (K6 only) or 1

template <>
struct Chunk<float4> {
  static constexpr int kWidth = 4;
  static constexpr int kMaxLanes = 16;
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 load_once(const float* p) {  // read once: evict first
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, const float4& v) {  // evict first
    __stcs(reinterpret_cast<float4*>(p), v);
  }
  static __device__ __forceinline__ float4 plus(const float4& a, const float4& b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  static __device__ __forceinline__ float4 times(const float4& a, float m) {
    return make_float4(a.x * m, a.y * m, a.z * m, a.w * m);
  }
  static __device__ __forceinline__ void add(float4& a, const float4& v, float m) {
    a.x += v.x * m; a.y += v.y * m; a.z += v.z * m; a.w += v.w * m;
  }
  static __device__ __forceinline__ void add(float4& a, const float4& v) {
    a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
  }
  static __device__ __forceinline__ void mul_add(float4& a, const float4& v, const float4& w) {
    a.x += v.x * w.x; a.y += v.y * w.y; a.z += v.z * w.z; a.w += v.w * w.w;
  }
  static __device__ __forceinline__ void add_sq(float4& a, const float4& v) {
    a.x += v.x * v.x; a.y += v.y * v.y; a.z += v.z * v.z; a.w += v.w * v.w;
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
struct Chunk<float2> {
  static constexpr int kWidth = 2;
  static constexpr int kMaxLanes = 32;
  static __device__ __forceinline__ float2 zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ float2 load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ float2 load_once(const float* p) {
    return __ldcs(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ void mul_add(float2& a, const float2& v, const float2& w) {
    a.x += v.x * w.x; a.y += v.y * w.y;
  }
  static __device__ __forceinline__ void flush(float* p, const float2& v) {
    atomicAdd(reinterpret_cast<float2*>(p), v);  // sm_90: one vector atomic
  }
};

template <>
struct Chunk<float> {
  static constexpr int kWidth = 1;
  static constexpr int kMaxLanes = 32;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float load_once(const float* p) { return __ldcs(p); }
  static __device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }
  static __device__ __forceinline__ float plus(float a, float b) { return a + b; }
  static __device__ __forceinline__ float times(float a, float m) { return a * m; }
  static __device__ __forceinline__ void add(float& a, float v, float m) { a += v * m; }
  static __device__ __forceinline__ void add(float& a, float v) { a += v; }
  static __device__ __forceinline__ void add_sq(float& a, float v) { a += v * v; }
  static __device__ __forceinline__ void mul_add(float& a, float v, float w) { a += v * w; }
  static __device__ __forceinline__ void flush(float* p, float v) { atomicAdd(p, v); }
  static __device__ __forceinline__ void divide(float* p, float c) { *p /= c; }
};

// What a launch reduces. kSum: K4 the masked sum of the gathered rows, K5
// that and the count. kMoments / kMomentsZe: K3, the moments of z = (x (+
// ze)) * mask, z written per edge. kRows: K2, the moments of the rows of
// an [E, D] array read in order, each in-range id counting 1. kMul: K6,
// the sum of the gathered rows times the edge's own row w (masked
// already), no count.
enum class Op { kSum, kMoments, kMomentsZe, kRows, kMul };

// How a group walks a tile, by op and chunk: kPer chunks per lane, lanes
// apart, up to kMaxLanes lanes (a slab: 256 columns on the float4 path),
// kIn edges in flight per lane. The moments keep two sums per chunk, so on
// the float4 path they take twice the lanes with half the chunks each, and
// K3 with ze one edge in flight (its row comes in beside the gathered one).
// K6 streams w's row beside the gathered one with two edges in flight, two
// chunks per lane (at 50 filters: 16 lanes of float2, 16 groups a block).
template <typename T, Op kOp>
struct Walk {
  static constexpr bool kMoments = kOp != Op::kSum && kOp != Op::kMul;
  static constexpr bool kWide = sizeof(T) == 16 && kMoments;
  static constexpr int kPer = kWide || kOp == Op::kMul ? 2 : 4;
  static constexpr int kMaxLanes = kWide ? 32 : Chunk<T>::kMaxLanes;
  static constexpr int kIn = kOp == Op::kMomentsZe ? 1 : 2;
};

struct GatherArgs {
  const float* x;          // node table [N, D]; K2: the rows [E, D]
  const float* edge_row;   // [E, D], a row per edge: K3's ze (Op::kMomentsZe), K6's w (Op::kMul)
  const void* mask;        // [E]: bool bytes when mask_is_bool, else f32; K2, K6: none
  int mask_is_bool;
  const int32_t* senders;  // [E]; K2: none
  const int32_t* receivers;
  float* out;              // [S, ldo], zeroed
  float* z;                // K3: [E, D]
  int64_t E;
  int N, D, S, ldo;
  int sq_off;              // the moments: column of the sum of squares
  int cnt_off;             // column of the count, or -1 for none
  int lanes, slabs, tile;  // set by launch_gather
  int sort;                // walk the tile in receiver order (the moments)
};

// One block: edges [b * tile, + tile) and the column chunks of one slab,
// kPer * lanes of them; lane l of a group owns chunks l, l + lanes, l + 2 *
// lanes, ... of the slab, so each of its loads and stores is one contiguous
// run of the row across the group. lanes is a power of two dividing
// kGatherThreads; a sorted tile's length is a power of two.
template <typename T, Op kOp>
__global__ void __launch_bounds__(kGatherThreads, kGatherBlocks) gather_reduce_kernel(
    const GatherArgs a) {
  using C = Chunk<T>;
  using W = Walk<T, kOp>;
  constexpr bool kMoments = W::kMoments;
  constexpr bool kZe = kOp == Op::kMomentsZe;
  constexpr bool kRows = kOp == Op::kRows;
  constexpr bool kMul = kOp == Op::kMul;
  constexpr bool kEdgeRow = kZe || kMul;
  constexpr int kPerLane = W::kPer;
  constexpr int kIn = W::kIn;
  const bool sort = kMoments && a.sort;
  // [tile] sort keys (when sorted), [tile] senders, [tile] receivers, [tile] mask
  extern __shared__ uint64_t s_raw[];
  uint64_t* s_key = s_raw;
  int32_t* s_snd = reinterpret_cast<int32_t*>(s_raw + (sort ? a.tile : 0));
  int32_t* s_rcv = s_snd + a.tile;
  float* s_m = reinterpret_cast<float*>(s_rcv + a.tile);

  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x / a.slabs;
  const int slab = (int)(blockIdx.x - tile * a.slabs);
  const int64_t e0 = tile * a.tile;
  const int n_tile = (int)(a.E - e0 < a.tile ? a.E - e0 : a.tile);

  // 1. stage the tile's ids (out of range: -1) and mask; to sort, the key
  //    (receiver, position), out-of-range receivers and the positions past
  //    the tile's end last
  for (int i = tid; i < (sort ? a.tile : n_tile); i += kGatherThreads) {
    const int64_t e = e0 + i;
    int32_t s = -1, r = -1;
    float m = 0.f;
    if (i < n_tile) {
      s = kRows ? -1 : __ldg(a.senders + e);
      r = __ldg(a.receivers + e);
      m = kRows || kMul ? 1.f
                : a.mask_is_bool ? (__ldg(static_cast<const uint8_t*>(a.mask) + e) ? 1.f : 0.f)
                                 : __ldg(static_cast<const float*>(a.mask) + e);
      s = (s >= 0 && s < a.N) ? s : -1;  // gathers a zero row
      r = (r >= 0 && r < a.S) ? r : -1;  // adds nothing
    }
    s_snd[i] = s;
    s_rcv[i] = r;
    s_m[i] = m;
    if (sort) s_key[i] = i < n_tile ? (uint64_t)(uint32_t)r << 32 | (uint32_t)i : ~0ull;
  }
  __syncthreads();

  // 2. to sort, a bitonic sort of the keys: the walk then meets all of a
  //    receiver's edges in the tile as one run
  if (sort) {
    for (int k = 2; k <= a.tile; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < a.tile; i += kGatherThreads) {
          const int p = i ^ j;
          if (p > i) {
            const uint64_t x = s_key[i], y = s_key[p];
            if ((x > y) == ((i & k) == 0)) {
              s_key[i] = y;
              s_key[p] = x;
            }
          }
        }
        __syncthreads();
      }
    }
  }
  // K6 runs as a programmatic dependent launch after the kernel that zeroes
  // its output: wait for that grid before the walk adds into the output
  if (kMul) asm volatile("griddepcontrol.wait;" ::: "memory");

  // 3. each group walks its consecutive edges: a row gathered for the edge
  //    before is reused while the sender repeats, and the rows add in
  //    registers while the receiver repeats, one global atomic per run and
  //    chunk (the moments: per half)
  const int lanes = a.lanes;
  const int g = tid / lanes, l = tid - g * lanes;
  const int groups = kGatherThreads / lanes;
  const int per = a.tile > groups ? a.tile / groups : 1;
  const int q0 = g * per, q1 = min(q0 + per, n_tile);
  const int chunks = a.D / C::kWidth;
  int col[kPerLane];
  bool active[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = (slab * kPerLane + k) * lanes + l;
    col[k] = c * C::kWidth;
    active[k] = c < chunks;
  }
  const bool counts = !kMul && a.cnt_off >= 0 && slab == 0 && l == 0;
  T acc[kPerLane], acc2[kPerLane], last[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) acc[k] = acc2[k] = last[k] = C::zero();
  float cnt = 0.f;
  int cur = -1, s_last = -1;
  auto flush = [&]() {
    if (cur < 0) return;
    float* row = a.out + (int64_t)cur * a.ldo;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (!active[k]) continue;
      C::flush(row + col[k], acc[k]);
      if constexpr (kMoments) C::flush(row + a.sq_off + col[k], acc2[k]);
    }
    if (counts) atomicAdd(row + a.cnt_off, cnt);
  };
  for (int q = q0; q < q1; q += kIn) {
    int32_t r[kIn];
    float m[kIn];
    int64_t e[kIn];
    T v[kIn][kPerLane], w[kIn][kPerLane];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const bool in = q + u < q1;
      int i = q + u;
      if (sort) {
        const uint64_t key = in ? s_key[i] : ~0ull;
        i = (int)(uint32_t)key;
        r[u] = (int32_t)(key >> 32);  // out of range: -1
      } else {
        r[u] = in ? s_rcv[i] : -1;
      }
      e[u] = e0 + i;
      m[u] = in ? s_m[i] : 0.f;
      if (kRows) {
        const float* xs = a.x + e[u] * a.D;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k)
          v[u][k] = active[k] && in ? C::load_once(xs + col[k]) : C::zero();
      } else {
        const int32_t s = in ? s_snd[i] : -1;
        // K6 gathers every edge's row: its rows come from L2, and the test
        // for a repeated sender cost more than it saved
        const bool fresh = kMul || s != s_last;
        const float* xs = a.x + (int64_t)s * a.D;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const T prev = u == 0 ? last[k] : v[u > 0 ? u - 1 : 0][k];
          v[u][k] = !fresh ? prev : (active[k] && s >= 0 ? C::load(xs + col[k]) : C::zero());
        }
        s_last = s;
      }
      if (kEdgeRow) {
        const float* zs = a.edge_row + e[u] * a.D;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k)
          w[u][k] = active[k] && in ? C::load_once(zs + col[k]) : C::zero();
      }
    }
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      if constexpr (kMoments) {
        if (q + u >= q1) continue;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const T z = kRows ? v[u][k] : C::times(kZe ? C::plus(v[u][k], w[u][k]) : v[u][k], m[u]);
          if (!kRows && active[k]) C::store(a.z + e[u] * a.D + col[k], z);
          w[u][k] = z;  // from here on w holds z
        }
      }
      if (r[u] < 0) continue;  // adds nothing
      if (r[u] != cur) {
        flush();
        cur = r[u];
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) acc[k] = acc2[k] = C::zero();
        cnt = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if constexpr (kMoments) {
          C::add(acc[k], w[u][k]);
          C::add_sq(acc2[k], w[u][k]);
        } else if constexpr (kMul) {
          C::mul_add(acc[k], v[u][k], w[u][k]);
        } else {
          C::add(acc[k], v[u][k], m[u]);
        }
      }
      cnt += m[u];
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) last[k] = v[kIn - 1][k];
  }
  flush();
}

// Launch `kernel` so that it may start before the kernel ahead of it on
// `stream` has ended (programmatic dependent launch): its blocks start as
// soon as every block of that kernel has run griddepcontrol.launch_dependents,
// and wait for that whole grid at griddepcontrol.wait.
template <typename Kernel>
cudaError_t launch_dependent(Kernel kernel, int64_t blocks, size_t smem, cudaStream_t stream,
                             const GatherArgs& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kGatherThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T, Op kOp>
cudaError_t launch_gather_as(GatherArgs a, cudaStream_t stream) {
  using W = Walk<T, kOp>;
  const int chunks = a.D / Chunk<T>::kWidth;
  int lanes = 1;
  while (lanes * W::kPer < chunks && lanes < W::kMaxLanes) lanes *= 2;
  const int per_slab = lanes * W::kPer;
  a.lanes = lanes;
  a.slabs = chunks > 0 ? (chunks + per_slab - 1) / per_slab : 1;  // D = 0: the count
  // the moments: on wide rows a tile sorted by receiver (the sort costs
  // more than it saves on narrow ones); on narrow rows (few lanes, many
  // groups) 4 edges per group, so that runs reduce in registers there too
  const int groups = kGatherThreads / lanes;
  a.sort = W::kMoments && lanes >= kSortLanes;
  a.tile = !W::kMoments ? kTile : a.sort ? kSortTile : min(kMaxTile, max(kTile, 4 * groups));
  const int64_t blocks = (a.E + a.tile - 1) / a.tile * a.slabs;
  const size_t smem = (size_t)a.tile * (2 * sizeof(int32_t) + sizeof(float) +
                                        (a.sort ? sizeof(uint64_t) : 0));
  if constexpr (kOp == Op::kMul)
    return launch_dependent(gather_reduce_kernel<T, kOp>, blocks, smem, stream, a);
  gather_reduce_kernel<T, kOp><<<(unsigned)blocks, kGatherThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }

// Chunks of n floats take D % n == 0, row parts n floats apart and every
// row pointer 4n-byte aligned.
inline bool fits_chunk(const GatherArgs& a, int n) {
  return a.D % n == 0 && a.D > 0 && a.ldo % n == 0 && a.sq_off % n == 0 &&
         aligned(a.x, 4 * n) && aligned(a.out, 4 * n) && (a.z == nullptr || aligned(a.z, 4 * n)) &&
         (a.edge_row == nullptr || aligned(a.edge_row, 4 * n));
}

// The float4 path where its chunks fit; K6 then float2 (its 50 filters
// make 200-byte rows); anything else runs on single floats.
template <Op kOp>
cudaError_t launch_gather(const GatherArgs& a, cudaStream_t stream) {
  if (fits_chunk(a, 4)) return launch_gather_as<float4, kOp>(a, stream);
  if constexpr (kOp == Op::kMul) {
    if (fits_chunk(a, 2)) return launch_gather_as<float2, kOp>(a, stream);
  }
  return launch_gather_as<float, kOp>(a, stream);
}

// Zero out [S, ldo] on `stream`.
inline cudaError_t zero_rows(void* out, int S, int ldo, cudaStream_t stream) {
  const size_t bytes = (size_t)S * (size_t)ldo * sizeof(float);
  return bytes > 0 ? cudaMemsetAsync(out, 0, bytes, stream) : cudaSuccess;
}

// K6's zeros: a kernel, not a memset, so that the gather kernel after it
// can be its programmatic dependent launch. Every block lets that kernel
// start at once; it waits for this grid before adding into `out`.
__global__ void zero_for_dependent_kernel(float* __restrict__ out, int64_t n) {
  asm volatile("griddepcontrol.launch_dependents;");
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = 0.f;
}

inline cudaError_t zero_for_dependent(float* out, int64_t n, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + 4 * kGatherThreads - 1) / (4 * kGatherThreads);
  zero_for_dependent_kernel<<<(unsigned)(blocks < 512 ? blocks : 512), kGatherThreads, 0, stream>>>(
      out, n);
  return cudaGetLastError();
}

// The moments (K2, K3): check the packed row's layout, zero it, launch.
template <Op kOp>
cudaError_t launch_moments(const GatherArgs& a, cudaStream_t stream) {
  if (a.D < 0 || a.E < 0 || a.N < 0 || a.S < 0 || a.sq_off < a.D ||
      a.cnt_off < a.sq_off + a.D || a.ldo <= a.cnt_off)
    return cudaErrorInvalidValue;
  const cudaError_t err = zero_rows(a.out, a.S, a.ldo, stream);
  if (err != cudaSuccess) return err;
  return a.E > 0 ? launch_gather<kOp>(a, stream) : cudaGetLastError();
}

}  // namespace hg
