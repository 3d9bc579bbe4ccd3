// EGNN's edge phase in one kernel: gather, edge MLP, coordinate weight and
// the sender-side reduction.
//
// Replaces the TPU kernel of hydragnn_tpu/ops/fused_mp.py,
// fused_message_reduce (_fused_impl, its pallas_call at fused_mp.py:322) with
// the "egnn" edge op (_op_egnn, :97-149; wrapper fused_egnn_edge_phase,
// :520-544). For every edge e = s -> r, gathering a zero row where s or r is
// outside the node table [0, N):
//
//   coord_diff = pos[s] - pos[r];  radial = |coord_diff|^2
//   coord_diff = coord_diff / (safe_sqrt(radial) + 1)   (0 distance -> 0)
//   pre  = y_snd[s] + y_rcv[r] + radial * w_rad (+ ze[e])
//   e    = relu(relu(pre) @ W2 + b2) * mask[e]
//   with the coordinate parameters (Wc0 != null):
//     cw    = tanh(relu(e @ Wc0 + bc0) @ Wc1)
//     trans = clip(coord_diff * cw, -100, 100) * mask[e]
//     out[s] += [e (H) | trans (3) | mask (1)]
//   without them:
//     out[s] += [e (H) | mask (1)]
//
// reduced at the SENDER, and only where s is inside [0, S). Padded edges
// have in-range ids; their messages are zeroed by the mask, bias and all,
// as on the TPU. Accumulation is f32 with FFMA (no TF32). The entry zeroes
// `out` itself on the caller's stream; its rows are `ldo` floats apart
// (ldo >= the message width; a multiple of 4 lets the atomics go 16 bytes at
// a time). Matrices are in the x @ W layout, [H_in, H_out] row-major.
//
// What bounds it on the card: operations. Two H x H products per edge
// (4 E H^2 flops, 18.1 GFLOP at E = 69120, H = 256) against ~10 MB of
// inputs: 0.27 ms at 67 TFLOP/s of f32 FFMA, where the bytes take 3 us. So
// the design is that of a SIMT matrix product fed so that the FFMA pipe
// never waits: on shared-memory loads, on the weights' trip from L2, or on
// an idle SM.
//
// Design. A block of 256 threads (8 warps: 2 along the edges, 4 along the
// columns) takes tiles of kEdges = 64 edges and walks them (a persistent
// grid, as many blocks as fit on the card at once). Per tile:
//   1. per-edge ids, geometry and mask into shared memory;
//   2. relu(pre) into a k-major tile As[H][kEdges + 4] (the pad spreads
//      the transposing stores over all banks); the gather reads 32 bytes
//      of a node row per pair of lanes;
//   3. e = relu(relu(pre) @ W2 + b2) * mask as a register-tiled product:
//      thread (tr, tc) keeps an 8-edge x (H/32)-column accumulator; per k
//      it reads its 8 edges as two float4 broadcasts from As and its
//      columns as float4s from the weight stage (columns 4 tc .. 4 tc + 3
//      and H/2 + 4 tc ..: a warp's loads are 128 contiguous bytes, no bank
//      conflict), so 4 shared loads feed 64 FFMAs;
//   4. the weights stream through a ring of kStages stages of kDepth rows
//      (2 x 16 rows, 32 KB), filled by cp.async kStages - 1 stages ahead,
//      with one barrier per stage; the stream runs on across the two
//      products and across tiles, so the next tile's first rows are in
//      flight during this tile's epilogue;
//   5. e goes back into As (for the coordinate product) and to out[sender]
//      through 16-byte vector atomics (sm_90), one per run of equal
//      senders among a thread's 8 consecutive edges;
//   6. with the coordinate parameters, the second product the same way,
//      then relu(. + bc0) . Wc1 is summed across a warp's lanes by
//      shuffles and across the four column warps in shared memory, and
//      [trans | mask] goes out as one vector atomic per edge.
// At H = 256: 103 KB of dynamic shared memory and at most 128 registers
// (no spills), two blocks per SM. The tile, the ring (2 stages of 16 rows)
// and the persistent grid were chosen by timing compile-time variants on
// the H100 (PERF.md): deeper or longer rings, 128-edge tiles and one block
// per SM were all slower. Timed with parts of the work dropped, the weight
// stream costs about a fifth of the kernel: every 64-edge tile reads both
// matrices from L2 again. Sharing a stage between the blocks of a cluster
// (TMA multicast) is the next step.
// Widths up to 256 are instantiated (the padded width NC = 32, 64, 128
// or 256); hg_fused_egnn_smem_bytes tells the wrapper what a width needs.
// A width that is not a multiple of 4, or a pointer that is not 16-byte
// aligned, takes the same kernel with 4-byte copies, loads and atomics.
// Where the TPU kernel concatenated [y, pos] into one table per side, this
// one takes y_snd, y_rcv and pos as three.
// Tolerance against the plain version: 1e-4 * (max |out| + 1), covering
// both products' summation order and the atomics' order (the e columns
// are >= 0, so no partial sum exceeds the final one).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kWarpRows = 2;  // warps along the edges
constexpr int kWarpCols = 4;  // warps along the columns
constexpr int kThreads = 32 * kWarpRows * kWarpCols;
constexpr int kRowsPerThread = 8;                           // edges per thread
constexpr int kEdges = 4 * kWarpRows * kRowsPerThread;      // edges per tile
constexpr int kLda = kEdges + 4;  // As row: kLda % 32 == 4 spreads the banks
constexpr int kDepth = 16;        // weight rows per stage
constexpr int kStages = 2;        // stages in the ring
constexpr int kMinBlocks = 2;     // blocks per SM: caps registers at 128
static_assert(kStages >= 2 && kDepth % 4 == 0, "a ring of >= 2 stages of 4k rows");

template <int NC>  // padded width: 32, 64, 128 or 256 columns
struct Layout {
  static constexpr int kCols = NC / 32;  // columns per thread
  static constexpr int kStage = kDepth * NC;
  // rows of As: the products run over whole stages, so NC rounded up to
  // kDepth (the rows past NC stay zero)
  static constexpr int kARows = (NC + kDepth - 1) / kDepth * kDepth;
  // As, the weight ring, and per edge: coord_diff (3), radial, mask, and
  // one partial dot product per column warp
  static constexpr int kFloats = kARows * kLda + kStages * kStage + (5 + kWarpCols) * kEdges;
  // per edge: reduce row, sender row, receiver row
  static constexpr int kInts = 3 * kEdges;
  static constexpr int kBytes = 4 * (kFloats + kInts);
};

__device__ __forceinline__ float relu(float v) {
  return v < 0.f ? 0.f : v;  // NaN passes, as in jax.nn.relu
}

// The thread's j-th column: two float4 groups half the width apart (8
// columns), or a contiguous run (fewer).
template <int NC>
__device__ __forceinline__ int col_of(int tc, int j) {
  constexpr int TN = Layout<NC>::kCols;
  if constexpr (TN == 8) return (j >> 2) * (NC / 2) + 4 * tc + (j & 3);
  return TN * tc + j;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid, bool vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [k0, k0 + kDepth) of W [H, H] into a stage [kDepth][NC], zeros
// outside the H x H matrix (cp.async's zero fill).
template <int NC>
__device__ __forceinline__ void load_stage(float* __restrict__ dst, const float* __restrict__ W,
                                           int k0, int H, bool vec) {
  if (vec) {
    constexpr int kQuads = kDepth * NC / 4;
    for (int q = threadIdx.x; q < kQuads; q += kThreads) {
      const int kk = q / (NC / 4), col = 4 * (q - kk * (NC / 4)), k = k0 + kk;
      const bool valid = k < H && col < H;
      cp_async(dst + kk * NC + col, valid ? W + (int64_t)k * H + col : W, valid, true);
    }
  } else {
    for (int q = threadIdx.x; q < kDepth * NC; q += kThreads) {
      const int kk = q / NC, col = q - kk * NC, k = k0 + kk;
      const bool valid = k < H && col < H;
      cp_async(dst + q, valid ? W + (int64_t)k * H + col : W, valid, false);
    }
  }
}

// acc[i][j] += sum over the stage's rows of As[k0 + kk][8 tr + i] * Wst[kk][col_of(tc, j)]
template <int NC>
__device__ __forceinline__ void stage_product(const float* __restrict__ As,
                                              const float* __restrict__ Wst, int k0, int tr,
                                              int tc, float (&acc)[kRowsPerThread][NC / 32]) {
  constexpr int TN = Layout<NC>::kCols;
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    const float* arow = As + (k0 + kk) * kLda + kRowsPerThread * tr;
    const float4 a0 = *reinterpret_cast<const float4*>(arow);
    const float4 a1 = *reinterpret_cast<const float4*>(arow + 4);
    const float a[kRowsPerThread] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[TN];
    const float* wrow = Wst + kk * NC;
    if constexpr (TN >= 4) {
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + col_of<NC>(tc, 4 * q));
        b[4 * q] = w.x; b[4 * q + 1] = w.y; b[4 * q + 2] = w.z; b[4 * q + 3] = w.w;
      }
    } else if constexpr (TN == 2) {
      const float2 w = *reinterpret_cast<const float2*>(wrow + col_of<NC>(tc, 0));
      b[0] = w.x; b[1] = w.y;
    } else {
      b[0] = wrow[col_of<NC>(tc, 0)];
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[row][cols of the thread] += run, as 16-byte atomics where they fit
template <int NC>
__device__ __forceinline__ void flush_run(float* __restrict__ out, int row, int ldo, int H,
                                          int tc, const float (&run)[NC / 32], bool vec) {
  constexpr int TN = Layout<NC>::kCols;
  if (row < 0) return;
  float* dst = out + (int64_t)row * ldo;
  if constexpr (TN >= 4) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int col = col_of<NC>(tc, 4 * q);
        if (col < H)
          atomicAdd(reinterpret_cast<float4*>(dst + col),
                    make_float4(run[4 * q], run[4 * q + 1], run[4 * q + 2], run[4 * q + 3]));
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = col_of<NC>(tc, j);
    if (col < H) atomicAdd(dst + col, run[j]);
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_egnn_kernel(
    const float* __restrict__ y_snd, const float* __restrict__ y_rcv,
    const float* __restrict__ pos, const float* __restrict__ ze,
    const float* __restrict__ mask, const int32_t* __restrict__ senders,
    const int32_t* __restrict__ receivers, const float* __restrict__ w_rad,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ Wc0, const float* __restrict__ bc0,
    const float* __restrict__ Wc1, float* __restrict__ out, int64_t E, int N,
    int H, int S, int ldo, int tiles, int vec_flag) {
  using L = Layout<NC>;
  constexpr int TN = L::kCols;
  constexpr int kWarps = kThreads / 32;
  constexpr int kGatherItems = (kEdges / 16) * (NC / 8);  // 16 edges x 2 quads each
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                           // [NC][kLda]: relu(pre), then e
  float* ring = As + L::kARows * kLda;        // [kStages][kDepth][NC]: weight rows
  float* cd_s = ring + kStages * L::kStage;   // [kEdges][3]: normalised coord_diff
  float* rad_s = cd_s + 3 * kEdges;           // [kEdges]: radial
  float* m_s = rad_s + kEdges;                // [kEdges]: mask
  float* dot_s = m_s + kEdges;                // [kWarpCols][kEdges]: partial e . Wc1
  int* red_s = reinterpret_cast<int*>(dot_s + kWarpCols * kEdges);  // reduce row or -1
  int* sg_s = red_s + kEdges;                 // sender row to gather or -1
  int* rg_s = sg_s + kEdges;                  // receiver row to gather or -1

  const bool vec = vec_flag != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wc = warp % kWarpCols, lc = lane & 7;
  const int tr = (warp / kWarpCols) * 4 + (lane >> 3);  // edges 8 tr .. 8 tr + 7
  const int tc = wc * 8 + lc;                           // columns col_of(tc, j)
  const int row0 = kRowsPerThread * tr;
  const bool coord = Wc0 != nullptr;
  const int nK = (H + kDepth - 1) / kDepth;  // stages per product
  const int per_tile = coord ? 2 * nK : nK;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * per_tile;  // stages this block consumes

  // the weight stream: stage g is rows ((g % per_tile) % nK) * kDepth.. of
  // W2 (first nK of a tile) or Wc0, into ring slot g % kStages
  int next = 0;
  auto fetch_next = [&]() {
    if (next < total) {
      const int s = next % per_tile;
      load_stage<NC>(ring + (next % kStages) * L::kStage, s < nK ? W2 : Wc0,
                     (s % nK) * kDepth, H, vec);
      ++next;
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
  for (int p = 0; p < kStages - 1; ++p) fetch_next();
  for (int i = tid; i < (L::kARows - NC) * kLda; i += kThreads) As[NC * kLda + i] = 0.f;
  int g = 0;  // the next stage to consume
  float acc[kRowsPerThread][TN];
  auto product = [&]() {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < nK; ++s, ++g) {
      cp_async_wait<kStages - 2>();  // stage g has landed (for this thread)
      __syncthreads();               // ... for all; and slot (g - 1) % kStages is free
      fetch_next();
      stage_product<NC>(As, ring + (g % kStages) * L::kStage, s * kDepth, tr, tc, acc);
    }
  };

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t e0 = (int64_t)t * kEdges;
    __syncthreads();  // the last tile's epilogue is done with the per-edge arrays

    // 1. per-edge geometry and ids
    if (tid < kEdges) {
      const int64_t e = e0 + tid;
      int sg = -1, rg = -1, red = -1;
      float m = 0.f, rad = 0.f, c[3] = {0.f, 0.f, 0.f};
      if (e < E) {
        const int32_t s = senders[e], r = receivers[e];
        sg = (s >= 0 && s < N) ? s : -1;
        rg = (r >= 0 && r < N) ? r : -1;
        red = (s >= 0 && s < S) ? s : -1;
        m = mask[e];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float ps = sg >= 0 ? pos[(int64_t)sg * 3 + k] : 0.f;
          const float pr = rg >= 0 ? pos[(int64_t)rg * 3 + k] : 0.f;
          c[k] = ps - pr;
        }
        rad = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
        const float norm = rad > 0.f ? sqrtf(rad) : 0.f;  // the safe sqrt
#pragma unroll
        for (int k = 0; k < 3; ++k) c[k] = c[k] / (norm + 1.f);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) cd_s[tid * 3 + k] = c[k];
      rad_s[tid] = rad;
      m_s[tid] = m;
      red_s[tid] = red;
      sg_s[tid] = sg;
      rg_s[tid] = rg;
    }
    __syncthreads();

    // 2. As[col][edge] = relu(pre), zero outside the H columns and E edges.
    // A warp takes 16 edges x 2 column quads: lane -> (edge lane & 15, quad
    // lane >> 4), so two lanes read 32 contiguous bytes of a node row and
    // the transposing stores hit 32 distinct banks.
    for (int item = warp; item < kGatherItems; item += kWarps) {
      const int el = (item % (kEdges / 16)) * 16 + (lane & 15);
      const int col = 4 * (2 * (item / (kEdges / 16)) + (lane >> 4));
      const int sg = sg_s[el], rg = rg_s[el];
      const float rad = rad_s[el];
      const int64_t e = e0 + el;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (e < E) {
        if (vec) {
          if (col < H) {
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, z = a;
            if (sg >= 0) a = *reinterpret_cast<const float4*>(y_snd + (int64_t)sg * H + col);
            if (rg >= 0) b = *reinterpret_cast<const float4*>(y_rcv + (int64_t)rg * H + col);
            if (ze != nullptr) z = *reinterpret_cast<const float4*>(ze + e * H + col);
            const float4 w = *reinterpret_cast<const float4*>(w_rad + col);
            v[0] = relu(a.x + b.x + rad * w.x + z.x);
            v[1] = relu(a.y + b.y + rad * w.y + z.y);
            v[2] = relu(a.z + b.z + rad * w.z + z.z);
            v[3] = relu(a.w + b.w + rad * w.w + z.w);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = col + i;
            if (c < H) {
              float p = (sg >= 0 ? y_snd[(int64_t)sg * H + c] : 0.f) +
                        (rg >= 0 ? y_rcv[(int64_t)rg * H + c] : 0.f) + rad * w_rad[c];
              if (ze != nullptr) p += ze[e * H + c];
              v[i] = relu(p);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) As[(col + i) * kLda + el] = v[i];
    }

    // 3. e = relu(relu(pre) @ W2 + b2) * mask
    product();
    __syncthreads();  // every warp is done reading relu(pre) from As

    // 5. e back into As, and to out[sender], one atomic per run of equal
    // senders among the thread's 8 consecutive edges
    {
      float bias[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col_of<NC>(tc, j);
        bias[j] = col < H ? b2[col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float m = m_s[row0 + i];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = col_of<NC>(tc, j) < H ? relu(acc[i][j] + bias[j]) * m : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float* dst = As + col_of<NC>(tc, j) * kLda + row0;
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
      }
      int cur = red_s[row0];
      float run[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) run[j] = acc[0][j];
#pragma unroll
      for (int i = 1; i < kRowsPerThread; ++i) {
        const int red = red_s[row0 + i];
        if (red != cur) {
          flush_run<NC>(out, cur, ldo, H, tc, run, vec);
          cur = red;
#pragma unroll
          for (int j = 0; j < TN; ++j) run[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) run[j] += acc[i][j];
      }
      flush_run<NC>(out, cur, ldo, H, tc, run, vec);
    }

    if (!coord) {
      if (tc == 0) {  // the mask column: one thread per 8 edges
        int cur = -1;
        float msum = 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int red = red_s[row0 + i];
          if (red != cur) {
            if (cur >= 0) atomicAdd(out + (int64_t)cur * ldo + H, msum);
            cur = red;
            msum = 0.f;
          }
          msum += m_s[row0 + i];
        }
        if (cur >= 0) atomicAdd(out + (int64_t)cur * ldo + H, msum);
      }
      continue;
    }

    // 6. cw = tanh(relu(e @ Wc0 + bc0) . Wc1): the dot product is summed
    // across the 8 lanes that share the thread's edges by shuffles, then
    // across the column warps in shared memory
    product();
    {
      float p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) p[i] = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col_of<NC>(tc, j);
        if (col < H) {
          const float bias = bc0[col], w = Wc1[col];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) p[i] = fmaf(relu(acc[i][j] + bias), w, p[i]);
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) p[i] += __shfl_xor_sync(0xffffffffu, p[i], off);
      if (lc == 0) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) dot_s[wc * kEdges + row0 + i] = p[i];
      }
    }
    __syncthreads();
    if (tid < kEdges) {
      const int red = red_s[tid];
      if (red >= 0) {
        float dot = 0.f;
#pragma unroll
        for (int w = 0; w < kWarpCols; ++w) dot += dot_s[w * kEdges + tid];
        const float m = m_s[tid];
        const float cw = tanhf(dot);
        float t[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float v = cd_s[tid * 3 + k] * cw;
          t[k] = (v < -100.f ? -100.f : (v > 100.f ? 100.f : v)) * m;
        }
        float* dst = out + (int64_t)red * ldo + H;
        if (vec) {
          atomicAdd(reinterpret_cast<float4*>(dst), make_float4(t[0], t[1], t[2], m));
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) atomicAdd(dst + k, t[k]);
          atomicAdd(dst + 3, m);
        }
      }
    }
  }
  cp_async_wait<0>();
}

int padded_width(int H) {
  if (H <= 0) return 0;
  if (H <= 32) return 32;
  if (H <= 64) return 64;
  if (H <= 128) return 128;
  if (H <= 256) return 256;
  return 0;
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <int NC>
int launch(const void* y_snd, const void* y_rcv, const void* pos, const void* ze,
           const void* mask, const void* senders, const void* receivers,
           const void* w_rad, const void* W2, const void* b2, const void* Wc0,
           const void* bc0, const void* Wc1, void* out, long long E, int N, int H,
           int S, int ldo, cudaStream_t stream) {
  constexpr int smem = Layout<NC>::kBytes;
  // once per device: the shared-memory opt-in and how many blocks fit on
  // the card at once, the persistent grid
  static int resident[hg::kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= hg::kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(fused_egnn_kernel<NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_egnn_kernel<NC>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int sms = hg::sm_count(dev);
    if (n <= 0 || sms <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = n * sms;
  }
  const long long tiles = (E + kEdges - 1) / kEdges;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaGetLastError();
  const long long grid = tiles < resident[dev] ? tiles : resident[dev];
  const bool vec = H % 4 == 0 && ldo % 4 == 0 && aligned16(y_snd) && aligned16(y_rcv) &&
                   aligned16(ze) && aligned16(w_rad) && aligned16(W2) && aligned16(Wc0) &&
                   aligned16(out);
  fused_egnn_kernel<NC><<<(unsigned)grid, kThreads, smem, stream>>>(
      (const float*)y_snd, (const float*)y_rcv, (const float*)pos, (const float*)ze,
      (const float*)mask, (const int32_t*)senders, (const int32_t*)receivers,
      (const float*)w_rad, (const float*)W2, (const float*)b2, (const float*)Wc0,
      (const float*)bc0, (const float*)Wc1, (float*)out, E, N, H, S, ldo, (int)tiles,
      vec ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel takes at width H; -1 for a width with no
// instantiation (H outside [1, 256]).
extern "C" int hg_fused_egnn_smem_bytes(int H) {
  switch (padded_width(H)) {
    case 32: return Layout<32>::kBytes;
    case 64: return Layout<64>::kBytes;
    case 128: return Layout<128>::kBytes;
    case 256: return Layout<256>::kBytes;
    default: return -1;
  }
}

// y_snd, y_rcv [N, H], pos [N, 3], ze [E, H] or null, mask [E] f32, ids [E]
// i32, w_rad [H], W2 [H, H], b2 [H], Wc0 [H, H] / bc0 [H] / Wc1 [H, 1] or
// all three null -> out [S, ldo], zeroed here on `stream`; the message is
// its first H + 4 (or H + 1) columns.
extern "C" int hg_fused_egnn_f32(const void* y_snd, const void* y_rcv,
                                 const void* pos, const void* ze,
                                 const void* mask, const void* senders,
                                 const void* receivers, const void* w_rad,
                                 const void* W2, const void* b2,
                                 const void* Wc0, const void* bc0,
                                 const void* Wc1, void* out, long long E,
                                 int N, int H, int S, int ldo, void* stream) {
  if ((Wc0 == nullptr) != (bc0 == nullptr) || (Wc0 == nullptr) != (Wc1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ldo < H + (Wc0 != nullptr ? 4 : 1)) return (int)cudaErrorInvalidValue;
  const int NC = padded_width(H);
  if (NC == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t out_bytes = (size_t)S * (size_t)ldo * sizeof(float);
  if (out_bytes > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, st);
    if (err != cudaSuccess) return (int)err;
  }
#define HG_EGNN_LAUNCH(W)                                                              \
  return launch<W>(y_snd, y_rcv, pos, ze, mask, senders, receivers, w_rad, W2, b2, Wc0, \
                   bc0, Wc1, out, E, N, H, S, ldo, st)
  switch (NC) {
    case 32: HG_EGNN_LAUNCH(32);
    case 64: HG_EGNN_LAUNCH(64);
    case 128: HG_EGNN_LAUNCH(128);
    default: HG_EGNN_LAUNCH(256);
  }
#undef HG_EGNN_LAUNCH
}
