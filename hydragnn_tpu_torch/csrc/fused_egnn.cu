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
// as on the TPU. Accumulation is f32 with FFMA; `out` must be zeroed by the
// caller. Matrices are in the x @ W layout, [H_in, H_out] row-major.
//
// What bounds it on the card: operations. Two H x H products per edge
// (4 E H^2 flops, 18.1 GFLOP at E = 69120, H = 256) against ~10 MB of
// inputs: 0.27 ms at 67 TFLOP/s of f32 FFMA, where the bytes take 3 us.
//
// Design: one block of 256 threads takes a tile of 64 edges. It builds
// relu(pre) for the tile in shared memory ([64][LD] floats, LD = H rounded
// up to 32, 2^k), then computes each H x H product as a register-tiled
// SIMT matrix product: warp w owns edges 8w..8w+7, lane l owns columns
// l, l+32, ..., so each thread keeps an 8 x (LD/32) accumulator, reads its
// edges' rows as broadcast float4 loads and the weight row as conflict-free
// scalar loads, 16 weight rows at a time staged through shared memory (the
// weights are read from L2 once per tile). e goes back into the same tile
// for the second product, and to out[sender] as coalesced atomics straight
// from the registers. The per-edge dot product with Wc1 is a warp shuffle
// reduction: a warp holds all H columns of its 8 edges. 82 KB of dynamic
// shared memory at H = 256 (two blocks per SM) needs
// cudaFuncSetAttribute; widths up to 256 are instantiated, and
// hg_fused_egnn_smem_bytes tells the wrapper what a width needs. Where the
// TPU kernel concatenated [y, pos] into one table per side, this one takes
// y_snd, y_rcv and pos as three. Tolerance against the plain version:
// 1e-4 * (max |out| + 1), covering both products' summation order and the
// atomics' order (the e columns are >= 0, so no partial sum exceeds the
// final one).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEdges = 64;     // edges per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = kEdges / (kThreads / 32);  // edges per warp
constexpr int kDepth = 16;     // weight rows staged per step

template <int CPT>  // columns per lane; LD = 32 * CPT >= H
struct Layout {
  static constexpr int kLd = 32 * CPT;
  // a tile, a weight stage, and per edge: coord_diff (3), radial, mask
  static constexpr int kFloats = kEdges * kLd + kDepth * kLd + 5 * kEdges;
  // per edge: reduce row, sender row, receiver row
  static constexpr int kInts = 3 * kEdges;
  static constexpr int kBytes = 4 * (kFloats + kInts);
};

__device__ __forceinline__ float relu(float v) {
  return v < 0.f ? 0.f : v;  // NaN passes, as in jax.nn.relu
}

// acc[i][j] = sum_{k < H} a_s[(8 warp + i) LD + k] * W[k H + lane + 32 j]
template <int CPT>
__device__ __forceinline__ void tile_product(const float* __restrict__ a_s,
                                             float* __restrict__ w_s,
                                             const float* __restrict__ W,
                                             int H, float (&acc)[kRows][CPT]) {
  constexpr int LD = Layout<CPT>::kLd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* rows = a_s + warp * kRows * LD;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kDepth) {
    for (int idx = tid; idx < kDepth * LD; idx += kThreads) {
      const int kk = idx / LD, col = idx - kk * LD, k = k0 + kk;
      w_s[idx] = (k < H && col < H) ? W[(int64_t)k * H + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 4) {
      float4 a[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(rows + i * LD + k0 + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) b[j] = w_s[(kk + q) * LD + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

template <int CPT>
__global__ void __launch_bounds__(kThreads, 2) fused_egnn_kernel(
    const float* __restrict__ y_snd, const float* __restrict__ y_rcv,
    const float* __restrict__ pos, const float* __restrict__ ze,
    const float* __restrict__ mask, const int32_t* __restrict__ senders,
    const int32_t* __restrict__ receivers, const float* __restrict__ w_rad,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ Wc0, const float* __restrict__ bc0,
    const float* __restrict__ Wc1, float* __restrict__ out, int64_t E, int N,
    int H, int S) {
  constexpr int LD = Layout<CPT>::kLd;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                 // [kEdges][LD]: relu(pre), then e
  float* w_s = a_s + kEdges * LD;    // [kDepth][LD]: staged weight rows
  float* cd_s = w_s + kDepth * LD;   // [kEdges][3]: normalised coord_diff
  float* rad_s = cd_s + 3 * kEdges;  // [kEdges]: radial
  float* m_s = rad_s + kEdges;       // [kEdges]: mask
  int* red_s = reinterpret_cast<int*>(m_s + kEdges);  // reduce row or -1
  int* sg_s = red_s + kEdges;        // sender row to gather or -1
  int* rg_s = sg_s + kEdges;         // receiver row to gather or -1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t e0 = (int64_t)blockIdx.x * kEdges;
  const bool coord = Wc0 != nullptr;
  const int64_t width = H + (coord ? 4 : 1);

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

  // 2. the tile of relu(pre), zero outside the H columns and the E edges
  for (int idx = tid; idx < kEdges * LD; idx += kThreads) {
    const int row = idx / LD, col = idx - row * LD;
    float v = 0.f;
    if (col < H && e0 + row < E) {
      const int sg = sg_s[row], rg = rg_s[row];
      v = (sg >= 0 ? y_snd[(int64_t)sg * H + col] : 0.f) +
          (rg >= 0 ? y_rcv[(int64_t)rg * H + col] : 0.f) + rad_s[row] * w_rad[col];
      if (ze != nullptr) v += ze[(e0 + row) * H + col];
      v = relu(v);
    }
    a_s[idx] = v;
  }
  __syncthreads();

  // 3. e = relu(relu(pre) @ W2 + b2) * mask: back into the tile (each warp
  // rewrites only its own edges, which only it reads), and to out[sender]
  float acc[kRows][CPT];
  tile_product<CPT>(a_s, w_s, W2, H, acc);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = warp * kRows + i;
    const float m = m_s[row];
    const int red = red_s[row];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = lane + 32 * j;
      const float v = col < H ? relu(acc[i][j] + b2[col]) * m : 0.f;
      a_s[row * LD + col] = v;
      if (red >= 0 && col < H) atomicAdd(out + red * width + col, v);
    }
  }

  if (!coord) {
    if (lane < kRows) {
      const int row = warp * kRows + lane;
      if (red_s[row] >= 0) atomicAdd(out + red_s[row] * width + H, m_s[row]);
    }
    return;
  }

  // 4. cw = tanh(relu(e @ Wc0 + bc0) . Wc1): the dot product over the H
  // columns is a shuffle reduction across the warp's lanes
  tile_product<CPT>(a_s, w_s, Wc0, H, acc);
  float p[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    p[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = lane + 32 * j;
      if (col < H) p[i] = fmaf(relu(acc[i][j] + bc0[col]), Wc1[col], p[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < kRows; ++i) p[i] += __shfl_xor_sync(0xffffffffu, p[i], off);
  if (lane < kRows) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i == lane) dot = p[i];
    const int row = warp * kRows + lane;
    const int red = red_s[row];
    if (red >= 0) {
      const float m = m_s[row];
      const float cw = tanhf(dot);
      float* dst = out + red * width + H;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float t = cd_s[row * 3 + k] * cw;
        t = t < -100.f ? -100.f : (t > 100.f ? 100.f : t);
        atomicAdd(dst + k, t * m);
      }
      atomicAdd(dst + 3, m);
    }
  }
}

int columns_per_lane(int H) {
  if (H <= 0) return 0;
  if (H <= 32) return 1;
  if (H <= 64) return 2;
  if (H <= 128) return 4;
  if (H <= 256) return 8;
  return 0;
}

template <int CPT>
int launch(const void* y_snd, const void* y_rcv, const void* pos,
           const void* ze, const void* mask, const void* senders,
           const void* receivers, const void* w_rad, const void* W2,
           const void* b2, const void* Wc0, const void* bc0, const void* Wc1,
           void* out, long long E, int N, int H, int S, void* stream) {
  const int smem = Layout<CPT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_egnn_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (E + kEdges - 1) / kEdges;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    fused_egnn_kernel<CPT><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)y_snd, (const float*)y_rcv, (const float*)pos,
        (const float*)ze, (const float*)mask, (const int32_t*)senders,
        (const int32_t*)receivers, (const float*)w_rad, (const float*)W2,
        (const float*)b2, (const float*)Wc0, (const float*)bc0,
        (const float*)Wc1, (float*)out, E, N, H, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the kernel takes at width H; -1 for a width with no
// instantiation (H outside [1, 256]).
extern "C" int hg_fused_egnn_smem_bytes(int H) {
  switch (columns_per_lane(H)) {
    case 1: return Layout<1>::kBytes;
    case 2: return Layout<2>::kBytes;
    case 4: return Layout<4>::kBytes;
    case 8: return Layout<8>::kBytes;
    default: return -1;
  }
}

// y_snd, y_rcv [N, H], pos [N, 3], ze [E, H] or null, mask [E] f32, ids [E]
// i32, w_rad [H], W2 [H, H], b2 [H], Wc0 [H, H] / bc0 [H] / Wc1 [H, 1] or
// all three null -> out [S, H + 4] (or [S, H + 1]), zeroed by the caller.
extern "C" int hg_fused_egnn_f32(const void* y_snd, const void* y_rcv,
                                 const void* pos, const void* ze,
                                 const void* mask, const void* senders,
                                 const void* receivers, const void* w_rad,
                                 const void* W2, const void* b2,
                                 const void* Wc0, const void* bc0,
                                 const void* Wc1, void* out, long long E,
                                 int N, int H, int S, void* stream) {
  if ((Wc0 == nullptr) != (bc0 == nullptr) || (Wc0 == nullptr) != (Wc1 == nullptr))
    return (int)cudaErrorInvalidValue;
#define HG_EGNN_LAUNCH(CPT)                                                     \
  return launch<CPT>(y_snd, y_rcv, pos, ze, mask, senders, receivers, w_rad, W2, \
                     b2, Wc0, bc0, Wc1, out, E, N, H, S, stream)
  switch (columns_per_lane(H)) {
    case 1: HG_EGNN_LAUNCH(1);
    case 2: HG_EGNN_LAUNCH(2);
    case 4: HG_EGNN_LAUNCH(4);
    case 8: HG_EGNN_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HG_EGNN_LAUNCH
}
