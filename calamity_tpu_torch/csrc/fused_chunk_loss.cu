// Fused forward model + weighted chi-square of one dense B=1 chunk for a
// batch of N (time, pol) slices that share the chunk's basis, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// calamity_tpu/ops/fused.py (launched by `_fwd_call`, pallas_call at
// fused.py:196), which the JAX package runs per slice and vmaps over the
// batch (parallel/batched.py:180-198). Per row (g, f) of a chunk with G
// groups, F channels and V basis modes, and per slice n:
//
//   v_r[n] = sum_k comps[g, f, k] * coeffs2[0, n, g, k]
//   v_i[n] = sum_k comps[g, f, k] * coeffs2[1, n, g, k]
//   m_r    =  pr[n] * v_r[n] + pi[n] * v_i[n]
//   m_i    = -pi[n] * v_r[n] + pr[n] * v_i[n]
//   loss[n] += w[n] * ((dr[n] - m_r)^2 + (di[n] - m_i)^2)
//
// and v is written out as (2, N, G, F) for the backward pass. All
// accumulation is float32; bfloat16 comps and bfloat16 weights are widened
// on load. The serial path calls the same kernel with N = 1.
//
// What bounds it: reading comps. Each comps value feeds 2N fused
// multiply-adds, so at N = 8 the kernel does about 8 flops per 4 bytes of
// float32 comps, still far below the tensor-core line; the matvec has only
// 2N right-hand columns. The per-slice planes (pr, pi, dr, di, w read, v
// written) are 28 bytes per row and slice, so comps dominates up to N of
// about 16 in float32.
//
// Design: one thread per (g, f) row; a block of kThreads threads covers
// kThreads consecutive channels of ONE group, so the whole block shares
// that group's coefficients.
// - Each comps value is read from device memory once for every slice of a
//   tile of up to NT (8) slices: the block stages its rows' comps in
//   shared memory kChunkK modes at a time, loaded coalesced along the
//   contiguous rows, all loads of a chunk in flight at once, and widened to
//   float32 on the way (a row is read by one thread from shared memory,
//   with an odd row stride so the reads hit distinct banks). With more slices the kernel walks the tiles, reading
//   the block's comps again (from L2 if it is still there).
// - The group's 2 * NT * V coefficients of the slice tile are staged in
//   shared memory once per block, interleaved per mode, and read as
//   broadcasts (every thread of the block reads the same address).
// - Each thread keeps its row's 2 * NT dot products in registers: no
//   reduction across lanes for the matvec. The per-slice planes are then
//   read, and v written, coalesced along the channel axis.
// - No atomics: each block writes one partial per slice, (N, nblocks),
//   summed by the caller in a fixed order, so each slice's loss is the same
//   from run to run.
// - The data and weight planes are addressed through (slice, group,
//   channel) strides, so a group block of a resident (N, G, F) cube reaches
//   the kernel as a view; a frequency-invariant weights plane may have a
//   channel stride of 0. pr and pi are contiguous (N, G, F).
// Any N, G, F and V are taken (V up to the shared memory a block can hold:
// about 3000 modes at NT = 8, more with smaller tiles). TMA or cp.async
// double buffering of the staging is left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;             // rows (channels) per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunkK = 64;               // basis modes staged per pass
constexpr int kTileStride = kChunkK + 1;  // odd: a row's reads hit distinct banks
constexpr int kTileFloats = kThreads * kTileStride;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_bytes(int tile, long long V) {
  return (static_cast<size_t>(kTileFloats) + static_cast<size_t>(2 * tile) * V) * sizeof(float);
}

template <int NT, typename TC, typename TW>
__global__ void __launch_bounds__(kThreads)
fused_chunk_loss_kernel(const TC* __restrict__ comps,
                        const float* __restrict__ coeffs2,
                        const float* __restrict__ pr,
                        const float* __restrict__ pi,
                        const float* __restrict__ dr,
                        const float* __restrict__ di,
                        int64_t d_sn, int64_t d_sg, int64_t d_sf,
                        const TW* __restrict__ w,
                        int64_t w_sn, int64_t w_sg, int64_t w_sf,
                        float* __restrict__ partials,
                        float* __restrict__ v,
                        int64_t N, int64_t G, int64_t F, int64_t V) {
  constexpr int M = 2 * NT;  // dot products per row and slice tile
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // [kThreads][kTileStride]
  float* coef = tile + kTileFloats;               // [V][M]: (re, im) of each slice
  __shared__ float red[kWarps][NT];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t ftiles = (F + kThreads - 1) / kThreads;
  const int64_t g = blockIdx.x / ftiles;
  const int64_t f0 = (blockIdx.x - g * ftiles) * kThreads;
  const int64_t f = f0 + t;
  const bool valid = f < F;
  const int rows_here = static_cast<int>(F - f0 < kThreads ? F - f0 : kThreads);
  const int64_t GF = G * F;
  const int64_t row = g * F + f;
  const TC* cblock = comps + (g * F + f0) * V;  // the block's rows are contiguous

  for (int64_t n0 = 0; n0 < N; n0 += NT) {
    const int nt = static_cast<int>(N - n0 < NT ? N - n0 : NT);
    __syncthreads();  // the previous tile's readers of coef are done
    // consecutive threads read consecutive modes of one slice's row
    for (int64_t idx = t; idx < V * M; idx += kThreads) {
      const int j = static_cast<int>(idx / V);
      const int64_t k = idx - j * V;
      const int n = j >> 1;
      coef[k * M + j] = n < nt ? coeffs2[(((j & 1) * N + n0 + n) * G + g) * V + k] : 0.f;
    }
    float s[M];
#pragma unroll
    for (int j = 0; j < M; ++j) s[j] = 0.f;
    for (int64_t k0 = 0; k0 < V; k0 += kChunkK) {
      const int kc = static_cast<int>(V - k0 < kChunkK ? V - k0 : kChunkK);
      __syncthreads();  // coef staged; the previous chunk's readers are done
      // stage rows_here x kc values: every load of the chunk is issued
      // before the first store, so a block keeps its whole chunk in flight;
      // a warp reads 32 consecutive modes of one row (contiguous addresses)
      if (sizeof(TC) == 2 && V % 2 == 0) {
        // bfloat16 rows of even length start on 4-byte boundaries (and kc
        // is even): each thread loads pairs of modes
        constexpr int kPairs = kChunkK / 2;
        constexpr int kPerThread = kThreads * kPairs / kThreads;
        constexpr int kRowStep = kThreads / kPairs;
        const int kk = 2 * (t % kPairs);
        __nv_bfloat162 vals[kPerThread];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          const int r = t / kPairs + i * kRowStep;
          vals[i] = (r < rows_here && kk < kc)
                        ? *reinterpret_cast<const __nv_bfloat162*>(
                              cblock + static_cast<int64_t>(r) * V + k0 + kk)
                        : __floats2bfloat162_rn(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          float* dst = tile + (t / kPairs + i * kRowStep) * kTileStride + kk;
          dst[0] = __low2float(vals[i]);
          dst[1] = __high2float(vals[i]);
        }
      } else {
        constexpr int kPerThread = kThreads * kChunkK / kThreads;
        constexpr int kRowStep = kThreads / kChunkK;
        const int kk = t % kChunkK;
        float vals[kPerThread];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          const int r = t / kChunkK + i * kRowStep;
          vals[i] = (r < rows_here && kk < kc)
                        ? to_f32(cblock[static_cast<int64_t>(r) * V + k0 + kk]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) {
          tile[(t / kChunkK + i * kRowStep) * kTileStride + kk] = vals[i];
        }
      }
      __syncthreads();
      if (valid) {
        const float* trow = tile + t * kTileStride;
        const float* cf = coef + k0 * M;
        for (int kk = 0; kk < kc; ++kk) {
          const float c = trow[kk];
          if constexpr (M % 4 == 0) {
            const float4* c4 = reinterpret_cast<const float4*>(cf + kk * M);
#pragma unroll
            for (int q = 0; q < M / 4; ++q) {
              const float4 x = c4[q];
              s[4 * q] = fmaf(c, x.x, s[4 * q]);
              s[4 * q + 1] = fmaf(c, x.y, s[4 * q + 1]);
              s[4 * q + 2] = fmaf(c, x.z, s[4 * q + 2]);
              s[4 * q + 3] = fmaf(c, x.w, s[4 * q + 3]);
            }
          } else {
            const float2 x = reinterpret_cast<const float2*>(cf + kk * M)[0];
            s[0] = fmaf(c, x.x, s[0]);
            s[1] = fmaf(c, x.y, s[1]);
          }
        }
      }
    }
    float acc[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n] = 0.f;
      if (valid && n < nt) {
        const int64_t nn = n0 + n;
        const int64_t prow = nn * GF + row;
        const float sr = s[2 * n];
        const float si = s[2 * n + 1];
        const float p_r = pr[prow];
        const float p_i = pi[prow];
        const float mr = p_r * sr + p_i * si;
        const float mi = -p_i * sr + p_r * si;
        const int64_t drow = nn * d_sn + g * d_sg + f * d_sf;
        const float er = dr[drow] - mr;
        const float ei = di[drow] - mi;
        acc[n] = to_f32(w[nn * w_sn + g * w_sg + f * w_sf]) * (er * er + ei * ei);
        v[prow] = sr;
        v[N * GF + prow] = si;
      }
    }
    // per-slice block sums: a butterfly per warp, then across warps
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[n] += __shfl_xor_sync(kFull, acc[n], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n) red[warp][n] = acc[n];
    }
    __syncthreads();
    if (t < nt) {
      float sum = 0.f;
      for (int i = 0; i < kWarps; ++i) sum += red[i][t];
      partials[(n0 + t) * gridDim.x + blockIdx.x] = sum;
    }
  }
}

template <int NT, typename TC, typename TW>
int launch(dim3 grid, cudaStream_t s, const void* comps, const float* coeffs2,
           const float* pr, const float* pi, const float* dr, const float* di, int64_t d_sn,
           int64_t d_sg, int64_t d_sf, const void* w, int64_t w_sn, int64_t w_sg,
           int64_t w_sf, float* partials, float* v, int64_t N, int64_t G, int64_t F,
           int64_t V) {
  const size_t bytes = smem_bytes(NT, V);
  auto kernel = fused_chunk_loss_kernel<NT, TC, TW>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const TC*>(comps), coeffs2, pr, pi, dr, di,
                                       d_sn, d_sg, d_sf, static_cast<const TW*>(w), w_sn,
                                       w_sg, w_sf, partials, v, N, G, F, V);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, typename TW>
int launch_tile(int tile, dim3 grid, cudaStream_t s, const void* comps, const float* coeffs2,
                const float* pr, const float* pi, const float* dr, const float* di,
                int64_t d_sn, int64_t d_sg, int64_t d_sf, const void* w, int64_t w_sn,
                int64_t w_sg, int64_t w_sf, float* partials, float* v, int64_t N, int64_t G,
                int64_t F, int64_t V) {
  switch (tile) {
    case 1:
      return launch<1, TC, TW>(grid, s, comps, coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w,
                               w_sn, w_sg, w_sf, partials, v, N, G, F, V);
    case 2:
      return launch<2, TC, TW>(grid, s, comps, coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w,
                               w_sn, w_sg, w_sf, partials, v, N, G, F, V);
    case 4:
      return launch<4, TC, TW>(grid, s, comps, coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w,
                               w_sn, w_sg, w_sf, partials, v, N, G, F, V);
    default:
      return launch<8, TC, TW>(grid, s, comps, coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w,
                               w_sn, w_sg, w_sf, partials, v, N, G, F, V);
  }
}

}  // namespace

extern "C" {

// Number of partial sums per slice (one per block) the launcher writes for
// a chunk of G groups and F channels: `partials` is (N, fcl_num_partials).
long long fcl_num_partials(long long G, long long F) {
  return G * ((F + kThreads - 1) / kThreads);
}

const char* fcl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// comps: (G, F, V) contiguous, float32 (comps_dtype 0) or bfloat16 (1);
// coeffs2: (2, N, G, V) contiguous float32; pr, pi: (N, G, F) contiguous
// float32; dr, di: float32 at dr[n * d_sn + g * d_sg + f * d_sf]; w:
// float32 (w_dtype 0) or bfloat16 (1) at w[n * w_sn + g * w_sg + f * w_sf]
// (strides in elements); partials: (N, fcl_num_partials(G, F)); v:
// (2, N, G, F) contiguous. All on the current device. Launches on `stream`
// and returns the launch's CUDA error (0 on success); it does not
// synchronise.
int fused_chunk_loss_fwd(const void* comps, int comps_dtype, const float* coeffs2,
                         const float* pr, const float* pi, const float* dr,
                         const float* di, long long d_sn, long long d_sg, long long d_sf,
                         const void* w, int w_dtype, long long w_sn, long long w_sg,
                         long long w_sf, float* partials, float* v, long long N, long long G,
                         long long F, long long V, void* stream) {
  if (N <= 0 || G <= 0 || F <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = fcl_num_partials(G, F);
  if (nblocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // slices per tile: the least power of two >= N, at most 8, and smaller
  // when the tile's coefficients would not fit in shared memory
  int tile = N > 4 ? 8 : N > 2 ? 4 : static_cast<int>(N);
  while (tile > 1 && smem_bytes(tile, V) > kMaxSmem) tile /= 2;
  if (smem_bytes(tile, V) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nblocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (comps_dtype == 0 && w_dtype == 0) {
    return launch_tile<float, float>(tile, grid, s, comps, coeffs2, pr, pi, dr, di, d_sn, d_sg,
                                     d_sf, w, w_sn, w_sg, w_sf, partials, v, N, G, F, V);
  }
  if (comps_dtype == 1 && w_dtype == 0) {
    return launch_tile<__nv_bfloat16, float>(tile, grid, s, comps, coeffs2, pr, pi, dr, di,
                                             d_sn, d_sg, d_sf, w, w_sn, w_sg, w_sf, partials,
                                             v, N, G, F, V);
  }
  if (comps_dtype == 0 && w_dtype == 1) {
    return launch_tile<float, __nv_bfloat16>(tile, grid, s, comps, coeffs2, pr, pi, dr, di,
                                             d_sn, d_sg, d_sf, w, w_sn, w_sg, w_sf, partials,
                                             v, N, G, F, V);
  }
  if (comps_dtype == 1 && w_dtype == 1) {
    return launch_tile<__nv_bfloat16, __nv_bfloat16>(tile, grid, s, comps, coeffs2, pr, pi, dr,
                                                     di, d_sn, d_sg, d_sf, w, w_sn, w_sg, w_sf,
                                                     partials, v, N, G, F, V);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
