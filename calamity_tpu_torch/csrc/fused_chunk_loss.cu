// Fused forward model + weighted chi-square of one dense B=1 chunk, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// calamity_tpu/ops/fused.py (launched by `_fwd_call`, pallas_call at
// fused.py:196). Per row (g, f) of a chunk with G groups, F channels and V
// basis modes:
//
//   v_r = sum_k comps[g, f, k] * coeffs2[0, g, k]
//   v_i = sum_k comps[g, f, k] * coeffs2[1, g, k]
//   m_r =  pr * v_r + pi * v_i
//   m_i = -pi * v_r + pr * v_i
//   loss += w * ((dr - m_r)^2 + (di - m_i)^2)
//
// and v is written out for the backward pass. All accumulation is float32;
// bfloat16 comps are widened on load.
//
// What bounds it: reading comps. Each comps value is used once, for two
// fused multiply-adds (about 2 flops per 4 bytes in float32, per 2 bytes in
// bfloat16), far below the tensor-core line, and the matvec has only two
// right-hand columns, so tensor cores have nothing to do. The TPU kernel
// contracted on the vector unit for the same reason.
//
// Design: one warp per (g, f) row. The 32 lanes read the row's V values
// coalesced (neighbouring lanes on neighbouring addresses), four loads in
// flight per lane before the multiply-adds, with the ragged end of the row
// masked; the group's coefficients come through the read-only cache, where
// every row of the group hits them. A butterfly shuffle reduces the two
// dot products, and lane 0 forms the model, the weighted square and writes
// v. A block of kWarps warps covers kRowsPerBlock consecutive rows and
// writes ONE partial sum; the caller sums the partials. No atomics, so the
// loss is the same from run to run. Any G, F and V are taken: nothing is
// tiled to a fixed width. TMA or cp.async pipelining and wider loads are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kLoadsInFlight = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fused_chunk_loss_fwd_kernel(const T* __restrict__ comps,
                            const float* __restrict__ coeffs2,
                            const float* __restrict__ pr,
                            const float* __restrict__ pi,
                            const float* __restrict__ dr,
                            const float* __restrict__ di,
                            const float* __restrict__ w,
                            float* __restrict__ partials,
                            float* __restrict__ v,
                            int64_t G, int64_t F, int64_t V) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t nrows = G * F;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + static_cast<int64_t>(warp) * kRowsPerWarp;

  float acc = 0.f;  // weighted squares of this warp's rows (lane 0)
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t row = row0 + r;
    if (row >= nrows) break;  // uniform across the warp
    const int64_t g = row / F;
    const T* crow = comps + row * V;
    const float* cr = coeffs2 + g * V;
    const float* ci = coeffs2 + (G + g) * V;
    float sr = 0.f;
    float si = 0.f;
    for (int64_t base = 0; base < V; base += 32 * kLoadsInFlight) {
      float c[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int64_t k = base + u * 32 + lane;
        c[u] = k < V ? to_f32(crow[k]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int64_t k = base + u * 32 + lane;
        if (k < V) {
          sr = fmaf(c[u], __ldg(cr + k), sr);
          si = fmaf(c[u], __ldg(ci + k), si);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_xor_sync(0xffffffffu, sr, off);
      si += __shfl_xor_sync(0xffffffffu, si, off);
    }
    if (lane == 0) {
      const float p_r = pr[row];
      const float p_i = pi[row];
      const float mr = p_r * sr + p_i * si;
      const float mi = -p_i * sr + p_r * si;
      const float er = dr[row] - mr;
      const float ei = di[row] - mi;
      acc += w[row] * (er * er + ei * ei);
      v[row] = sr;
      v[nrows + row] = si;
    }
  }

  __shared__ float warp_acc[kWarps];
  if (lane == 0) warp_acc[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += warp_acc[i];
    partials[blockIdx.x] = s;
  }
}

}  // namespace

extern "C" {

// Number of partial sums (one per block) the launcher writes for a chunk of
// G groups and F channels: the size of the `partials` output.
long long fcl_num_partials(long long G, long long F) {
  return (G * F + kRowsPerBlock - 1) / kRowsPerBlock;
}

const char* fcl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// comps: (G, F, V) float32 (comps_dtype 0) or bfloat16 (comps_dtype 1);
// coeffs2: (2, G, V); pr, pi, dr, di, w: (G, F); partials:
// (fcl_num_partials(G, F),); v: (2, G, F). All float32 unless stated, all
// contiguous, all on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
int fused_chunk_loss_fwd(const void* comps, int comps_dtype, const float* coeffs2,
                         const float* pr, const float* pi, const float* dr,
                         const float* di, const float* w, float* partials, float* v,
                         long long G, long long F, long long V, void* stream) {
  if (G <= 0 || F <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks = fcl_num_partials(G, F);
  if (nblocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nblocks));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (comps_dtype == 0) {
    fused_chunk_loss_fwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(comps), coeffs2, pr, pi, dr, di, w, partials, v, G, F, V);
  } else if (comps_dtype == 1) {
    fused_chunk_loss_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(comps), coeffs2, pr, pi, dr, di, w, partials, v,
        G, F, V);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
