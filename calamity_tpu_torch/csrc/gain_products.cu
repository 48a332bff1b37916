// The gain products of every baseline row, in one launch, for Hopper
// (sm_90a).
//
// What it replaces: the reference's `gain_products`
// (calamity_tpu/ops/loss.py:183-196), four gathers of the antenna gains by
// index (jnp.take) and the products
//
//   pr = gr0 gr1 + gi0 gi1,   pi = gr0 gi1 - gi0 gr1
//
// (Re and -Im of g_i conj(g_j)), which XLA fuses. The port's torch ops
// launch 4 index_select and 6 elementwise kernels a chunk for them, and
// write and read each gathered cube.
//
// What bounds it: bytes. It must write pr and pi (2 x nbatch x rows x F
// values) and read the gains and the two index lists once; the gathered
// gains are never written. The arithmetic is 6 operations per value.
//
// The design: one block of 128 threads per (4 rows, channel tile, slice);
// each thread owns VEC consecutive channels (16-byte loads and stores,
// float4 or double2, where the channel count and the pointers allow; else
// one channel). A block reads its rows' antenna indices once; the gains'
// rows are read from L2 (a slice's gains are 2 x nants x F values). The
// four rows' loads are started before any product. Every product, sum and
// difference is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn; no
// fused multiply-add), in the torch ops' order, so the output equals theirs
// to the bit.
//
// C interface (loaded with ctypes): gain_products(...) returns the CUDA
// error of the launch (0 on success); it launches on the given stream and
// does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // rows a block

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gain_products_kernel(const T* __restrict__ g_r, const T* __restrict__ g_i,
                     const int* __restrict__ a0, const int* __restrict__ a1,
                     T* __restrict__ pr, T* __restrict__ pi, int64_t rows, int64_t nants,
                     int64_t nfreqs) {
  using V = Vec<T, VEC>;
  const int64_t f = (static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x) * VEC;
  if (f >= nfreqs) return;
  const int64_t n = blockIdx.z;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int nrows = rows - r0 < kRows ? static_cast<int>(rows - r0) : kRows;
  const T* gr_n = g_r + n * nants * nfreqs + f;
  const T* gi_n = g_i + n * nants * nfreqs + f;
  V gr0[kRows], gr1[kRows], gi0[kRows], gi1[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k < nrows) {
      const int64_t i = a0[r0 + k];
      const int64_t j = a1[r0 + k];
      gr0[k] = *reinterpret_cast<const V*>(gr_n + i * nfreqs);
      gr1[k] = *reinterpret_cast<const V*>(gr_n + j * nfreqs);
      gi0[k] = *reinterpret_cast<const V*>(gi_n + i * nfreqs);
      gi1[k] = *reinterpret_cast<const V*>(gi_n + j * nfreqs);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k < nrows) {
      V out_r, out_i;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        out_r.v[c] = add_rn(mul_rn(gr0[k].v[c], gr1[k].v[c]), mul_rn(gi0[k].v[c], gi1[k].v[c]));
        out_i.v[c] = sub_rn(mul_rn(gr0[k].v[c], gi1[k].v[c]), mul_rn(gi0[k].v[c], gr1[k].v[c]));
      }
      const int64_t out = (n * rows + r0 + k) * nfreqs + f;
      *reinterpret_cast<V*>(pr + out) = out_r;
      *reinterpret_cast<V*>(pi + out) = out_i;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int VEC>
int launch(const void* g_r, const void* g_i, const void* a0, const void* a1, void* pr, void* pi,
           long long nbatch, long long rows, long long nants, long long nfreqs,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows),
                  static_cast<unsigned>((nfreqs + kThreads * VEC - 1) / (kThreads * VEC)),
                  static_cast<unsigned>(nbatch));
  gain_products_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g_r), static_cast<const T*>(g_i), static_cast<const int*>(a0),
      static_cast<const int*>(a1), static_cast<T*>(pr), static_cast<T*>(pi), rows, nants,
      nfreqs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// g_r, g_i: (nbatch, nants, nfreqs); a0, a1: (rows,) int32 antenna indices
// in [0, nants); pr, pi: (nbatch, rows, nfreqs); all contiguous, the values
// of one type (dtype 0: float32, 1: float64).
int gain_products(const void* g_r, const void* g_i, const void* a0, const void* a1, void* pr,
                  void* pi, long long nbatch, long long rows, long long nants,
                  long long nfreqs, int dtype, void* stream) {
  if (nbatch < 1 || nants < 1 || nfreqs < 1 || rows < 1 || nbatch > 65535
      || (rows + kRows - 1) / kRows > 0x7FFFFFFFLL || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(g_r) && aligned16(g_i) && aligned16(pr) && aligned16(pi);
  if (dtype == 0) {
    return vec && nfreqs % 4 == 0
               ? launch<float, 4>(g_r, g_i, a0, a1, pr, pi, nbatch, rows, nants, nfreqs, s)
               : launch<float, 1>(g_r, g_i, a0, a1, pr, pi, nbatch, rows, nants, nfreqs, s);
  }
  return vec && nfreqs % 2 == 0
             ? launch<double, 2>(g_r, g_i, a0, a1, pr, pi, nbatch, rows, nants, nfreqs, s)
             : launch<double, 1>(g_r, g_i, a0, a1, pr, pi, nbatch, rows, nants, nfreqs, s);
}

}  // extern "C"
