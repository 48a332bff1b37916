// The gradient of the gain products with respect to the antenna gains,
// summed in a fixed order, for Hopper (sm_90a).
//
// What it replaces: the reference differentiates its gain gather
// (calamity_tpu/ops/loss.py:183-196, four jnp.take) with XLA's scatter-add;
// the port's torch ops did the same with index_add_, which on CUDA adds
// with atomics in an order that changes from run to run, so two runs of
// one fit stopped at different steps. This kernel computes the gains'
// gradient directly from the gain products' cotangents:
//
//   pr = gr0 gr1 + gi0 gi1,   pi = gr0 gi1 - gi0 gr1      (per row and channel)
//   side 0 (the row's first antenna):
//     dg_r += dpr gr1 + dpi gi1,   dg_i += dpr gi1 - dpi gr1
//   side 1 (its second antenna):
//     dg_r += dpr gr0 - dpi gi0,   dg_i += dpr gi0 + dpi gr0
//
// One thread owns one (slice, antenna, channel) and walks the antenna's
// (row, side) entries of a CSR list in ascending row order (side 0 before
// side 1), so every sum is taken in one order on every run, without
// atomics. Threads of a block cover consecutive channels: every load of a
// cotangent or a gain is coalesced, and every thread of the block reads
// the same CSR entry.
//
// What bounds it: bytes. It reads dpr and dpi once per side (each row
// serves two antennas; the second read mostly hits L2), the gains once per
// entry (L2) and writes dg once; the bound counts dpr, dpi and the gains
// read once and dg written once. The arithmetic is 8 operations per entry
// and channel. A thread's time grows with its antenna's list: the padded
// rows of a shared-batched chunk all name antenna 0, whose threads then
// walk thousands of entries while the others walk tens.
//
// C interface (loaded with ctypes): gain_grad(...) returns the CUDA error
// of the launch (0 on success); it launches on the given stream and does
// not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 8;  // entries whose loads a thread starts together

template <typename T>
__device__ __forceinline__ void add_entry(int side, T p_r, T p_i, T gr, T gi, T& acc_r,
                                          T& acc_i) {
  if (side == 0) {
    acc_r += p_r * gr + p_i * gi;
    acc_i += p_r * gi - p_i * gr;
  } else {
    acc_r += p_r * gr - p_i * gi;
    acc_i += p_r * gi + p_i * gr;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gain_grad_kernel(const T* __restrict__ dpr, const T* __restrict__ dpi,
                 const T* __restrict__ g_r, const T* __restrict__ g_i,
                 const int* __restrict__ offsets, const int* __restrict__ rowside,
                 const int* __restrict__ other, T* __restrict__ dg_r, T* __restrict__ dg_i,
                 int64_t rows, int64_t nants, int64_t nfreqs) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= nfreqs) return;
  const int64_t ant = blockIdx.y;
  const int64_t n = blockIdx.z;
  const T* pr_n = dpr + n * rows * nfreqs + f;
  const T* pi_n = dpi + n * rows * nfreqs + f;
  const T* gr_n = g_r + n * nants * nfreqs + f;
  const T* gi_n = g_i + n * nants * nfreqs + f;
  T acc_r = 0, acc_i = 0;
  int e = offsets[ant];
  const int end = offsets[ant + 1];
  // kBatch entries' loads started together, then summed in list order (the
  // same sums as one entry at a time)
  for (; e + kBatch <= end; e += kBatch) {
    T p_r[kBatch], p_i[kBatch], gr[kBatch], gi[kBatch];
    int side[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int rs = rowside[e + k];
      const int64_t row = rs >> 1;
      const int64_t o = other[e + k];
      side[k] = rs & 1;
      p_r[k] = pr_n[row * nfreqs];
      p_i[k] = pi_n[row * nfreqs];
      gr[k] = gr_n[o * nfreqs];
      gi[k] = gi_n[o * nfreqs];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      add_entry(side[k], p_r[k], p_i[k], gr[k], gi[k], acc_r, acc_i);
    }
  }
  for (; e < end; ++e) {
    const int rs = rowside[e];
    const int64_t row = rs >> 1;
    const int64_t o = other[e];
    add_entry(rs & 1, pr_n[row * nfreqs], pi_n[row * nfreqs], gr_n[o * nfreqs],
              gi_n[o * nfreqs], acc_r, acc_i);
  }
  const int64_t out = (n * nants + ant) * nfreqs + f;
  dg_r[out] = acc_r;
  dg_i[out] = acc_i;
}

template <typename T>
int launch(const void* dpr, const void* dpi, const void* g_r, const void* g_i,
           const void* offsets, const void* rowside, const void* other, void* dg_r, void* dg_i,
           long long nbatch, long long rows, long long nants, long long nfreqs,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((nfreqs + kThreads - 1) / kThreads),
                  static_cast<unsigned>(nants), static_cast<unsigned>(nbatch));
  gain_grad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dpr), static_cast<const T*>(dpi), static_cast<const T*>(g_r),
      static_cast<const T*>(g_i), static_cast<const int*>(offsets),
      static_cast<const int*>(rowside), static_cast<const int*>(other), static_cast<T*>(dg_r),
      static_cast<T*>(dg_i), rows, nants, nfreqs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dpr, dpi: (nbatch, rows, nfreqs); g_r, g_i, dg_r, dg_i: (nbatch, nants,
// nfreqs), all contiguous, of one type (dtype 0: float32, 1: float64);
// offsets (nants + 1), rowside and other (offsets[nants]) int32: antenna
// a's entries are [offsets[a], offsets[a + 1]), each row * 2 + side and the
// row's other antenna.
int gain_grad(const void* dpr, const void* dpi, const void* g_r, const void* g_i,
              const void* offsets, const void* rowside, const void* other, void* dg_r,
              void* dg_i, long long nbatch, long long rows, long long nants, long long nfreqs,
              int dtype, void* stream) {
  if (nbatch < 1 || nants < 1 || nfreqs < 1 || nbatch > 65535 || nants > 65535
      || rows < 0 || rows > (1LL << 30) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(dpr, dpi, g_r, g_i, offsets, rowside, other, dg_r, dg_i, nbatch, rows,
                         nants, nfreqs, s);
  }
  return launch<double>(dpr, dpi, g_r, g_i, offsets, rowside, other, dg_r, dg_i, nbatch, rows,
                        nants, nfreqs, s);
}

}  // extern "C"
