// The gradient of the gain products with respect to the antenna gains,
// summed in a fixed order, for Hopper (sm_90a).
//
// What it replaces: the reference differentiates its gain gather
// (calamity_tpu/ops/loss.py:183-196, `gain_products`: four jnp.take) with
// XLA's scatter-add; the port's torch ops did the same with index_add_,
// which on CUDA adds with atomics in an order that changes from run to run.
// This kernel computes the gains' gradient directly from the gain products'
// cotangents:
//
//   pr = gr0 gr1 + gi0 gi1,   pi = gr0 gi1 - gi0 gr1      (per row and channel)
//   side 0 (the row's first antenna):
//     dg_r += dpr gr1 + dpi gi1,   dg_i += dpr gi1 - dpi gr1
//   side 1 (its second antenna):
//     dg_r += dpr gr0 - dpi gi0,   dg_i += dpr gi0 + dpi gr0
//
// What bounds it: bytes. The least it must move is dpr and dpi of the
// listed rows once, the gains once and dg once; the arithmetic is 8
// operations per entry and channel. Each row is read by two lists (its two
// antennas), so the second read must come from L2 to stay near that bound.
// What held the first version (one thread per (slice, antenna, channel)
// walking the antenna's whole list) far from it was the longest list: a
// shared-batched chunk pads its operator classes with rows of antenna 0, so
// antenna 0's threads walked thousands of entries while the others walked
// tens.
//
// The design:
// - Each antenna's (row, side) entries are listed in ascending row order
//   (side 0 before side 1), and padded rows (ChunkMeta.valid False; their
//   cotangents are zero, so the sums do not change) are listed nowhere.
// - Each list is cut into segments of at most S entries (S is the table's,
//   64 by default; an antenna with no entries has one empty segment).
// - Pass 1 writes dg directly for an antenna with one segment, and a
//   partial into scratch for each segment of an antenna with more. Pass 2,
//   launched only when some antenna has more than one segment, sums each
//   such antenna's partials in ascending segment order. No atomics: every
//   sum is taken in one order on every run. When no list is longer than S
//   (the disc array's 63 entries an antenna, the HERA core's lists once the
//   padding is gone) the gradient is one launch.
// - One block of 128 threads owns one (segment, channel tile, slice): it
//   stages the segment's entries in shared memory once (128 at a time),
//   and each thread sums them in list order for one channel, four entries'
//   loads started together. One channel a thread keeps the rows that the
//   card's resident blocks touch at once inside the 50 MB L2, so a row's
//   second read (its other antenna's list) comes from there; with 16-byte
//   loads (four channels a thread) the resident blocks' rows overflowed it
//   at the disc array's and the HERA core's unpadded rows (PERF.md).
// - Each entry is two explicit fused multiply-adds in one order, so an
//   entry whose cotangents are zero (a padded row listed by a caller that
//   lists every row) leaves the sums as they were: the lists with and
//   without padding give the same gradient to the bit.

// C interface (loaded with ctypes): gain_grad(...) returns the CUDA error
// of the launches (0 on success); it launches on the given stream and does
// not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // channels of a block
constexpr int kBatch = 4;      // entries whose loads a thread starts together

// One entry's terms, as two explicit fused multiply-adds each.
template <typename T>
__device__ __forceinline__ void add_entry(int side, T p_r, T p_i, T gr, T gi, T& acc_r,
                                          T& acc_i) {
  const T sign = side == 0 ? T(1) : T(-1);
  acc_r = fma(sign * p_i, gi, fma(p_r, gr, acc_r));
  acc_i = fma(-sign * p_i, gr, fma(p_r, gi, acc_i));
}

// Pass 1: one block per (segment, channel tile, slice).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gain_grad_segments(const T* __restrict__ dpr, const T* __restrict__ dpi,
                   const T* __restrict__ g_r, const T* __restrict__ g_i,
                   const int* __restrict__ rowside, const int* __restrict__ other,
                   const int* __restrict__ seg_start, const int* __restrict__ seg_ant,
                   const int* __restrict__ seg_slot, T* __restrict__ dg_r,
                   T* __restrict__ dg_i, T* __restrict__ part_r, T* __restrict__ part_i,
                   int64_t rows, int64_t nants, int64_t nfreqs, int64_t nslots) {
  __shared__ int s_rowside[kThreads];
  __shared__ int s_other[kThreads];
  const int64_t seg = blockIdx.x;
  const int64_t n = blockIdx.z;
  const int64_t f = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  const bool active = f < nfreqs;
  const T* pr_n = dpr + n * rows * nfreqs + f;
  const T* pi_n = dpi + n * rows * nfreqs + f;
  const T* gr_n = g_r + n * nants * nfreqs + f;
  const T* gi_n = g_i + n * nants * nfreqs + f;
  T acc_r = T(0), acc_i = T(0);
  const int e0 = seg_start[seg];
  const int e1 = seg_start[seg + 1];
  for (int base = e0; base < e1; base += kThreads) {
    const int m = min(kThreads, e1 - base);
    __syncthreads();  // the previous tile's entries are read
    if (threadIdx.x < m) {
      s_rowside[threadIdx.x] = rowside[base + threadIdx.x];
      s_other[threadIdx.x] = other[base + threadIdx.x];
    }
    __syncthreads();
    if (!active) continue;
    int e = 0;
    for (; e + kBatch <= m; e += kBatch) {
      T p_r[kBatch], p_i[kBatch], gr[kBatch], gi[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int64_t row = s_rowside[e + k] >> 1;
        const int64_t o = s_other[e + k];
        p_r[k] = pr_n[row * nfreqs];
        p_i[k] = pi_n[row * nfreqs];
        gr[k] = gr_n[o * nfreqs];
        gi[k] = gi_n[o * nfreqs];
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        add_entry(s_rowside[e + k] & 1, p_r[k], p_i[k], gr[k], gi[k], acc_r, acc_i);
      }
    }
    for (; e < m; ++e) {
      const int64_t row = s_rowside[e] >> 1;
      const int64_t o = s_other[e];
      add_entry(s_rowside[e] & 1, pr_n[row * nfreqs], pi_n[row * nfreqs], gr_n[o * nfreqs],
                gi_n[o * nfreqs], acc_r, acc_i);
    }
  }
  if (!active) return;
  const int slot = seg_slot[seg];
  const int64_t out = slot < 0 ? (n * nants + seg_ant[seg]) * nfreqs + f
                               : (n * nslots + slot) * nfreqs + f;
  (slot < 0 ? dg_r : part_r)[out] = acc_r;
  (slot < 0 ? dg_i : part_i)[out] = acc_i;
}

// Pass 2: one block per (antenna with several segments, channel tile,
// slice) sums the antenna's partials in ascending segment order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gain_grad_partials(const T* __restrict__ part_r, const T* __restrict__ part_i,
                   const int* __restrict__ multi_ants, const int* __restrict__ multi_slot,
                   T* __restrict__ dg_r, T* __restrict__ dg_i, int64_t nants,
                   int64_t nfreqs, int64_t nslots) {
  const int64_t j = blockIdx.x;
  const int64_t n = blockIdx.z;
  const int64_t f = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (f >= nfreqs) return;
  T acc_r = T(0), acc_i = T(0);
  for (int s = multi_slot[j]; s < multi_slot[j + 1]; ++s) {
    acc_r += part_r[(n * nslots + s) * nfreqs + f];
    acc_i += part_i[(n * nslots + s) * nfreqs + f];
  }
  const int64_t out = (n * nants + multi_ants[j]) * nfreqs + f;
  dg_r[out] = acc_r;
  dg_i[out] = acc_i;
}

template <typename T>
int launch(const void* dpr, const void* dpi, const void* g_r, const void* g_i,
           const void* rowside, const void* other, const void* seg_start, const void* seg_ant,
           const void* seg_slot, const void* multi_ants, const void* multi_slot, void* dg_r,
           void* dg_i, void* part_r, void* part_i, long long nbatch, long long rows,
           long long nants, long long nfreqs, long long nseg, long long nmulti,
           long long nslots, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((nfreqs + kThreads - 1) / kThreads);
  gain_grad_segments<T><<<dim3(static_cast<unsigned>(nseg), tiles,
                               static_cast<unsigned>(nbatch)),
                          kThreads, 0, stream>>>(
      static_cast<const T*>(dpr), static_cast<const T*>(dpi), static_cast<const T*>(g_r),
      static_cast<const T*>(g_i), static_cast<const int*>(rowside),
      static_cast<const int*>(other), static_cast<const int*>(seg_start),
      static_cast<const int*>(seg_ant), static_cast<const int*>(seg_slot),
      static_cast<T*>(dg_r), static_cast<T*>(dg_i), static_cast<T*>(part_r),
      static_cast<T*>(part_i), rows, nants, nfreqs, nslots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nmulti == 0) return static_cast<int>(err);
  gain_grad_partials<T><<<dim3(static_cast<unsigned>(nmulti), tiles,
                               static_cast<unsigned>(nbatch)),
                          kThreads, 0, stream>>>(
      static_cast<const T*>(part_r), static_cast<const T*>(part_i),
      static_cast<const int*>(multi_ants), static_cast<const int*>(multi_slot),
      static_cast<T*>(dg_r), static_cast<T*>(dg_i), nants, nfreqs, nslots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dpr, dpi: (nbatch, rows, nfreqs); g_r, g_i, dg_r, dg_i: (nbatch, nants,
// nfreqs); part_r, part_i: (nbatch, nslots, nfreqs) scratch (unused when
// nmulti is 0); all contiguous, of one type (dtype 0: float32, 1: float64).
// The int32 tables: rowside and other (nentries = seg_start[nseg]
// entries), each row * 2 + side and the row's other antenna, antenna by
// antenna in ascending row order; seg_start (nseg + 1), seg_ant and
// seg_slot (nseg): segment k holds entries [seg_start[k], seg_start[k + 1])
// of antenna seg_ant[k], and its partial goes to scratch slot seg_slot[k],
// or straight to dg where seg_slot[k] is -1 (its antenna's only segment);
// multi_ants (nmulti) and multi_slot (nmulti + 1): the antennas with
// several segments and their slots [multi_slot[j], multi_slot[j + 1]).
// Every antenna has at least one segment.
int gain_grad(const void* dpr, const void* dpi, const void* g_r, const void* g_i,
              const void* rowside, const void* other, const void* seg_start,
              const void* seg_ant, const void* seg_slot, const void* multi_ants,
              const void* multi_slot, void* dg_r, void* dg_i, void* part_r, void* part_i,
              long long nbatch, long long rows, long long nants, long long nfreqs,
              long long nseg, long long nmulti, long long nslots, long long nentries,
              int dtype, void* stream) {
  if (nbatch < 1 || nants < 1 || nfreqs < 1 || nseg < nants || nbatch > 65535
      || nseg > 0x7FFFFFFFLL || nmulti < 0 || nmulti > nants || nslots < 0 || rows < 0
      || rows > (1LL << 30) || nentries < 0 || nentries > 2 * rows
      || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto launch_as = dtype == 0 ? &launch<float> : &launch<double>;
  return launch_as(dpr, dpi, g_r, g_i, rowside, other, seg_start, seg_ant, seg_slot,
                   multi_ants, multi_slot, dg_r, dg_i, part_r, part_i, nbatch, rows, nants,
                   nfreqs, nseg, nmulti, nslots, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
