// Fused forward model, weighted chi-square AND its gradients of one dense
// B=1 chunk for a batch of N (time, pol) slices that share the chunk's
// basis, in one read of the basis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of calamity_tpu/ops/fused.py
// (launched by `_fwd_call`, pallas_call at fused.py:196) together with its
// XLA backward `_bwd_xla` (fused.py:223-250), which the JAX package runs per
// slice and vmaps over the batch. Per row (g, f) of a chunk with G groups,
// F channels and V basis modes, and per slice n:
//
//   v_r     = sum_k comps[g, f, k] * coeffs2[0, n, g, k]     (v_i: coeffs2[1])
//   m_r     =  pr * v_r + pi * v_i,   m_i = -pi * v_r + pr * v_i
//   loss[n] += w * ((dr - m_r)^2 + (di - m_i)^2)
// and, at a loss cotangent of 1 (the chi-square is local per group and its
// cotangent a scalar per slice, fused.py:290-310, so the autograd Function
// scales these by the cotangent afterwards):
//   dm      = -2 w (d - m)
//   dpr     = v_r dm_r + v_i dm_i,   dpi = v_i dm_r - v_r dm_i
//   dv_r    = pr dm_r - pi dm_i,     dv_i = pi dm_r + pr dm_i
//   dcoeffs[k, n, g, :] = sum_f comps[g, f, :] * dv_k[n, g, f]
// Three instances of one template: the loss only; the loss with dpr/dpi
// (coefficients frozen); the loss with every gradient. All accumulation is
// float32 (no TF32); bfloat16 comps and weights are widened on load.
//
// The "sum" flux prior (calamity_tpu/parallel/batched.py:216-272) adds
// per slice the weighted model sums M_r = sum w m_r and M_i = sum w m_i,
// and its loss (sum_chunks chi2 + (sum M_r - P_r)^2 + (sum M_i - P_i)^2)
// gives them a cotangent that depends on every chunk's sums, known only
// after every chunk's forward. At per-slice cotangents (gx, gr, gi) of
// (chi2, M_r, M_i) only dm changes, dm_r = w (gr - 2 gx (dr - m_r)) and
// dm_i = w (gi - 2 gx (di - m_i)), so every gradient is linear in them:
//   dpr     = gx dpr_chi + gr (w v_r) + gi (w v_i)
//   dpi     = gx dpi_chi + gr (w v_i) - gi (w v_r)
//   dcoeffs_re = gx D_re + gr C(w pr) - gi C(w pi)
//   dcoeffs_im = gx D_im + gr C(w pi) + gi C(w pr)
// with dpr_chi, dpi_chi and D = C(dv) the chi-square's gradients at a
// cotangent of 1 and C(x)[k] = sum_f comps[g, f, k] x[f]. Three "sum"
// instances: the forward alone (the loss-only pass that also writes the
// partials of M_r and M_i beside the chi-square's; no gradient wanted),
// and the one-pass forward with dpr/dpi (coefficients frozen) or with
// every gradient, which in the same read of comps also write the pieces
// above: dpr_chi, dpi_chi, w v_r, w v_i and, with every gradient, D_re,
// D_im, C(w pr), C(w pi), four columns a slice in phase B. A second
// kernel, `fused_sum_combine_kernel`, forms the gradients from those
// pieces and the cotangents in one elementwise launch, without comps.
// (The shared-basis kernel's modes 4 and 5, its "sum" backward, are not
// instances of this kernel.)
//
// What bounds it: bytes, then registers. Each comps value is read from
// device memory once for up to 8 slices and feeds 4 N fused multiply-adds
// (2 N in the matvec, 2 N in the coefficient gradient); the per-slice planes
// pr, pi, dr, di, w (read) and dpr, dpi (written) are 28 bytes per row and
// slice. At the main chunk (2016 x 1536 x 118, N = 8) the least time is
// 0.652 ms (float32 comps) or 0.434 ms (bfloat16) by bytes, and the FMAs of
// both phases take 0.349 ms at the float32 rate. What holds the kernel
// from those lines is latency: a block's warps take turns between waiting
// for a tile and the two phases' FMAs, so an SM needs several independent
// blocks, each within 128 registers a thread. Four blocks of 128 threads
// share an SM; the register tiles below are sized to that cap. At N = 8,
// float32 comps: 4-row and 4-mode tiles in two blocks of 256 threads
// spilled 568 bytes and took 2.44 ms; 2-row and 2-mode tiles with 32-bit
// counters 1.42 ms; the same in four blocks of 128 threads, each thread
// owning its phase-B modes over every row, 1.27 ms; one block per SM
// without spills was slower (PERF.md, scripts/kernel_variants.py).
//
// Design: one block of 128 threads per group walks all F channels of that
// group, `rows` channels per tile, so each comps tile serves both phases
// while it is in shared memory and the group's coefficient gradient is
// written once, with no atomics and no partial sets.
// - A ring of two comps tiles in shared memory, each completed on an
//   mbarrier: one thread issues one `cp.async.bulk` (TMA, non-tensor) for
//   the tile, whose rows x V values are one contiguous span of the group;
//   where a span is not 16-byte aligned (ragged F, odd V, an odd bfloat16
//   offset), every thread issues 4-byte `cp.async` copies of the enclosing
//   aligned words, completed on the same mbarrier (`.noinc` arrivals). The
//   next tile loads while this one computes. bfloat16 comps stay bfloat16 in
//   shared memory and are widened on the read.
// - Phase A, thread-per-row: a tile's rows are split over rows / 2 lanes x
//   the column groups x parts of the modes; each thread keeps a 2-row x (up
//   to) 8-column tile of partial dot products in registers, summed over the
//   parts in a fixed order through shared memory. The coefficients are
//   staged once per group and slice tile, interleaved per mode, and read as
//   float4 broadcasts. The tile keeps the unpadded row stride of the bulk
//   copy; rows are read as pairs of modes (float2, bfloat162) where V is
//   even, and at the main V = 118 a row is an odd number of 8-byte (f32) or
//   4-byte (bf16) units, so a warp's 32 consecutive rows fall in distinct
//   banks. At V divisible by 4 the pair reads are conflicted (up to 16-way
//   at V = 128); no such chunk is on the main path.
// - Epilogue, per row and slice: the plane loads are issued before phase A,
//   so their latency hides behind the matvec; the loss goes to per-thread
//   registers, dpr/dpi are written coalesced along the channel axis, dv to a
//   shared tile (row stride 2 NT + 4 floats: float4 reads, 4-way stores).
// - Phase B, thread-per-mode: each thread keeps a 2-mode x (up to)
//   8-column tile of the coefficient gradient in registers across the whole
//   F loop (128 modes at N >= 5, 256 below), reading a pair of modes along
//   each row and dv as float4 broadcasts. Modes past that are owned one per
//   thread and accumulated in the output itself (the block owns its group's
//   gradient), tile by tile.
// - Phase B of the one-pass "sum" instance takes four columns a slice (32
//   at 8 slices), which a thread's register tile cannot hold at 128
//   registers. It runs on the tensor cores instead, as the shared-basis
//   kernel's products do: `mma.sync.m16n8k8` with TF32 operands, each
//   float32 operand split into a TF32 hi and lo, the product accumulated
//   as a_lo b_hi + a_hi b_lo + a_hi b_hi (float32 comps: three `mma`s) or
//   a b_lo + a b_hi (bfloat16 comps, exact in TF32: two), good to about
//   2^-20 relative. A is comps^T (16 modes x 8 rows of the tile, read from
//   the ring and split by truncation), B the four columns of each slice (8
//   rows x 8 columns), split once by the epilogue (cvt.rna) into (hi, lo)
//   pairs in shared memory (its stores 4-way conflicted: an XOR swizzle
//   that removed that cost more in phase B's addressing). At 8 slices a
//   tile the instance runs three blocks an SM at 168 registers: at 128 it
//   spilled 460-488 bytes and took 2.10 ms against 1.68 (f32, N = 8, the
//   device alone; PERF.md). Each warp holds 32 accumulators a thread
//   across the F loop: m16 tiles w, w + 4, ... of the modes over every
//   column (128 modes at 8 slices a tile, 256 at 4, 512 below); modes past
//   those are summed tile by tile into the output, each entry by one lane.
//   Rows past the tile and modes past V read as zero.
// - Loop counters and shared-memory offsets are 32-bit: registers, not
//   instructions, are what this kernel is short of.
// - The per-slice loss partials are one per block, summed by the caller in
//   a fixed order: every loss and gradient is the same from run to run.
// - The data and weight planes are addressed through (slice, group,
//   channel) strides (group-block views, a channel stride of 0); pr and pi
//   are contiguous (N, G, F), and so are dpr and dpi.
// Any N, G, F and V are taken: N in tiles of up to 8 slices (each slice
// tile reads comps again); the row tile shrinks from 64 (32 for float32 at
// NT = 8, so four blocks fit on an SM) to 1 as V grows, and the interleaved
// coefficients move to a device scratch buffer when they no longer fit. A
// row too wide for a ring of two one-row tiles (more than about 27,000
// float32 or 54,000 bfloat16 modes) goes to a plain wide-row kernel that
// reads each row again for the gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;             // blocks an SM holds (128 registers a thread)
constexpr int kTileA = 2;                 // phase A: rows a thread
constexpr int kTileB = 2;                 // phase B: modes a thread
constexpr int kStages = 2;                // comps tiles in the ring
constexpr size_t kMaxSmem = 227 * 1024;   // a block's dynamic shared memory
// the most a block may take so that `blocks` fit on an SM (228 KB, 1 KB of
// each block's reserved)
__host__ __device__ constexpr size_t smem_per_block(int blocks) { return 233472 / blocks - 1024; }
constexpr size_t kPerBlock = smem_per_block(kMinBlocks);

// the chi-square's instances (0-2) and the "sum" prior's: its forward alone
// (3) and its one-pass forward with dpr/dpi (6) or every gradient (7).
// Modes 4 and 5 are the shared-basis kernel's "sum" backward; this kernel
// has none.
enum Mode { kLossOnly = 0, kLossDp = 1, kLossAll = 2, kSumFwd = 3, kSumFwdDp = 6, kSumFwdAll = 7 };

__host__ __device__ constexpr bool is_mode(int mode) {
  return (mode >= kLossOnly && mode <= kSumFwd) || mode == kSumFwdDp || mode == kSumFwdAll;
}
__host__ __device__ constexpr bool has_dp(int mode) {
  return mode == kLossDp || mode == kLossAll || mode >= kSumFwdDp;
}
// the chi-square's coefficient gradient in registers on CUDA cores
__host__ __device__ constexpr bool has_all(int mode) { return mode == kLossAll; }
// the one-pass "sum" instances: dpr/dpi at a chi-square cotangent of 1 and
// the planes w v_r, w v_i (and with every gradient phase B on the tensor cores)
__host__ __device__ constexpr bool one_pass(int mode) { return mode >= kSumFwdDp; }
__host__ __device__ constexpr bool has_mma(int mode) { return mode == kSumFwdAll; }
// blocks an SM holds: the one-pass instance's 32 accumulators a thread
// across the F loop spill at 128 registers with 8 slices a tile (460-488
// bytes): three blocks of 168 registers there
__host__ __device__ constexpr int blocks_per_sm(int mode, int nt) {
  return has_mma(mode) && nt == 8 ? 3 : kMinBlocks;
}
// the partial sums an instance writes per (slice, group): the chi-square;
// the "sum" instances also M_r and M_i
__host__ __device__ constexpr int n_terms(int mode) {
  return mode == kSumFwd || one_pass(mode) ? 3 : 1;
}

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__host__ __device__ constexpr int dv_stride(int m) { return m % 4 == 0 ? m + 4 : m; }

// the tensor-core phase B's (hi, lo) pairs of dv: 4 NT columns (at least
// one n8 tile) per row, in float2 units; a row stride of 4 mod 16 puts a
// half-warp's B fragment reads (rows tig, columns gid) in distinct banks
__host__ __device__ constexpr int pair_cols(int m) { return 2 * m < 8 ? 8 : 2 * m; }
__host__ __device__ constexpr int pair_stride(int m) { return pair_cols(m) + 4; }
// rows of that tile: whole k-steps of 8
__host__ __device__ constexpr int pair_rows(int rows) { return rows < 8 ? 8 : rows; }

// columns of a thread's register tile (the rest of the 2 NT go to others)
__host__ __device__ constexpr int tile_cols(int m) { return m < 8 ? m : 8; }

// byte offsets of the shared-memory sections of one block
struct Layout {
  size_t tile_bytes, tiles, coef, red, dv, total;
};

__host__ __device__ inline Layout make_layout(int m, int rows, long long V, int csize,
                                              bool coef_smem, int mode) {
  Layout L;
  size_t off = 8 * kStages;  // the mbarriers
  off = round16(off);
  L.tile_bytes = round16(static_cast<size_t>(rows) * V * csize + 16);
  L.tiles = off;
  off += kStages * L.tile_bytes;
  L.coef = off;
  if (coef_smem) off += round16(static_cast<size_t>(V) * m * 4);
  L.red = off;  // phase A exchange; loss reduction
  off += round16(static_cast<size_t>(kThreads) * kTileA * tile_cols(m) * 4);
  L.dv = off;
  if (has_all(mode)) off += round16(static_cast<size_t>(rows) * dv_stride(m) * 4);
  if (has_mma(mode)) off += round16(static_cast<size_t>(pair_rows(rows)) * pair_stride(m) * 8);
  L.total = off;
  return L;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(x);
  b = __high2float(x);
}

// a register tile: s[i][j] += c[i] * cf[j] for R values c (rows or modes)
// and C values cf (columns: (re, im) of slices; 16-byte aligned for
// C % 4 == 0, 8-byte aligned for C == 2). Each shared-memory value feeds
// R or C fused multiply-adds.
template <int R, int C>
__device__ __forceinline__ void fma_tile(float (&s)[R][C], const float* cf, const float (&c)[R]) {
  if constexpr (C % 4 == 0) {
    const float4* c4 = reinterpret_cast<const float4*>(cf);
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 x = c4[q];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i][4 * q] = fmaf(c[i], x.x, s[i][4 * q]);
        s[i][4 * q + 1] = fmaf(c[i], x.y, s[i][4 * q + 1]);
        s[i][4 * q + 2] = fmaf(c[i], x.z, s[i][4 * q + 2]);
        s[i][4 * q + 3] = fmaf(c[i], x.w, s[i][4 * q + 3]);
      }
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(cf);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i][0] = fmaf(c[i], x.x, s[i][0]);
      s[i][1] = fmaf(c[i], x.y, s[i][1]);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// x = hi + lo in TF32: hi = tf32(x) (its low 13 bits cleared, so that x - hi
// is exact), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = h;
  lo = l;
}

// d += a b on one m16n8k8 tile, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// phase B of the one-pass instance on one k-step: d[j] += A B for the m16
// tile of modes at m0 and each of the NTN n8 tiles of columns; A is the
// comps tile's rows r0.. r0 + 7 at those modes (zero past rows_here and V),
// B's (hi, lo) pairs given. Float32 comps: A split by truncation (hi = x
// with its low 13 bits cleared, lo = x - hi, exact, of which the tensor
// core reads the TF32 part: 2^-20 of x against cvt.rna's 2^-22, two
// instructions against six), three products small terms first; bfloat16
// comps are exact in TF32: two.
template <typename TC, int NTN>
__device__ __forceinline__ void mma_rows(float (&d)[NTN][4], const TC* tile, int Vs, int rows_here,
                                         int r0, int m0, int gid, int tig,
                                         const uint32_t (&bh)[NTN][2],
                                         const uint32_t (&bl)[NTN][2]) {
  float a[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + tig + 4 * (q >> 1), m = m0 + gid + 8 * (q & 1);
    a[q] = r < rows_here && m < Vs ? to_f32(tile[r * Vs + m]) : 0.f;
  }
  if constexpr (sizeof(TC) == 4) {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ahi[q] = __float_as_uint(a[q]) & 0xffffe000u;
      alo[q] = __float_as_uint(a[q] - __uint_as_float(ahi[q]));
    }
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      mma_tf32(d[nt], alo, bh[nt][0], bh[nt][1]);
      mma_tf32(d[nt], ahi, bl[nt][0], bl[nt][1]);
      mma_tf32(d[nt], ahi, bh[nt][0], bh[nt][1]);
    }
  } else {
    const uint32_t ax[4] = {__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                            __float_as_uint(a[3])};
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      mma_tf32(d[nt], ax, bl[nt][0], bl[nt][1]);
      mma_tf32(d[nt], ax, bh[nt][0], bh[nt][1]);
    }
  }
}

// B's (hi, lo) pairs of k-step r0 for each n8 tile: rows r0 + tig and r0 +
// tig + 4, column 8 nt + gid
template <int NTN>
__device__ __forceinline__ void load_b(const float2* dvp, int stride, int r0, int gid, int tig,
                                       uint32_t (&bh)[NTN][2], uint32_t (&bl)[NTN][2]) {
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = dvp[(r0 + tig + 4 * h) * stride + 8 * nt + gid];
      bh[nt][h] = __float_as_uint(x.x);
      bl[nt][h] = __float_as_uint(x.y);
    }
  }
}

// the output index of entry (column col = 4 n + c, mode k) of the one-pass
// instance's (4, N, G, V) coefficient pieces: D_re, D_im, C(w pr), C(w pi)
__device__ __forceinline__ int64_t piece_index(int col, int64_t n0, int64_t N, int64_t G,
                                               int64_t g, int64_t V, int64_t k) {
  return (((col & 3) * N + n0 + (col >> 2)) * G + g) * V + k;
}

template <int NT, typename TC, int MODE>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(MODE, NT))
fused_chunk_loss_kernel(const TC* __restrict__ comps, const float* __restrict__ coeffs2,
                        const float* __restrict__ pr, const float* __restrict__ pi,
                        const float* __restrict__ dr, const float* __restrict__ di,
                        int64_t d_sn, int64_t d_sg, int64_t d_sf, const void* __restrict__ w,
                        int w_bf16, int64_t w_sn, int64_t w_sg, int64_t w_sf,
                        float* __restrict__ partials, float* __restrict__ dcoeffs,
                        float* __restrict__ dpr, float* __restrict__ dpi,
                        float* __restrict__ coef_scratch, int64_t N, int64_t G, int64_t F,
                        int64_t V, int rows, int bulk, int pairs, int coef_smem) {
  constexpr int M = 2 * NT;           // dot products per row: (re, im) per slice
  constexpr int C = tile_cols(M);     // columns of a thread's register tile
  constexpr int CG = M / C;           // column groups
  constexpr int NH = (NT + 1) / 2;    // most slices of one thread's epilogue (rows <= kThreads / 2)
  constexpr int DVS = dv_stride(M);
  constexpr bool kDp = has_dp(MODE);
  constexpr bool kAll = has_all(MODE);
  constexpr bool kOne = one_pass(MODE);
  constexpr bool kMma = has_mma(MODE);
  constexpr int kTerms = n_terms(MODE);
  constexpr int NS = kTerms == 3 ? NH : 1;  // the model sums' accumulators
  // the tensor-core phase B: n8 tiles of the 4 NT columns, m16 tiles of
  // modes a warp holds (32 accumulators a thread), modes held in registers
  constexpr int NTN = pair_cols(M) / 8;
  constexpr int MTW = 8 / NTN;
  constexpr int kCapB = (kThreads / 32) * MTW * 16;
  constexpr int PS = pair_stride(M);
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(M, rows, V, sizeof(TC), coef_smem != 0, MODE);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* dvs = reinterpret_cast<float*>(smem + L.dv);
  float2* dvp = reinterpret_cast<float2*>(smem + L.dv);

  const int t = threadIdx.x;
  const int warp = t >> 5, gid = (t & 31) >> 2, tig = t & 3;  // the mma fragments' lanes
  const int64_t g = blockIdx.x;
  float* coef = coef_smem ? reinterpret_cast<float*>(smem + L.coef) : coef_scratch + g * V * M;
  const int64_t GF = G * F;
  const int64_t NGF = N * GF;  // the one-pass instances' second planes: w v_r, w v_i
  // shared-memory offsets and tile counters in 32 bits (the plan keeps N, F
  // and a tile row within int range): registers are what this kernel is
  // short of
  const int Vs = static_cast<int>(V);
  const int ntiles = static_cast<int>((F + rows - 1) / rows);
  const int nslice_tiles = static_cast<int>((N + NT - 1) / NT);
  const int total = ntiles * nslice_tiles;

  // phase A: rows la + rlanes * i (i < kTileA) and columns [ca * C, ca * C + C)
  // of the tile, over modes [ka0, ka1)
  const int rlanes = rows >= kTileA ? rows / kTileA : 1;
  const int la = t % rlanes;
  const int ca = (t / rlanes) % CG;
  const int pa = t / (rlanes * CG);
  const int parts = kThreads / (rlanes * CG);
  int chunk = (Vs + parts - 1) / parts;
  chunk += chunk & 1;  // even: pairs of modes stay aligned
  const int ka0 = pa * chunk < Vs ? pa * chunk : Vs;
  const int ka1 = ka0 + chunk < Vs ? ka0 + chunk : Vs;
  // epilogue: row re of the tile, slices [ne0, ne1) of the slice tile
  const int re = t % rows;
  const int per = (NT + kThreads / rows - 1) / (kThreads / rows);
  const int ne0 = (t / rows) * per < NT ? (t / rows) * per : NT;
  const int ne1 = ne0 + per < NT ? ne0 + per : NT;
  // phase B: modes [kb, kb + kTileB) and columns [cb * C, cb * C + C), rows
  // of the tile; modes past `capacity` are owned one per thread
  const int kb = t / CG * kTileB;
  const int cb = t % CG;
  constexpr int capacity = kThreads / CG * kTileB;

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&mbar[s]), bulk ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kMma) {
    // dv's (hi, lo) pairs start at zero: rows past the tile, columns past 4 NT
    for (int idx = t; idx < pair_rows(rows) * PS; idx += kThreads) dvp[idx] = make_float2(0.f, 0.f);
  }
  __syncthreads();

  // the comps tile of sequence index i into its stage: rows of tile i % ntiles
  auto issue = [&](int i) {
    const int64_t f0 = static_cast<int64_t>(i % ntiles) * rows;
    const int64_t nrows = F - f0 < rows ? F - f0 : rows;
    const TC* src = comps + (g * F + f0) * V;
    const uint32_t bytes = static_cast<uint32_t>(nrows * V * sizeof(TC));
    unsigned char* dst = smem + L.tiles + (i % kStages) * L.tile_bytes;
    const uint32_t bar = smem_u32(&mbar[i % kStages]);
    if (bulk) {
      if (t == 0) {
        // the block's generic-proxy reads of this stage precede the copy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, bytes);
        bulk_g2s(smem_u32(dst), src, bytes, bar);
      }
    } else {
      const uintptr_t a = reinterpret_cast<uintptr_t>(src);
      const uintptr_t a4 = a & ~static_cast<uintptr_t>(3);
      const int64_t words = static_cast<int64_t>((a + bytes + 3 - a4) / 4);
      for (int64_t q = t; q < words; q += kThreads) {
        cp_async4(smem_u32(dst) + 4 * static_cast<uint32_t>(q),
                  reinterpret_cast<const void*>(a4 + 4 * q));
      }
      cp_async_arrive(bar);
    }
  };
  // the tile of sequence index i as read: its stage plus the element offset
  // of an unaligned span
  auto tile_at = [&](int i) {
    const TC* base = reinterpret_cast<const TC*>(smem + L.tiles + (i % kStages) * L.tile_bytes);
    if (bulk) return base;
    const uintptr_t a = reinterpret_cast<uintptr_t>(comps + (g * F + (i % ntiles) * rows) * V);
    return base + (a & 3) / sizeof(TC);
  };

  for (int i = 0; i < total && i < kStages; ++i) issue(i);

  int i = 0;
  for (int st = 0; st < nslice_tiles; ++st) {
    const int64_t n0 = st * NT;
    const int nt = static_cast<int>(N - n0 < NT ? N - n0 : NT);
    // the group's coefficients of the slice tile, interleaved per mode
    for (int64_t idx = t; idx < V * M; idx += kThreads) {
      const int j = static_cast<int>(idx / V);
      const int64_t k = idx - j * V;
      const int n = j >> 1;
      coef[k * M + j] = n < nt ? coeffs2[(((j & 1) * N + n0 + n) * G + g) * V + k] : 0.f;
    }
    if constexpr (kAll) {
      // modes past the register tiles accumulate in the output itself
      for (int64_t k = capacity + t; k < V; k += kThreads) {
        for (int j = 0; j < 2 * nt; ++j)
          dcoeffs[(((j & 1) * N + n0 + (j >> 1)) * G + g) * V + k] = 0.f;
      }
    }
    if constexpr (kMma) {
      for (int64_t k = kCapB + t; k < V; k += kThreads) {
        for (int col = 0; col < 4 * nt; ++col) dcoeffs[piece_index(col, n0, N, G, g, V, k)] = 0.f;
      }
    }
    float lacc[NH], mrs[NS], mis[NS];
#pragma unroll
    for (int q = 0; q < NH; ++q) lacc[q] = 0.f;
#pragma unroll
    for (int q = 0; q < NS; ++q) mrs[q] = mis[q] = 0.f;
    float acc[kTileB][C];
#pragma unroll
    for (int m = 0; m < kTileB; ++m) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[m][j] = 0.f;
    }
    float bacc[kMma ? MTW : 1][NTN][4];
#pragma unroll
    for (int m = 0; m < (kMma ? MTW : 1); ++m) {
#pragma unroll
      for (int n = 0; n < NTN; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bacc[m][n][j] = 0.f;
      }
    }
    __syncthreads();  // coef staged

    for (int jt = 0; jt < ntiles; ++jt, ++i) {
      const int64_t f0 = static_cast<int64_t>(jt) * rows;
      const int rows_here = static_cast<int>(F - f0 < rows ? F - f0 : rows);
      const bool erow = re < rows_here;
      const int64_t f = f0 + re;
      // this thread's epilogue planes, loaded before the matvec hides their
      // latency
      float p_r[NH], p_i[NH], d_r[NH], d_i[NH], wv[NH];
#pragma unroll
      for (int q = 0; q < NH; ++q) {
        const int n = ne0 + q;
        p_r[q] = p_i[q] = d_r[q] = d_i[q] = wv[q] = 0.f;
        if (erow && n < ne1 && n < nt) {
          const int64_t nn = n0 + n;
          const int64_t prow = nn * GF + g * F + f;
          const int64_t drow = nn * d_sn + g * d_sg + f * d_sf;
          const int64_t wrow = nn * w_sn + g * w_sg + f * w_sf;
          p_r[q] = pr[prow];
          p_i[q] = pi[prow];
          d_r[q] = dr[drow];
          d_i[q] = di[drow];
          wv[q] = w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[wrow])
                         : static_cast<const float*>(w)[wrow];
        }
      }
      mbar_wait(smem_u32(&mbar[i % kStages]), static_cast<uint32_t>((i / kStages) & 1));
      const TC* tile = tile_at(i);

      // phase A: a kTileA x C register tile of partial dot products over this
      // part's modes; rows past the tile read row 0 and are dropped
      {
        float s[kTileA][C];
        const TC* rp[kTileA];
#pragma unroll
        for (int m = 0; m < kTileA; ++m) {
          const int r = la + rlanes * m;
          rp[m] = tile + (r < rows_here ? r : 0) * Vs;
#pragma unroll
          for (int j = 0; j < C; ++j) s[m][j] = 0.f;
        }
        const float* cf = coef + ca * C;
        if (pairs) {
          for (int k = ka0; k < ka1; k += 2) {
            float c0[kTileA], c1[kTileA];
#pragma unroll
            for (int m = 0; m < kTileA; ++m) load_pair(rp[m] + k, c0[m], c1[m]);
            fma_tile<kTileA, C>(s, cf + k * M, c0);
            fma_tile<kTileA, C>(s, cf + (k + 1) * M, c1);
          }
        } else {
          for (int k = ka0; k < ka1; ++k) {
            float c0[kTileA];
#pragma unroll
            for (int m = 0; m < kTileA; ++m) c0[m] = to_f32(rp[m][k]);
            fma_tile<kTileA, C>(s, cf + k * M, c0);
          }
        }
#pragma unroll
        for (int m = 0; m < kTileA; ++m) {
          const int r = la + rlanes * m;
          if (r < rows) {
#pragma unroll
            for (int j = 0; j < C; ++j) red[(pa * M + ca * C + j) * rows + r] = s[m][j];
          }
        }
      }
      __syncthreads();  // every part's partial sums are in

      // epilogue: this thread's slices of row re
#pragma unroll
      for (int q = 0; q < NH; ++q) {
        const int n = ne0 + q;
        if (n >= ne1) continue;
        if (!(erow && n < nt)) {
          // the tensor cores read every row of a k-step and every column of
          // an n8 tile: zeros here
          if constexpr (kMma) {
#pragma unroll
            for (int c = 0; c < 4; ++c) dvp[re * PS + 4 * n + c] = make_float2(0.f, 0.f);
          }
          continue;
        }
        float sr = 0.f, si = 0.f;
        for (int p = 0; p < parts; ++p) {  // a fixed order
          sr += red[(p * M + 2 * n) * rows + re];
          si += red[(p * M + 2 * n + 1) * rows + re];
        }
        const float mr = p_r[q] * sr + p_i[q] * si;
        const float mi = -p_i[q] * sr + p_r[q] * si;
        const float er = d_r[q] - mr;
        const float ei = d_i[q] - mi;
        lacc[q] += wv[q] * (er * er + ei * ei);
        if constexpr (kTerms == 3) {
          mrs[q] += wv[q] * mr;
          mis[q] += wv[q] * mi;
        }
        if constexpr (kDp) {
          // the chi-square's gradients at a cotangent of 1
          const float dmr = -2.f * wv[q] * er;
          const float dmi = -2.f * wv[q] * ei;
          const int64_t prow = (n0 + n) * GF + g * F + f;
          dpr[prow] = sr * dmr + si * dmi;
          dpi[prow] = si * dmr - sr * dmi;
          if constexpr (kOne) {
            dpr[NGF + prow] = wv[q] * sr;
            dpi[NGF + prow] = wv[q] * si;
          }
          if constexpr (kAll) {
            dvs[re * DVS + 2 * n] = p_r[q] * dmr - p_i[q] * dmi;
            dvs[re * DVS + 2 * n + 1] = p_i[q] * dmr + p_r[q] * dmi;
          }
          if constexpr (kMma) {
            const float x[4] = {p_r[q] * dmr - p_i[q] * dmi, p_i[q] * dmr + p_r[q] * dmi,
                                wv[q] * p_r[q], wv[q] * p_i[q]};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              uint32_t hi, lo;
              split_tf32(x[c], hi, lo);
              dvp[re * PS + 4 * n + c] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
            }
          }
        }
      }

      if constexpr (kAll) {
        __syncthreads();  // the dv tile is complete
        // phase B: a kTileB (modes) x C register tile of the coefficient
        // gradient, summed over the tile's rows
        const float* dcol = dvs + cb * C;
        if (kb + kTileB <= V && kb + kTileB <= capacity) {
          for (int r = 0; r < rows_here; ++r) {
            const TC* row = tile + r * Vs + kb;
            float c[kTileB];
            if (pairs) {
#pragma unroll
              for (int m = 0; m < kTileB; m += 2) load_pair(row + m, c[m], c[m + 1]);
            } else {
#pragma unroll
              for (int m = 0; m < kTileB; ++m) c[m] = to_f32(row[m]);
            }
            fma_tile<kTileB, C>(acc, dcol + r * DVS, c);
          }
        } else if (kb < V && kb < capacity) {
          for (int r = 0; r < rows_here; ++r) {
            const TC* row = tile + r * Vs;
            float c[kTileB];
#pragma unroll
            for (int m = 0; m < kTileB; ++m) c[m] = kb + m < V ? to_f32(row[kb + m]) : 0.f;
            fma_tile<kTileB, C>(acc, dcol + r * DVS, c);
          }
        }
        for (int64_t k = capacity + t; k < V; k += kThreads) {
          float x[1][M];
#pragma unroll
          for (int j = 0; j < M; ++j) x[0][j] = 0.f;
          for (int r = 0; r < rows_here; ++r) {
            const float c[1] = {to_f32(tile[r * V + k])};
            fma_tile<1, M>(x, dvs + r * DVS, c);
          }
#pragma unroll
          for (int j = 0; j < M; ++j) {
            if ((j >> 1) < nt)
              dcoeffs[(((j & 1) * N + n0 + (j >> 1)) * G + g) * V + k] += x[0][j];
          }
        }
      }
      if constexpr (kMma) {
        __syncthreads();  // the dv pairs are complete
        // phase B on the tensor cores: this warp's m16 tiles of modes w, w +
        // 4, ... over the tile's rows in k-steps of 8
        for (int r0 = 0; r0 < rows_here; r0 += 8) {
          uint32_t bh[NTN][2], bl[NTN][2];
          load_b<NTN>(dvp, PS, r0, gid, tig, bh, bl);
#pragma unroll
          for (int mt = 0; mt < MTW; ++mt) {
            const int m0 = (warp + 4 * mt) * 16;
            if (m0 < Vs) mma_rows<TC, NTN>(bacc[mt], tile, Vs, rows_here, r0, m0, gid, tig, bh, bl);
          }
        }
        // modes past the register tiles: one m16 tile at a time, added to
        // the output (each entry by one lane, tile after tile)
        for (int m0 = kCapB + warp * 16; m0 < Vs; m0 += 64) {
          float x[NTN][4];
#pragma unroll
          for (int n = 0; n < NTN; ++n) {
#pragma unroll
            for (int j = 0; j < 4; ++j) x[n][j] = 0.f;
          }
          for (int r0 = 0; r0 < rows_here; r0 += 8) {
            uint32_t bh[NTN][2], bl[NTN][2];
            load_b<NTN>(dvp, PS, r0, gid, tig, bh, bl);
            mma_rows<TC, NTN>(x, tile, Vs, rows_here, r0, m0, gid, tig, bh, bl);
          }
#pragma unroll
          for (int n = 0; n < NTN; ++n) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = 8 * n + 2 * tig + (j & 1), k = m0 + gid + 8 * (j >> 1);
              if (k < Vs && (col >> 2) < nt)
                dcoeffs[piece_index(col, n0, N, G, g, V, k)] += x[n][j];
            }
          }
        }
      }
      __syncthreads();  // every read of this stage, of red and of dv is done
      if (i + kStages < total) issue(i + kStages);
    }

    // the slice tile's partials (the loss; with the "sum" instances also M_r
    // and M_i): one per (term, slice, block), summed over the rows in a
    // fixed order
#pragma unroll
    for (int q = 0; q < NH; ++q) {
      const int n = ne0 + q;
      if (n < ne1) {
        red[n * rows + re] = lacc[q];
        if constexpr (kTerms == 3) {
          red[(NT + n) * rows + re] = mrs[q];
          red[(2 * NT + n) * rows + re] = mis[q];
        }
      }
    }
    __syncthreads();
    if (t < kTerms * NT) {
      const int c = t / NT, n = t - c * NT;
      if (n < nt) {
        float sum = 0.f;
        for (int r = 0; r < rows; ++r) sum += red[t * rows + r];
        partials[(c * N + n0 + n) * G + g] = sum;
      }
    }
    if constexpr (kAll) {
#pragma unroll
      for (int m = 0; m < kTileB; ++m) {
        const int k = kb + m;
        if (k >= V || k >= capacity) continue;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int col = cb * C + j;
          if ((col >> 1) < nt)
            dcoeffs[(((col & 1) * N + n0 + (col >> 1)) * G + g) * V + k] = acc[m][j];
        }
      }
    }
    if constexpr (kMma) {
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        const int m0 = (warp + 4 * mt) * 16;
        if (m0 >= Vs) continue;
#pragma unroll
        for (int n = 0; n < NTN; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 8 * n + 2 * tig + (j & 1), k = m0 + gid + 8 * (j >> 1);
            if (k < Vs && (col >> 2) < nt)
              dcoeffs[piece_index(col, n0, N, G, g, V, k)] = bacc[mt][n][j];
          }
        }
      }
    }
    __syncthreads();  // red and coef are free for the next slice tile
  }
}

// Rows too wide for the smallest ring of the kernel above: one block per
// group walks the group's rows one at a time, reading each row from device
// memory for the matvec and again, from L2, for the coefficient gradient.
// The coefficients are interleaved in the scratch buffer; the coefficient
// gradient accumulates in the output (the block owns its group's); every
// sum is taken in a fixed order.
template <int NT, typename TC, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_chunk_loss_wide(const TC* __restrict__ comps, const float* __restrict__ coeffs2,
                      const float* __restrict__ pr, const float* __restrict__ pi,
                      const float* __restrict__ dr, const float* __restrict__ di, int64_t d_sn,
                      int64_t d_sg, int64_t d_sf, const void* __restrict__ w, int w_bf16,
                      int64_t w_sn, int64_t w_sg, int64_t w_sf, float* __restrict__ partials,
                      float* __restrict__ dcoeffs, float* __restrict__ dpr,
                      float* __restrict__ dpi, float* __restrict__ coef_scratch, int64_t N,
                      int64_t G, int64_t F, int64_t V) {
  constexpr int M = 2 * NT;
  constexpr int kWarps = kThreads / 32;
  constexpr bool kDp = has_dp(MODE);
  constexpr bool kAll = has_all(MODE);
  constexpr bool kOne = one_pass(MODE);
  constexpr bool kMma = has_mma(MODE);
  constexpr int kTerms = n_terms(MODE);
  constexpr int kCols = kMma ? 2 * M : M;  // the coefficient gradient's columns a slice tile
  __shared__ float wsum[kWarps][M];
  __shared__ float dvrow[kCols];
  const int t = threadIdx.x;
  const int64_t g = blockIdx.x;
  float* coef = coef_scratch + g * V * M;
  const int64_t GF = G * F;
  const int64_t NGF = N * GF;
  // column j of dvrow: (re, im) of slice j / 2, or with the one-pass
  // instance piece j % 4 of slice j / 4
  auto out_index = [&](int j, int64_t n0, int64_t k) {
    return kMma ? piece_index(j, n0, N, G, g, V, k)
                : (((j & 1) * N + n0 + (j >> 1)) * G + g) * V + k;
  };
  for (int64_t n0 = 0; n0 < N; n0 += NT) {
    const int nt = static_cast<int>(N - n0 < NT ? N - n0 : NT);
    const int ncols = (kMma ? 4 : 2) * nt;
    for (int64_t idx = t; idx < V * M; idx += kThreads) {
      const int j = static_cast<int>(idx / V);
      const int64_t k = idx - j * V;
      const int64_t out = (((j & 1) * N + n0 + (j >> 1)) * G + g) * V + k;
      coef[k * M + j] = (j >> 1) < nt ? coeffs2[out] : 0.f;
    }
    if (kAll || kMma) {
      for (int64_t idx = t; idx < V * ncols; idx += kThreads) {
        const int j = static_cast<int>(idx / V);
        dcoeffs[out_index(j, n0, idx - j * V)] = 0.f;
      }
    }
    __syncthreads();  // coefficients staged, gradient zeroed
    float lacc = 0.f, mrs = 0.f, mis = 0.f;  // thread n < nt: slice n's terms
    for (int64_t f = 0; f < F; ++f) {
      const TC* row = comps + (g * F + f) * V;
      float s[M];
#pragma unroll
      for (int j = 0; j < M; ++j) s[j] = 0.f;
      for (int64_t k = t; k < V; k += kThreads) {
        const float c = to_f32(row[k]);
#pragma unroll
        for (int j = 0; j < M; ++j) s[j] = fmaf(c, coef[k * M + j], s[j]);
      }
      // each warp's sums, then the warps' in a fixed order
#pragma unroll
      for (int j = 0; j < M; ++j) {
        for (int o = 16; o > 0; o >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      }
      if (t % 32 == 0) {
#pragma unroll
        for (int j = 0; j < M; ++j) wsum[t / 32][j] = s[j];
      }
      __syncthreads();
      if (t < nt) {
        float sr = 0.f, si = 0.f;
        for (int q = 0; q < kWarps; ++q) {
          sr += wsum[q][2 * t];
          si += wsum[q][2 * t + 1];
        }
        const int64_t nn = n0 + t;
        const int64_t prow = nn * GF + g * F + f;
        const int64_t drow = nn * d_sn + g * d_sg + f * d_sf;
        const int64_t wrow = nn * w_sn + g * w_sg + f * w_sf;
        const float p_r = pr[prow], p_i = pi[prow];
        const float wv = w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[wrow])
                                : static_cast<const float*>(w)[wrow];
        const float mr = p_r * sr + p_i * si;
        const float mi = -p_i * sr + p_r * si;
        const float er = dr[drow] - mr;
        const float ei = di[drow] - mi;
        lacc += wv * (er * er + ei * ei);
        if constexpr (kTerms == 3) {
          mrs += wv * mr;
          mis += wv * mi;
        }
        if constexpr (kDp) {
          const float dmr = -2.f * wv * er;
          const float dmi = -2.f * wv * ei;
          dpr[prow] = sr * dmr + si * dmi;
          dpi[prow] = si * dmr - sr * dmi;
          if constexpr (kOne) {
            dpr[NGF + prow] = wv * sr;
            dpi[NGF + prow] = wv * si;
          }
          if constexpr (kAll) {
            dvrow[2 * t] = p_r * dmr - p_i * dmi;
            dvrow[2 * t + 1] = p_i * dmr + p_r * dmi;
          }
          if constexpr (kMma) {
            dvrow[4 * t] = p_r * dmr - p_i * dmi;
            dvrow[4 * t + 1] = p_i * dmr + p_r * dmi;
            dvrow[4 * t + 2] = wv * p_r;
            dvrow[4 * t + 3] = wv * p_i;
          }
        }
      }
      if constexpr (kAll || kMma) {
        __syncthreads();  // dv of the row is complete
        for (int64_t k = t; k < V; k += kThreads) {
          const float c = to_f32(row[k]);
          for (int j = 0; j < ncols; ++j) dcoeffs[out_index(j, n0, k)] += c * dvrow[j];
        }
      }
      __syncthreads();  // wsum and dvrow are free for the next row
    }
    if (t < nt) {
      partials[(n0 + t) * G + g] = lacc;
      if (kTerms == 3) {
        partials[(N + n0 + t) * G + g] = mrs;
        partials[(2 * N + n0 + t) * G + g] = mis;
      }
    }
    __syncthreads();  // the coefficients are free for the next slice tile
  }
}

// The one-pass "sum" instances' gradients at the per-slice cotangents cot
// (3, N) = (gx, gr, gi) of (chi2, M_r, M_i), elementwise: with e the
// entries of slice n of a (N, G, F) plane,
//   dpr = gx dpr_chi + gr (w v_r) + gi (w v_i)
//   dpi = gx dpi_chi + gr (w v_i) - gi (w v_r)
// from dpr2 = (dpr_chi, w v_r) and dpi2 = (dpi_chi, w v_i), and with every
// gradient, from pieces (4, N, G, V) = (D_re, D_im, C(w pr), C(w pi)),
//   dcoeffs_re = gx D_re + gr C(w pr) - gi C(w pi)
//   dcoeffs_im = gx D_im + gr C(w pi) + gi C(w pr).
// A grid-stride loop over the planes' entries, then the coefficients'; four
// entries a thread at a time where a slice's span is a whole number of
// 16-byte units (VEC = 4), else one.
template <int VEC>
__global__ void __launch_bounds__(256)
fused_sum_combine_kernel(const float* __restrict__ dpr2, const float* __restrict__ dpi2,
                         const float* __restrict__ pieces, const float* __restrict__ cot,
                         float* __restrict__ dpr, float* __restrict__ dpi,
                         float* __restrict__ dcoeffs, int64_t N, int64_t GF, int64_t GV) {
  using Vec = typename std::conditional<VEC == 4, float4, float>::type;
  const int64_t np = N * GF / VEC, nc = pieces == nullptr ? 0 : N * GV / VEC;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  auto lin = [](const Vec& a, float x, const Vec& b, float y, const Vec& c, float z) {
    if constexpr (VEC == 4) {
      return make_float4(x * a.x + y * b.x + z * c.x, x * a.y + y * b.y + z * c.y,
                         x * a.z + y * b.z + z * c.z, x * a.w + y * b.w + z * c.w);
    } else {
      return x * a + y * b + z * c;
    }
  };
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < np + nc;
       q += step) {
    const bool plane = q < np;
    const int64_t e = plane ? q : q - np;   // in units of VEC
    const int64_t per = (plane ? GF : GV) / VEC;
    const int64_t n = e / per;
    const float gx = cot[n], gr = cot[N + n], gi = cot[2 * N + n];
    if (plane) {
      const Vec* a = reinterpret_cast<const Vec*>(dpr2);
      const Vec* b = reinterpret_cast<const Vec*>(dpi2);
      const int64_t off = N * GF / VEC;
      const Vec chr = a[e], wvr = a[off + e], chi = b[e], wvi = b[off + e];
      reinterpret_cast<Vec*>(dpr)[e] = lin(chr, gx, wvr, gr, wvi, gi);
      reinterpret_cast<Vec*>(dpi)[e] = lin(chi, gx, wvi, gr, wvr, -gi);
    } else {
      const Vec* p = reinterpret_cast<const Vec*>(pieces);
      const int64_t off = N * GV / VEC;
      const Vec dre = p[e], dim = p[off + e], cpr = p[2 * off + e], cpi = p[3 * off + e];
      reinterpret_cast<Vec*>(dcoeffs)[e] = lin(dre, gx, cpr, gr, cpi, -gi);
      reinterpret_cast<Vec*>(dcoeffs)[off + e] = lin(dim, gx, cpi, gr, cpr, gi);
    }
  }
}

// how a launch is laid out (rows == 0: the wide-row kernel)
struct Plan {
  int nt, rows, bulk, pairs, coef_smem;
  size_t smem;
};

// slices per tile: the least power of two >= N, at most 8; then the largest
// row tile (at most half a block: a thread's epilogue holds at most half
// the slices) that lets the instance's blocks share an SM (kMinBlocks;
// blocks_per_sm of the one-pass instance), else one; the coefficients in
// shared memory where they fit (the one-pass instance keeps them there
// before it takes a larger row tile: its dv pairs grow with the rows, and
// phase A reads the coefficients from scratch slower than the tile saves).
// Halves the slice tile when nothing fits, and takes the wide-row kernel
// when not even one row fits.
bool make_plan(long long N, long long F, long long V, int csize, int mode, uintptr_t comps_ptr,
               Plan* plan) {
  for (int nt = N > 4 ? 8 : N > 2 ? 4 : static_cast<int>(N); nt >= 1; nt /= 2) {
    const int m = 2 * nt;
    const size_t per_block = has_mma(mode) ? smem_per_block(blocks_per_sm(mode, nt)) : kPerBlock;
    auto take = [&](int rows, int coef_smem, size_t budget) {
      const Layout L = make_layout(m, rows, V, csize, coef_smem != 0, mode);
      if (L.total > budget) return false;
      plan->nt = nt;
      plan->rows = rows;
      plan->coef_smem = coef_smem;
      plan->smem = L.total;
      const long long rb = static_cast<long long>(rows) * V * csize;
      plan->bulk = comps_ptr % 16 == 0 && rb % 16 == 0 && (F * V * csize) % 16 == 0 &&
                   ((F % rows) * V * csize) % 16 == 0;
      plan->pairs = V % 2 == 0 && (csize == 4 || comps_ptr % 4 == 0);
      return true;
    };
    for (size_t budget : {per_block, kMaxSmem}) {
      if (has_mma(mode)) {
        for (int coef_smem = 1; coef_smem >= 0; --coef_smem) {
          for (int rows = kThreads / 2; rows >= 1; rows /= 2) {
            if (take(rows, coef_smem, budget)) return true;
          }
        }
      } else {
        for (int rows = kThreads / 2; rows >= 1; rows /= 2) {
          for (int coef_smem = 1; coef_smem >= 0; --coef_smem) {
            if (take(rows, coef_smem, budget)) return true;
          }
        }
      }
    }
    if (nt == 1) break;
  }
  *plan = Plan{N > 4 ? 8 : N > 2 ? 4 : static_cast<int>(N), 0, 0, 0, 0, 0};
  return true;
}

template <int NT, typename TC, int MODE>
int launch(const Plan& p, int grid, cudaStream_t s, const void* comps, const float* coeffs2,
           const float* pr, const float* pi, const float* dr, const float* di, int64_t d_sn,
           int64_t d_sg, int64_t d_sf, const void* w, int w_bf16, int64_t w_sn, int64_t w_sg,
           int64_t w_sf, float* partials, float* dcoeffs, float* dpr, float* dpi,
           float* scratch, int64_t N, int64_t G, int64_t F, int64_t V) {
  if (p.rows == 0) {
    fused_chunk_loss_wide<NT, TC, MODE><<<grid, kThreads, 0, s>>>(
        static_cast<const TC*>(comps), coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w, w_bf16,
        w_sn, w_sg, w_sf, partials, dcoeffs, dpr, dpi, scratch, N, G, F, V);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = fused_chunk_loss_kernel<NT, TC, MODE>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, p.smem, s>>>(
      static_cast<const TC*>(comps), coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w, w_bf16, w_sn,
      w_sg, w_sf, partials, dcoeffs, dpr, dpi, scratch, N, G, F, V, p.rows, p.bulk, p.pairs,
      p.coef_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, int MODE, typename... Args>
int launch_nt(const Plan& p, Args... args) {
  switch (p.nt) {
    case 1: return launch<1, TC, MODE>(p, args...);
    case 2: return launch<2, TC, MODE>(p, args...);
    case 4: return launch<4, TC, MODE>(p, args...);
    default: return launch<8, TC, MODE>(p, args...);
  }
}

template <typename TC, typename... Args>
int launch_mode(int mode, const Plan& p, Args... args) {
  switch (mode) {
    case kLossOnly: return launch_nt<TC, kLossOnly>(p, args...);
    case kLossDp: return launch_nt<TC, kLossDp>(p, args...);
    case kLossAll: return launch_nt<TC, kLossAll>(p, args...);
    case kSumFwd: return launch_nt<TC, kSumFwd>(p, args...);
    case kSumFwdDp: return launch_nt<TC, kSumFwdDp>(p, args...);
    default: return launch_nt<TC, kSumFwdAll>(p, args...);
  }
}

}  // namespace

extern "C" {

const char* fcl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan for comps at `comps_ptr`: out = {slices per tile, rows
// per tile (0: the wide-row kernel), bulk copies (1) or cp.async (0), pair
// reads, coefficients in shared memory (1) or in the scratch buffer (0),
// shared-memory bytes}. Returns 0, or cudaErrorInvalidValue for an empty or
// out-of-range shape or a mode this kernel does not have. Where out[4] == 0
// the caller passes a scratch buffer of G * V * 2 * out[0] floats.
int fcl_plan(long long N, long long G, long long F, long long V, int comps_dtype, int mode,
             const void* comps_ptr, long long* out) {
  Plan p;
  if (N <= 0 || G <= 0 || F <= 0 || V <= 0 || N > INT_MAX || G > INT_MAX || F > INT_MAX ||
      !is_mode(mode) ||
      !make_plan(N, F, V, comps_dtype == 0 ? 4 : 2, mode, reinterpret_cast<uintptr_t>(comps_ptr),
                 &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long vals[6] = {p.nt, p.rows, p.bulk, p.pairs, p.coef_smem,
                             static_cast<long long>(p.smem)};
  for (int q = 0; q < 6; ++q) out[q] = vals[q];
  return 0;
}

// comps: (G, F, V) contiguous, float32 (comps_dtype 0) or bfloat16 (1);
// coeffs2: (2, N, G, V) contiguous float32; pr, pi: (N, G, F) contiguous
// float32; dr, di: float32 at dr[n * d_sn + g * d_sg + f * d_sf]; w: float32
// (w_dtype 0) or bfloat16 (1) at w[n * w_sn + g * w_sg + f * w_sf] (strides
// in elements). Outputs, float32 and contiguous: partials (T, N, G), summed
// over G by the caller; for modes 1 and 2 dpr and dpi (N, G, F), for mode 2
// dcoeffs (2, N, G, V): mode 0 is the loss only, 1 the loss with dpr/dpi, 2
// every gradient, each at a loss cotangent of 1 (T = 1: the chi-square).
// Mode 3 is the "sum" forward (T = 3: the chi-square, M_r, M_i); modes 6
// and 7 the same terms with, for the "sum" gradients, dpr = (dpr_chi, w v_r)
// and dpi = (dpi_chi, w v_i), each (2, N, G, F), and with mode 7 dcoeffs =
// (D_re, D_im, C(w pr), C(w pi)), (4, N, G, V) (fused_sum_combine forms the
// gradients from them). scratch: see fcl_plan (may be null otherwise). All
// on the current device. Launches on `stream` and returns the launch's CUDA
// error (0 on success); it does not synchronise.
int fused_chunk_loss(const void* comps, int comps_dtype, const float* coeffs2, const float* pr,
                     const float* pi, const float* dr, const float* di, long long d_sn,
                     long long d_sg, long long d_sf, const void* w, int w_dtype, long long w_sn,
                     long long w_sg, long long w_sf, float* partials, float* dcoeffs, float* dpr,
                     float* dpi, float* scratch, long long N, long long G, long long F,
                     long long V, int mode, void* stream) {
  long long out[6];
  const int err = fcl_plan(N, G, F, V, comps_dtype, mode, comps, out);
  if (err != 0) return err;
  if ((comps_dtype != 0 && comps_dtype != 1) || (w_dtype != 0 && w_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((out[4] == 0 && scratch == nullptr) || partials == nullptr ||
      (has_dp(mode) && (dpr == nullptr || dpi == nullptr)) ||
      ((has_all(mode) || has_mma(mode)) && dcoeffs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{static_cast<int>(out[0]), static_cast<int>(out[1]), static_cast<int>(out[2]),
               static_cast<int>(out[3]), static_cast<int>(out[4]), static_cast<size_t>(out[5])};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(G);
  if (comps_dtype == 0) {
    return launch_mode<float>(mode, p, grid, s, comps, coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf,
                              w, w_dtype, w_sn, w_sg, w_sf, partials, dcoeffs, dpr, dpi, scratch,
                              N, G, F, V);
  }
  return launch_mode<__nv_bfloat16>(mode, p, grid, s, comps, coeffs2, pr, pi, dr, di, d_sn, d_sg,
                                    d_sf, w, w_dtype, w_sn, w_sg, w_sf, partials, dcoeffs, dpr,
                                    dpi, scratch, N, G, F, V);
}

// The "sum" gradients of modes 6 and 7 at the cotangents cot (3, N) of
// (chi2, M_r, M_i): dpr2, dpi2 (2, N, G, F) and pieces (4, N, G, V) as
// fused_chunk_loss wrote them (pieces null: coefficients frozen, no
// dcoeffs), into dpr, dpi (N, G, F) and dcoeffs (2, N, G, V). All float32,
// contiguous, on the current device; launches on `stream`, returns the
// launch's CUDA error.
int fused_sum_combine(const float* dpr2, const float* dpi2, const float* pieces,
                      const float* cot, float* dpr, float* dpi, float* dcoeffs, long long N,
                      long long G, long long F, long long V, void* stream) {
  if (N <= 0 || G <= 0 || F <= 0 || V <= 0 || dpr2 == nullptr || dpi2 == nullptr ||
      cot == nullptr || dpr == nullptr || dpi == nullptr ||
      (pieces != nullptr && dcoeffs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long GF = G * F, GV = G * V;
  uintptr_t bits = 0;
  for (const void* ptr : {static_cast<const void*>(dpr2), static_cast<const void*>(dpi2),
                          static_cast<const void*>(pieces), static_cast<const void*>(dpr),
                          static_cast<const void*>(dpi), static_cast<const void*>(dcoeffs)})
    bits |= reinterpret_cast<uintptr_t>(ptr);
  const bool vec = bits % 16 == 0 && GF % 4 == 0 && (pieces == nullptr || GV % 4 == 0);
  const long long work = (N * GF + (pieces == nullptr ? 0 : N * GV)) / (vec ? 4 : 1);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (work + 255) / 256;
  const int grid = static_cast<int>(blocks < 8LL * sms ? blocks : 8LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    fused_sum_combine_kernel<4><<<grid, 256, 0, s>>>(dpr2, dpi2, pieces, cot, dpr, dpi, dcoeffs,
                                                     N, GF, GV);
  } else {
    fused_sum_combine_kernel<1><<<grid, 256, 0, s>>>(dpr2, dpi2, pieces, cot, dpr, dpi, dcoeffs,
                                                     N, GF, GV);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
