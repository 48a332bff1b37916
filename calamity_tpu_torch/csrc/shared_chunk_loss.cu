// Weighted chi-square of one shared-basis chunk, with its gradients, for a
// batch of N (time, pol) slices, for Hopper (sm_90a), both of its products
// on the tensor cores at float32 accuracy.
//
// Replaces the XLA operations the JAX package runs for a shared (U = 1) or
// shared-batched (1 < U < G) chunk: the shared branches of `fg_model` and
// `fg_model_batched` (calamity_tpu/ops/loss.py:62-81, :108-121),
// `data_model` (:199-205), `mse` (:208-216) and their transposes under
// `jax.grad`. There is no Pallas kernel for these; the dense chunk's Pallas
// kernel (`_fwd_kernel`, calamity_tpu/ops/fused.py:152-185) is
// csrc/fused_chunk_loss.cu. Group g of a chunk with U operators uses
// operator u = g / gmax (gmax = G / U: groups are laid out class-major).
// Per (slice n, group g, channel f):
//
//   v_r     = sum_k comps[u, f, k] * coeffs2[0, n, g, k]     (v_i: coeffs2[1])
//   m_r     =  pr * v_r + pi * v_i,   m_i = -pi * v_r + pr * v_i
//   loss    = w * ((dr - m_r)^2 + (di - m_i)^2)
// and, at a loss cotangent of 1 (the autograd Function scales by each
// slice's cotangent afterwards):
//   dm      = -2 w (d - m)
//   dpr     = v_r dm_r + v_i dm_i,   dpi = v_i dm_r - v_r dm_i
//   dv_r    = pr dm_r - pi dm_i,     dv_i = pi dm_r + pr dm_i
//   dcoeffs[k, n, g, :] = sum_f comps[u, f, :] * dv_k[n, g, f]
// Three instances of one template, as for the dense kernel: the loss only;
// the loss with dpr/dpi (coefficients frozen); the loss with every gradient.
// And, as there, three for the "sum" flux prior: its forward (the loss-only
// pass that also sums M_r = sum w m_r and M_i = sum w m_i per pair, carried
// through the cluster's fixed-order sum beside the loss), and its backward
// with dpr/dpi or every gradient at per-slice cotangents (gx, gr, gi) of
// (chi2, M_r, M_i), which only change dm (dm = w (g - 2 gx (d - m))) and
// write no loss. A pair's cotangents are staged once in shared memory, in
// the unread columns past its coefficient row.
//
// Precision: split TF32. Both products run on the tensor cores with TF32
// operands (`mma.sync.m16n8k8`; past 64 modes the model on
// `wgmma.mma_async.m64n32k8`), each float32 operand x split into hi =
// tf32(x) and lo = tf32(x - hi) (`cvt.rna.tf32.f32`, or past 64 modes the
// same rounding on the bits; the subtraction is exact), and each product
// accumulated as a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms first, a
// k-step of 8 at a time) into a float32 accumulator: three products. hi +
// lo holds x to about
// 2^-22 and the dropped a_lo b_lo is about 2^-22 of the product, so a
// product is good to about 2^-21 relative (float32: 2^-24), inside the
// tolerances the kernel is held to (loss rel 1e-5, gradients rel 1e-4). A
// bfloat16 comps value is exact in TF32, so only the other operand is split:
// two products. A single TF32 product (about 1e-3) would poison the fit's
// floor, as the reference's `Precision.HIGHEST` (loss.py:40-43) guards
// against; these split products are the port's only TF32, and
// `allow_tf32` stays off everywhere else. Everything outside the products
// (model, residual, loss, dm, dpr, dpi, dv) is float32 on CUDA cores.
//
// What bounds it. The least time is set by bytes: each (slice, group,
// channel) entry reads pr, pi, dr, di and w and writes dpr and dpi (28
// bytes, float32): at the HERA core's four chunks (4388 groups that hold a
// baseline, 1536 channels, N = 1) 0.23 GB, 0.069 ms at 3.35 TB/s. The
// split products are 4 V multiply-adds an entry times three, about 0.02 ms
// at the tensor cores' 495 TFLOP/s (`mma.sync` reaches only part of that
// rate). The basis is small (one operator serves up to 2048 groups) and
// stays in L2.
// What holds this design from the bytes is issue and latency: a warp's
// tile is a chain of shared-memory reads, splits (seven instructions each),
// `mma`s and plane loads, and 168 registers a thread leave three blocks
// (twelve warps) an SM to hide it; keeping split operands in shared memory
// trades ALU work for shared-memory reads, which pays for bfloat16 comps'
// coefficients only (PERF.md).
//
// Why `mma.sync` here: with the products off the CUDA cores this kernel is
// bound by bytes and issue, and `mma.sync` lets both products run on
// fragments held in registers (below), which `wgmma`'s warpgroup tiles
// would not. The coefficient gradient stays on `mma.sync` in both kernels:
// `wgmma` takes TF32 operands from shared memory only K-major (only 16-bit
// types may be transposed), and its comps operand, with K running over
// channels, is M-major in the staged (channel, mode) tile.
//
// Design: every (group, slice) pair of an operator is independent but for
// the operator it reads, so a block takes one operator and a tile of 32
// pairs and walks its channels, 32 a tile. Each of its four warps owns 8
// pairs: an m16 row tile of 8 real and 8 imaginary coefficient rows.
// - Phase A (the model) is, per warp and tile, (16 rows x V) x (V x 32
//   channels): A is the coefficients, staged once per block in shared
//   memory by `cp.async` (with the first comps tile), B is the comps tile.
//   With bfloat16 comps (and V <= 64) the coefficients are split once into
//   (hi, lo) pairs in shared memory; with float32 comps both operands are
//   split where they are read, which measured faster (the pairs double the
//   shared-memory reads of a k-step, and float32 comps' own split leaves
//   the shared memory the scarcer resource).
//   In the accumulator a thread holds, for one pair, the real part (row g)
//   and the imaginary part (row g + 8) of the model at columns 2t and 2t +
//   1 of each n8 tile: the epilogue (m, the loss, dm, dpr/dpi, dv) runs on
//   those fragments in registers. The tile's channels are stored in the
//   ring in an order (`tile_row`) that makes a thread's eight entries two
//   runs of four adjacent channels, so its planes are read and dpr/dpi
//   written 16 bytes at a time, a pair's 128-byte row by four lanes. The
//   next tile's planes are loaded right after the epilogue, so their
//   latency hides behind phase B, the barrier and phase A.
// - Phase B (the coefficient gradient) is, per warp and tile, (16 rows x 32
//   channels) x (32 channels x V). Its A operand is dv^T, and the thread
//   holds exactly that fragment: reading the k index t as channel 2t and t
//   + 4 as channel 2t + 1 (a sum over channels may take them in any fixed
//   order), the epilogue's dv registers are phase B's A fragment. So dv
//   never goes through shared memory, and the warps share nothing but the
//   read-only comps tile and coefficients: one barrier a tile. The
//   accumulator (16 rows x 64 modes) stays in registers across the block's
//   channel loop.
// - The comps tile is staged in its own dtype (bfloat16 stays bfloat16 and
//   is widened on the read, exactly) by `cp.async` 16-byte copies in a ring
//   of two tiles: the next tile loads while this one computes. Rows of the
//   ring and of the coefficients are an odd number of 16-byte units long,
//   so every fragment read (row g and column t in phase A, row 2t and
//   column g in phase B) falls in distinct banks. Where a row is not a
//   whole number of 16-byte units, it is copied by plain loads. The
//   tensor-core tiles read whole k-steps and all 32 rows, so the modes past
//   V up to a multiple of 8 and, in the last tile, the rows past F are
//   zeros (and the coefficients past V and the dv of channels past F are
//   zeros too).
// - A table of the block's 32 pairs (slice, group, whether the operator
//   has it, whether it holds a baseline) is built once in shared memory, so
//   no thread divides by N in the loops.
// - A tile of pairs is split over the channels among a thread-block
//   cluster of up to 8 blocks, doubled while the launch has fewer than 8
//   blocks an SM (a chunk has 32 to 96 tiles of pairs at the HERA core's
//   shapes at N = 1). Each block keeps its part of the losses and of the
//   coefficient gradient in shared memory; after a cluster barrier each
//   block sums a share of the entries over the cluster's blocks in split
//   order, reading their shared memory (DSMEM), and writes them once.
// - Padding groups (the packing's record of which groups hold a baseline,
//   `valid`): their planes are not read and their loss, dpr, dpi and
//   dcoeffs come out zero; a block whose pairs are all padding writes its
//   zeros and leaves.
// - Every sum is taken in a fixed order and nothing uses atomics: the
//   per-pair loss partials are summed over a block's channels by a fixed
//   shuffle tree, over the cluster in split order and over groups by the
//   caller, and each `mma` sums in a fixed order, so two launches are equal
//   to the bit.
// That design holds V <= 64, the register tile (`kCapacity`), in one block.
//
// Past 64 modes (`shared_chunk_loss_sliced`, below) the modes are sliced
// over the blocks of a cluster: ceil(V / 64) blocks take a tile of pairs,
// block r the modes [64 r, 64 r + 64), so a block's shared memory and its
// registers do not grow with V. Each float32 operand is split into its TF32
// halves once, where it is staged in shared memory: the block's slice of
// the coefficients once a launch, each 32-channel comps tile once, by one
// pass of the block over the tile it fetched into registers a tile ahead
// (bfloat16 comps are only widened). Both are staged K-major (the modes
// contiguous) in `wgmma`'s layout without swizzle, so per channel tile
// phase A, the slice's part of the model of the 32 pairs, (64 coefficient
// rows x 64 modes) x (64 modes x 32 channels), is 24 `wgmma`s (16 with
// bfloat16 comps) of the warpgroup reading the halves through shared-memory
// descriptors, and leaves the model in shared memory; after a cluster
// barrier each block runs the epilogue (m, the loss, dm, dpr/dpi, dv) of
// its share of the pairs, the model summed over the slices in rank order
// through DSMEM, each plane entry read once and dpr/dpi written once, and
// leaves the dv of its pairs in shared memory; after a second barrier phase
// B reads the dv of its warps' pairs from the blocks that own them, splits
// it (dv changes every tile), and adds the staged comps halves into its
// 64-mode register tile of dcoeffs on `mma.sync`, written once at the end:
// nothing is summed in global memory. A chunk of few tiles of pairs also
// splits its channels over the cluster (up to 16 blocks, non-portable past
// 8), the splits summed in split order at the end as above. Shared memory
// (comps halves 16.5 KB float32 or 8.3 KB bfloat16, coefficient halves 32
// KB, exchange buffers 15 KB: 64.3 / 56 KB) and registers (162 / 128) leave
// three blocks an SM with float32 comps and four with bfloat16.
// What holds it from its bound is latency, not issue: a block's channel
// tile is one chain (stage, `wgmma`, cluster barrier, epilogue, cluster
// barrier, phase B) that twelve to sixteen warps an SM do not hide. Clock
// stamps of a timing-only build (PERF.md) put a float32 round at about
// 10,600 cycles: phase B on `mma.sync` 27%, the epilogue with its DSMEM
// reads 20%, the two cluster barriers 32%, `wgmma` 13%, staging 6%.
// Any N, G, F and V up to 1024 (a cluster of 16 slices) are taken; the gate
// in ops/shared.py leaves wider bases to the torch ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;            // four warps
constexpr int kMinBlocks = 3;            // blocks an SM: 168 registers (2 and 4 measured slower)
constexpr int kPairs = 32;               // (group, slice) pairs a block
constexpr int kCols = 2 * kPairs;        // coefficient columns: (re, im) of each pair
constexpr int kRows = 32;                // channels a tile
constexpr int kWarpPairs = 8;            // pairs a warp: one m16 tile of (re, im) rows
constexpr int kModeTiles = 8;            // phase B: n8 tiles of modes held in registers
constexpr int kCapacity = 8 * kModeTiles;  // modes held in registers

// the chi-square's instances (0-2) and the "sum" prior's (3-5)
enum Mode { kLossOnly = 0, kLossDp = 1, kLossAll = 2, kSumFwd = 3, kSumDp = 4, kSumAll = 5 };

__host__ __device__ constexpr bool has_dp(int mode) {
  return mode == kLossDp || mode == kLossAll || mode >= kSumDp;
}
__host__ __device__ constexpr bool has_all(int mode) { return mode == kLossAll || mode == kSumAll; }
__host__ __device__ constexpr bool has_cot(int mode) { return mode >= kSumDp; }
// the partial sums an instance writes per (slice, group): the chi-square;
// the "sum" forward also M_r and M_i; the "sum" backward none
__host__ __device__ constexpr int n_terms(int mode) {
  return mode == kSumFwd ? 3 : mode >= kSumDp ? 0 : 1;
}

// V rounded up to whole k-steps of 8 modes
__host__ __device__ constexpr long long modes8(long long V) { return (V + 7) / 8 * 8; }

// the comps tile's row stride in elements: at least modes8(V), an odd number
// of 16-byte units (the fragment reads of both products in distinct banks)
__host__ __device__ constexpr long long row_stride(long long V, int csize) {
  const long long unit = 16 / csize;
  long long rs = (modes8(V) + unit - 1) / unit * unit;
  if ((rs / unit) % 2 == 0) rs += unit;
  return rs;
}

// the coefficients' row stride in floats: an odd number of 16-byte units
// (phase A's fragment reads, row g and column t, in distinct banks)
__host__ __device__ inline long long coef_stride(long long V) { return modes8(V) + 4; }

constexpr int kTableBytes = 3 * kPairs * 4;  // the pair table: slice, group, flags

__host__ __device__ inline size_t smem_bytes(long long V, int csize, int stages) {
  return static_cast<size_t>(stages) * kRows * row_stride(V, csize) * csize +
         static_cast<size_t>(kCols) * coef_stride(V) * 4 + kTableBytes;
}

// with the coefficients split once in shared memory (V <= 64): a ring of
// two tiles, the coefficients as TF32 (hi, lo) pairs, the table, and the
// raw coefficients they are split from
__host__ __device__ inline size_t smem_bytes_pre(long long V, int csize) {
  return smem_bytes(V, csize, 2) + static_cast<size_t>(kCols) * coef_stride(V) * 8;
}

// the ring's row of channel r of a tile: r = 16 h + 4 a + 2 l + c goes to
// row 16 h + 8 l + 2 a + c, so that the accumulator entries a thread holds
// (its column pair 2 a + c of n-tiles 2 h + l) are four adjacent channels
// twice, read and written 16 bytes at a time
__device__ __forceinline__ int tile_row(int r) {
  return (r & 17) | ((r & 2) << 2) | ((r & 12) >> 1);
}

__device__ __forceinline__ float load_w(const void* w, int w_bf16, int64_t i) {
  return w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i])
                : static_cast<const float*>(w)[i];
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TC>
__device__ __forceinline__ TC zero_of() {
  if constexpr (std::is_same<TC, float>::value) {
    return 0.f;
  } else {
    return __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x = hi + lo in TF32: hi = tf32(x) (its low 13 bits cleared, so that x - hi
// is exact), lo = tf32(x - hi). kInt rounds on the bits, to nearest with
// ties away from zero as `cvt.rna.tf32.f32` does (the same bits for every
// finite x short of float32's largest): an integer add and mask, then
// fma(x, 0, hi), which leaves a finite x's hi as it is and makes hi a NaN
// where x is a NaN or an infinity (rounding a NaN's bits can carry into the
// sign bit and leave a zero); lo needs no such care, as x - hi is finite
// wherever hi is. The sliced kernel's choice (PERF.md); without kInt
// `cvt.rna.tf32.f32` rounds: the V <= 64 kernel keeps the instruction it
// was designed and timed with
template <bool kInt = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kInt) {
    const float h = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
    hi = __float_as_uint(fmaf(x, 0.f, h));
    lo = (__float_as_uint(x - h) + 0x1000u) & 0xffffe000u;
  } else {
    uint32_t h, l;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
    h &= 0xffffe000u;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - __uint_as_float(h)));
    hi = h;
    lo = l;
  }
}

// d += a b on one m16n8k8 tile, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at float32 accuracy: a given split; b (comps) split for float32
// comps, three products small terms first; a bfloat16 b is exact in TF32,
// two products
template <typename TC>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], float b0, float b1) {
  if constexpr (std::is_same<TC, float>::value) {
    uint32_t b0h, b0l, b1h, b1l;
    split_tf32(b0, b0h, b0l);
    split_tf32(b1, b1h, b1l);
    mma_tf32(d, alo, b0h, b1h);
    mma_tf32(d, ahi, b0l, b1l);
    mma_tf32(d, ahi, b0h, b1h);
  } else {
    mma_tf32(d, alo, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(d, ahi, __float_as_uint(b0), __float_as_uint(b1));
  }
}

template <bool kInt = false>
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32<kInt>(a0, hi[0], lo[0]);
  split_tf32<kInt>(a1, hi[1], lo[1]);
  split_tf32<kInt>(a2, hi[2], lo[2]);
  split_tf32<kInt>(a3, hi[3], lo[3]);
}

template <typename TC, int MODE, bool kPre>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
shared_chunk_loss_kernel(const TC* __restrict__ comps, const float* __restrict__ coeffs2,
                         const float* __restrict__ pr, const float* __restrict__ pi,
                         const float* __restrict__ dr, const float* __restrict__ di,
                         int64_t d_sn, int64_t d_sg, int64_t d_sf, const void* __restrict__ w,
                         int w_bf16, int64_t w_sn, int64_t w_sg, int64_t w_sf,
                         const unsigned char* __restrict__ valid, float* __restrict__ partials,
                         float* __restrict__ dcoeffs, float* __restrict__ dpr,
                         float* __restrict__ dpi, const float* __restrict__ cot, int64_t N,
                         int64_t G, int64_t F, int64_t V, int64_t gmax, int blocks_per_op,
                         int stages, int vec16, int /* slices: 1 */, int splits) {
  constexpr bool kDp = has_dp(MODE);
  constexpr bool kAll = has_all(MODE);
  constexpr bool kCot = has_cot(MODE);
  constexpr int kTerms = n_terms(MODE);
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row group and column pair
  const int Vs = static_cast<int>(V);
  const int V8 = static_cast<int>(modes8(V));
  const int nks = V8 / 8;  // k-steps of phase A; mode tiles of phase B
  const int RS = static_cast<int>(row_stride(V, sizeof(TC)));
  const int CS = static_cast<int>(coef_stride(V));
  const size_t tile_bytes = static_cast<size_t>(kRows) * RS * sizeof(TC);
  // the coefficients: raw floats, or with kPre (hi, lo) pairs split once
  float* coef = reinterpret_cast<float*>(smem + stages * tile_bytes);
  int* tab = reinterpret_cast<int*>(coef + kCols * CS * (kPre ? 2 : 1));
  // where the coefficients are copied to: with kPre, after the table
  float* raw = kPre ? reinterpret_cast<float*>(tab + 3 * kPairs) : coef;

  // a cluster of `splits` blocks takes one tile of pairs; block `split` of it
  // the channel tiles [jt0, jt1)
  const int split = blockIdx.x % splits;
  const int pair_tile = blockIdx.x / splits;
  const int64_t u = pair_tile / blocks_per_op;
  const int64_t q0 = static_cast<int64_t>(pair_tile % blocks_per_op) * kPairs;
  const int64_t GF = G * F;
  const TC* op = comps + u * F * V;
  const int ntiles = static_cast<int>((F + kRows - 1) / kRows);
  const int jt0 = split * ntiles / splits, jt1 = (split + 1) * ntiles / splits;

  // the pair table: pair p of the block (the operator's pairs are
  // group-major) is slice tab[p] of group tab[32 + p]; tab[64 + p] has bit 1
  // where the operator has the pair and bit 2 where its group holds a
  // baseline. A block of padding only writes its zeros.
  {
    bool mine = false;
    if (t < kPairs) {
      const int64_t q = q0 + t;
      const int g = static_cast<int>(u * gmax + q / N);
      const bool in = q < gmax * N;
      mine = in && (valid == nullptr || valid[g]);
      tab[t] = static_cast<int>(q % N);
      tab[kPairs + t] = g;
      tab[2 * kPairs + t] = (in ? 1 : 0) | (mine ? 2 : 0);
    }
    if (!__syncthreads_or(mine)) {
      for (int p = 0; p < kPairs && split == 0; ++p) {
        if (!(tab[2 * kPairs + p] & 1)) break;
        const int64_t n = tab[p], g = tab[kPairs + p];
        if (t == 0) {
          for (int c = 0; c < kTerms; ++c) partials[(c * N + n) * G + g] = 0.f;
        }
        if constexpr (kDp) {
          for (int64_t f = t; f < F; f += kThreads) {
            dpr[n * GF + g * F + f] = 0.f;
            dpi[n * GF + g * F + f] = 0.f;
          }
        }
        if constexpr (kAll) {
          for (int64_t k = t; k < V; k += kThreads) {
            dcoeffs[(n * G + g) * V + k] = 0.f;
            dcoeffs[((N + n) * G + g) * V + k] = 0.f;
          }
        }
      }
      return;
    }
  }
  auto in_op = [&](int p) { return (tab[2 * kPairs + p] & 1) != 0; };
  // pair p's cotangents (-2 gx, gr, gi) in the columns past its real
  // coefficient row that no product reads (V8 to V8 + 3)
  auto cot_of = [&](int p) {
    return kPre ? coef + 2 * (p * CS + V8) : coef + p * CS + V8;
  };
  if constexpr (kCot) {
    if (t < kPairs) {
      const int64_t n = tab[t];
      float* c = cot_of(t);
      c[0] = -2.f * cot[n];
      c[1] = cot[N + n];
      c[2] = cot[2 * N + n];
    }
  }
  auto coef_row = [&](int row) {  // row = part * 32 + p: the pair's coefficients in coeffs2
    return coeffs2 + ((row / kPairs * N + tab[row % kPairs]) * G + tab[kPairs + row % kPairs]) * V;
  };

  // the block's coefficients, (64 rows: re then im of each pair) x CS: by
  // 16-byte copies (with the first comps tile) where rows are whole 16-byte
  // units; zero past V and for pairs the operator does not have
  if ((V & 3) == 0 && (reinterpret_cast<uintptr_t>(coeffs2) & 15) == 0) {
    const int per_row = Vs / 4;
    for (int q = t; q < kCols * per_row; q += kThreads) {
      const int row = q / per_row, c = q - row * per_row;
      if (in_op(row % kPairs)) cp_async16(raw + row * CS + 4 * c, coef_row(row) + 4 * c);
    }
  } else {
    for (int q = t; q < kCols * Vs; q += kThreads) {
      const int row = q / Vs, k = q - row * Vs;
      if (in_op(row % kPairs)) raw[row * CS + k] = coef_row(row)[k];
    }
  }
  if (V8 > Vs) {
    for (int q = t; q < kCols * (V8 - Vs); q += kThreads) {
      raw[(q / (V8 - Vs)) * CS + Vs + q % (V8 - Vs)] = 0.f;
    }
  }
  if (!in_op(kPairs - 1)) {  // the operator's last tile of pairs, cut short
    for (int q = t; q < kCols * Vs; q += kThreads) {
      const int row = q / Vs;
      if (!in_op(row % kPairs)) raw[row * CS + q % Vs] = 0.f;
    }
  }
  // the ring's modes past V (read by phase A's last k-step) stay zero
  if (V8 > Vs) {
    TC* ring = reinterpret_cast<TC*>(smem);
    for (int idx = t; idx < stages * kRows * (V8 - Vs); idx += kThreads) {
      ring[(idx / (V8 - Vs)) * RS + Vs + idx % (V8 - Vs)] = zero_of<TC>();
    }
  }

  // this thread's pair in the epilogue and phase B: rows g (re) and g + 8
  // (im) of its warp's tile; its entries of a tile are channels f0 + 4 tig
  // + [0, 4) and f0 + 16 + 4 tig + [0, 4) (see `tile_row`)
  const int pe = warp * kWarpPairs + gid;
  const int eflags = tab[2 * kPairs + pe];
  const bool ein = eflags & 1, eok = eflags & 2;
  const int64_t en = tab[pe], eg = tab[kPairs + pe];
  const float* pr_row = pr + en * GF + eg * F;
  const float* pi_row = pi + en * GF + eg * F;
  const float* dr_row = dr + en * d_sn + eg * d_sg;
  const float* di_row = di + en * d_sn + eg * d_sg;
  const int64_t w_row = en * w_sn + eg * w_sg;
  // 16-byte plane reads and dpr/dpi writes where rows and strides allow
  const bool vec4 = (F & 3) == 0;
  const bool dvec = d_sf == 1 && ((d_sn | d_sg) & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(dr) | reinterpret_cast<uintptr_t>(di)) & 15) == 0;
  const bool wvec = w_sf == 1 && ((w_sn | w_sg) & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(w) & (w_bf16 ? 7 : 15)) == 0;

  // the comps tile jt into its stage, channel r at row tile_row(r); rows
  // past F zeroed
  auto issue = [&](int jt) {
    if (jt < jt1) {
      const int64_t f0 = static_cast<int64_t>(jt) * kRows;
      const int rows = static_cast<int>(F - f0 < kRows ? F - f0 : kRows);
      TC* dst = reinterpret_cast<TC*>(smem + ((jt - jt0) % stages) * tile_bytes);
      const TC* src = op + f0 * V;
      if (vec16) {
        const int per_row = static_cast<int>(V * sizeof(TC) / 16);
        for (int q = t; q < rows * per_row; q += kThreads) {
          const int r = q / per_row, c = q - r * per_row;
          cp_async16(reinterpret_cast<unsigned char*>(dst + tile_row(r) * RS) + 16 * c,
                     reinterpret_cast<const unsigned char*>(src + r * V) + 16 * c);
        }
      } else {
        for (int q = t; q < rows * Vs; q += kThreads) {
          const int r = q / Vs, k = q - r * Vs;
          dst[tile_row(r) * RS + k] = src[static_cast<int64_t>(r) * V + k];
        }
      }
      for (int q = t; q < (kRows - rows) * V8; q += kThreads) {
        dst[tile_row(rows + q / V8) * RS + q % V8] = zero_of<TC>();
      }
    }
    cp_async_commit();  // one group a tile, empty past the last
  };

  // this thread's planes of tile jt: entry 4 h + c is channel f0 + 16 h + 4
  // tig + c; zeros past F and for padding
  float p_r[8], p_i[8], d_r[8], d_i[8], wv[8];
  auto load_planes = [&](int jt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) p_r[j] = p_i[j] = d_r[j] = d_i[j] = wv[j] = 0.f;
    if (!eok) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t fb = static_cast<int64_t>(jt) * kRows + 16 * h + 4 * tig;
      if (fb + 3 < F) {
        if (vec4) {
          const float4 a = *reinterpret_cast<const float4*>(pr_row + fb);
          const float4 b = *reinterpret_cast<const float4*>(pi_row + fb);
          p_r[4 * h] = a.x, p_r[4 * h + 1] = a.y, p_r[4 * h + 2] = a.z, p_r[4 * h + 3] = a.w;
          p_i[4 * h] = b.x, p_i[4 * h + 1] = b.y, p_i[4 * h + 2] = b.z, p_i[4 * h + 3] = b.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            p_r[4 * h + c] = pr_row[fb + c];
            p_i[4 * h + c] = pi_row[fb + c];
          }
        }
        if (dvec) {
          const float4 a = *reinterpret_cast<const float4*>(dr_row + fb);
          const float4 b = *reinterpret_cast<const float4*>(di_row + fb);
          d_r[4 * h] = a.x, d_r[4 * h + 1] = a.y, d_r[4 * h + 2] = a.z, d_r[4 * h + 3] = a.w;
          d_i[4 * h] = b.x, d_i[4 * h + 1] = b.y, d_i[4 * h + 2] = b.z, d_i[4 * h + 3] = b.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            d_r[4 * h + c] = dr_row[(fb + c) * d_sf];
            d_i[4 * h + c] = di_row[(fb + c) * d_sf];
          }
        }
        if (wvec && !w_bf16) {
          const float4 a =
              *reinterpret_cast<const float4*>(static_cast<const float*>(w) + w_row + fb);
          wv[4 * h] = a.x, wv[4 * h + 1] = a.y, wv[4 * h + 2] = a.z, wv[4 * h + 3] = a.w;
        } else if (wvec) {
          const uint2 a = *reinterpret_cast<const uint2*>(
              static_cast<const __nv_bfloat16*>(w) + w_row + fb);
          wv[4 * h] = __uint_as_float(a.x << 16);  // bfloat16 to float32: the high half
          wv[4 * h + 1] = __uint_as_float(a.x & 0xffff0000u);
          wv[4 * h + 2] = __uint_as_float(a.y << 16);
          wv[4 * h + 3] = __uint_as_float(a.y & 0xffff0000u);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) wv[4 * h + c] = load_w(w, w_bf16, w_row + (fb + c) * w_sf);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (fb + c < F) {
            p_r[4 * h + c] = pr_row[fb + c];
            p_i[4 * h + c] = pi_row[fb + c];
            d_r[4 * h + c] = dr_row[(fb + c) * d_sf];
            d_i[4 * h + c] = di_row[(fb + c) * d_sf];
            wv[4 * h + c] = load_w(w, w_bf16, w_row + (fb + c) * w_sf);
          }
        }
      }
    }
  };

  float lacc = 0.f, mracc = 0.f, miacc = 0.f;
  float bacc[kModeTiles][4];
#pragma unroll
  for (int i = 0; i < kModeTiles; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bacc[i][j] = 0.f;
  }
  const float* ca = coef + pe * CS + tig;  // phase A's A fragments: re, im rows of the pair
  const float2* ca2 = reinterpret_cast<const float2*>(coef) + pe * CS + tig;

  load_planes(jt0);
  issue(jt0);
  if constexpr (kPre) {
    // the coefficients split once, into (hi, lo) pairs
    cp_async_wait_all();
    __syncthreads();
    float2* c2 = reinterpret_cast<float2*>(coef);
    for (int row = warp; row < kCols; row += kThreads / 32) {
      for (int k = lane; k < V8; k += 32) {
        uint32_t hi, lo;
        split_tf32(raw[row * CS + k], hi, lo);
        c2[row * CS + k] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
      }
    }
  }
  for (int jt = jt0; jt < jt1; ++jt) {
    const int64_t f0 = static_cast<int64_t>(jt) * kRows;
    cp_async_wait_all();
    __syncthreads();  // tile jt (and, first, the coefficients) in; tile jt - 1 done with
    if (stages > 1) issue(jt + 1);
    const TC* tile = reinterpret_cast<const TC*>(smem + ((jt - jt0) % stages) * tile_bytes);

    // phase A: the model of the warp's 8 pairs at the tile's 32 channels,
    // over the modes in k-steps of 8
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    if constexpr (kPre) {
      const int b0 = gid * RS + tig;
#pragma unroll 2
      for (int s = 0; s < nks; ++s) {
        const float2* a = ca2 + 8 * s;
        const float2 x0 = a[0], x1 = a[kPairs * CS], x2 = a[4], x3 = a[kPairs * CS + 4];
        const uint32_t ahi[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                 __float_as_uint(x2.x), __float_as_uint(x3.x)};
        const uint32_t alo[4] = {__float_as_uint(x0.y), __float_as_uint(x1.y),
                                 __float_as_uint(x2.y), __float_as_uint(x3.y)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int b = b0 + 8 * nt * RS + 8 * s;
          mma_split<TC>(acc[nt], ahi, alo, to_f32(tile[b]), to_f32(tile[b + 4]));
        }
      }
    } else {
      const TC* bcol = tile + gid * RS + tig;
#pragma unroll 2
      for (int s = 0; s < nks; ++s) {
        const float* a = ca + 8 * s;
        uint32_t ahi[4], alo[4];
        split4(a[0], a[kPairs * CS], a[4], a[kPairs * CS + 4], ahi, alo);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const TC* b = bcol + 8 * nt * RS + 8 * s;
          mma_split<TC>(acc[nt], ahi, alo, to_f32(b[0]), to_f32(b[4]));
        }
      }
    }

    // epilogue, on the fragments: in n-tile nt, row g is v_r and row g + 8
    // v_i of the pair, column 2 tig + c its entry 2 nt + c
    float dvr[4][2], dvi[4][2], gr[8], gi[8];
    float cx = 0.f, cr = 0.f, ci = 0.f;  // the "sum" backward's cotangents of the pair
    if constexpr (kCot) {
      const float* c = cot_of(pe);
      cx = c[0];
      cr = c[1];
      ci = c[2];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nt = j >> 1, c = j & 1;
      const bool ok = eok && f0 + 16 * (j >> 2) + 4 * tig + (j & 3) < F;
      const float sr = acc[nt][c], si = acc[nt][2 + c];
      const float mr = p_r[j] * sr + p_i[j] * si;
      const float mi = -p_i[j] * sr + p_r[j] * si;
      const float er = d_r[j] - mr;
      const float ei = d_i[j] - mi;
      if (ok && kTerms > 0) lacc += wv[j] * (er * er + ei * ei);
      if (ok && kTerms == 3) {
        mracc += wv[j] * mr;
        miacc += wv[j] * mi;
      }
      float dmr = ok ? -2.f * wv[j] * er : 0.f;
      float dmi = ok ? -2.f * wv[j] * ei : 0.f;
      if constexpr (kCot) {
        dmr = ok ? wv[j] * fmaf(cx, er, cr) : 0.f;
        dmi = ok ? wv[j] * fmaf(cx, ei, ci) : 0.f;
      }
      gr[j] = sr * dmr + si * dmi;
      gi[j] = si * dmr - sr * dmi;
      dvr[nt][c] = p_r[j] * dmr - p_i[j] * dmi;
      dvi[nt][c] = p_i[j] * dmr + p_r[j] * dmi;
    }
    if constexpr (kDp) {
      if (ein) {
        float* const dpr_row = dpr + en * GF + eg * F;
        float* const dpi_row = dpi + en * GF + eg * F;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t fb = f0 + 16 * h + 4 * tig;
          if (vec4 && fb + 3 < F) {
            *reinterpret_cast<float4*>(dpr_row + fb) =
                make_float4(gr[4 * h], gr[4 * h + 1], gr[4 * h + 2], gr[4 * h + 3]);
            *reinterpret_cast<float4*>(dpi_row + fb) =
                make_float4(gi[4 * h], gi[4 * h + 1], gi[4 * h + 2], gi[4 * h + 3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (fb + c < F) {
                dpr_row[fb + c] = gr[4 * h + c];
                dpi_row[fb + c] = gi[4 * h + c];
              }
            }
          }
        }
      }
    }
    // the next tile's planes, in flight through phase B, the barrier and
    // phase A
    if (jt + 1 < jt1) load_planes(jt + 1);

    if constexpr (kAll) {
      // phase B: dcoeffs^T += dv^T comps over the tile's channels; the k
      // index t is the tile's row 8 nt + 2 t and t + 4 its row 8 nt + 2 t +
      // 1, so the A fragment is this thread's dv
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t ahi[4], alo[4];
        split4(dvr[nt][0], dvi[nt][0], dvr[nt][1], dvi[nt][1], ahi, alo);
        const int b = (8 * nt + 2 * tig) * RS + gid;
#pragma unroll
        for (int mt = 0; mt < kModeTiles; ++mt) {
          if (mt >= nks) continue;
          const int m = b + 8 * mt;
          mma_split<TC>(bacc[mt], ahi, alo, to_f32(tile[m]), to_f32(tile[m + RS]));
        }
      }
    }
  }

  // each pair's loss (and model sums) over this block's channels: its four
  // lanes' partials summed by a fixed shuffle tree
  lacc += __shfl_xor_sync(0xffffffffu, lacc, 1);
  lacc += __shfl_xor_sync(0xffffffffu, lacc, 2);
  if constexpr (kTerms == 3) {
    mracc += __shfl_xor_sync(0xffffffffu, mracc, 1);
    mracc += __shfl_xor_sync(0xffffffffu, mracc, 2);
    miacc += __shfl_xor_sync(0xffffffffu, miacc, 1);
    miacc += __shfl_xor_sync(0xffffffffu, miacc, 2);
  }
  __syncthreads();  // every warp is done with the ring and the coefficients
  // (kTerms, 32): the block's per-pair loss (and M_r, M_i)
  float* lsum = reinterpret_cast<float*>(smem);
  float* part = coef;  // (64, kv): the block's coefficient gradient, row (re, im) major
  if (tig == 0 && kTerms > 0) {
    lsum[pe] = lacc;
    if (kTerms == 3) {
      lsum[kPairs + pe] = mracc;
      lsum[2 * kPairs + pe] = miacc;
    }
  }
  const int kv = kAll ? (Vs < kCapacity ? Vs : kCapacity) : 0;
  if constexpr (kAll) {
#pragma unroll
    for (int mt = 0; mt < kModeTiles; ++mt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = 8 * mt + 2 * tig + c;
        if (k < kv) {
          part[pe * kv + k] = bacc[mt][c];
          part[(kPairs + pe) * kv + k] = bacc[mt][2 + c];
        }
      }
    }
  }
  // the cluster's blocks sum their parts in split order, each block a share
  // of the entries, reading the others' shared memory (one block: its own)
  const int entries = kv * kCols + kTerms * kPairs;
  if (splits > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  for (int e = split * kThreads + t; e < entries; e += splits * kThreads) {
    const bool loss = e >= kv * kCols;
    const int row = loss ? 0 : e / kv;
    const int term = loss ? e - kv * kCols : 0;  // (the term, the pair) of a loss entry
    const int p = loss ? term % kPairs : row % kPairs;
    if (!in_op(p)) continue;
    float s = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* src = splits > 1 ? cg::this_cluster().map_shared_rank(loss ? lsum : part, r)
                                    : (loss ? lsum : part);
      s += src[loss ? term : e];
    }
    const int64_t n = tab[p], g = tab[kPairs + p];
    if (loss) {
      partials[(term / kPairs * N + n) * G + g] = s;
    } else {
      dcoeffs[((row / kPairs * N + n) * G + g) * V + e % kv] = s;
    }
  }
  if (splits > 1) cg::this_cluster().sync();  // no block leaves while others read it
}

// ---------------------------------------------------------------------- //
// Bases wider than the register tiles (V > 64): the modes sliced over the
// blocks of a cluster
// ---------------------------------------------------------------------- //
constexpr int kSlice = 64;               // modes a block holds: phase B's register tile
constexpr int kMaxCluster = 16;          // the H100's largest cluster (V up to 1024)
// blocks an SM: float32 comps up to 168 registers and 64.3 KB of shared memory, bfloat16 128 and 56 KB
// (a fourth block took a tenth off the bfloat16 step; PERF.md)
template <typename TC>
constexpr int kSlicedMinBlocks = std::is_same<TC, float>::value ? 3 : 4;
constexpr int kOwned = 16;               // pairs a block's epilogue runs, at most
// the exchange buffers' row stride in floats: the float2 fragment accesses
// (row g, column 2 t) of a half warp fall in distinct banks
constexpr int kXS = kRows + 8;
constexpr int kSlicedTargetBlocks = 4;   // channel splits doubled below this many blocks an SM
// The staged TF32 operands, K-major (the modes contiguous) in `wgmma`'s
// layout without swizzle: a row's four modes 4c..4c+3 are one 16-byte unit,
// the units of mode group c at c * pitch, row r at 16 r inside it, so
// every 8 rows of a group form one core matrix (128 contiguous bytes).
constexpr int kGroups = kSlice / 4;               // mode groups of a slice
constexpr int kCompsPitch = kRows * 16 + 16;      // 528: 16 past a multiple of 128 (below)
constexpr int kCompsHalf = kGroups * kCompsPitch;  // bytes of one staged comps tile
constexpr int kCoefPitch = kCols * 16;
constexpr int kCoefHalf = kGroups * kCoefPitch;   // bytes of one half of the coefficients

// staged comps tiles: hi and lo of float32 comps; bfloat16 comps widened
__host__ __device__ constexpr int comps_halves(int csize) { return csize == 4 ? 2 : 1; }

// the comps halves; the coefficients' hi and lo; the partial models (64
// rows); the dv of the pairs the block owns (2 x 16 rows); the table; the
// cotangents
__host__ __device__ constexpr size_t sliced_smem_bytes(int csize) {
  return static_cast<size_t>(comps_halves(csize)) * kCompsHalf + 2 * kCoefHalf +
         static_cast<size_t>(kCols) * kXS * 4 + 2 * kOwned * kXS * 4 + kTableBytes + 3 * kPairs * 4;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a shared-memory matrix descriptor of `wgmma`, no swizzle: the start, the
// byte offset between core matrices along K (lbo) and along M or N (sbo)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3fffu) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32;
}

// d += a b, a (64 x 8) and b (8 x 32) TF32 from shared memory, both K-major,
// over the warpgroup: warp w holds rows 16 w + g (d[4 j], d[4 j + 1]) and
// 16 w + g + 8 (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 t and 8 j + 2 t + 1
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators stay in place across the asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// this thread's shared-memory writes made visible to `wgmma`'s reads
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four TF32 values as one 16-byte unit
__device__ __forceinline__ void store_unit(unsigned char* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// A cluster of `slices` x `splits` blocks takes one tile of 32 pairs: block
// (split s, slice r) the modes [64 r, 64 r + 64) and the channel tiles of
// split s. The block splits its slice of the coefficients into TF32 halves
// once, and each channel tile's comps once, where they are staged. Per
// channel tile: phase A forms the slice's part of the model on `wgmma`
// from those halves and leaves it in the block's exchange buffer; after a
// cluster barrier the block runs the epilogue of the pairs it owns (pairs
// [32 r / S, 32 (r + 1) / S)), the model summed over the slices' buffers in
// rank order (DSMEM), and leaves their dv in its dv buffer; after a second
// barrier (which also frees the exchange buffer for the next tile) phase B
// reads the dv of its warps' pairs from their owners and adds the comps
// halves into its register tile of dcoeffs on `mma.sync`, which it writes
// once at the end.
template <typename TC, int MODE>
__global__ void __launch_bounds__(kThreads, kSlicedMinBlocks<TC>)
shared_chunk_loss_sliced(const TC* __restrict__ comps, const float* __restrict__ coeffs2,
                         const float* __restrict__ pr, const float* __restrict__ pi,
                         const float* __restrict__ dr, const float* __restrict__ di,
                         int64_t d_sn, int64_t d_sg, int64_t d_sf, const void* __restrict__ w,
                         int w_bf16, int64_t w_sn, int64_t w_sg, int64_t w_sf,
                         const unsigned char* __restrict__ valid, float* __restrict__ partials,
                         float* __restrict__ dcoeffs, float* __restrict__ dpr,
                         float* __restrict__ dpi, const float* __restrict__ cot, int64_t N,
                         int64_t G, int64_t F, int64_t V, int64_t gmax, int blocks_per_op,
                         int /* stages */, int /* vec16 */, int slices, int splits) {
  constexpr bool kF32 = std::is_same<TC, float>::value;
  constexpr bool kDp = has_dp(MODE);
  constexpr bool kAll = has_all(MODE);
  constexpr bool kCot = has_cot(MODE);
  constexpr int kTerms = n_terms(MODE);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const chi = smem;  // the comps tile's hi (bfloat16: widened); float32: lo after
  unsigned char* const clo = smem + kCompsHalf;
  unsigned char* const ahi = smem + comps_halves(sizeof(TC)) * kCompsHalf;
  unsigned char* const alo = ahi + kCoefHalf;
  float* const xa = reinterpret_cast<float*>(alo + kCoefHalf);  // (64, kXS): partial models
  float* const xd = xa + kCols * kXS;  // (2 x 16, kXS): the owned pairs' dv
  int* tab = reinterpret_cast<int*>(xd + 2 * kOwned * kXS);
  float* cotv = reinterpret_cast<float*>(tab + 3 * kPairs);

  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int S = slices;
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = rank / S, slice = rank - split * S;
  const int pair_tile = blockIdx.x / (S * splits);
  const int64_t u = pair_tile / blocks_per_op;
  const int64_t q0 = static_cast<int64_t>(pair_tile % blocks_per_op) * kPairs;
  const int64_t GF = G * F;
  const TC* op = comps + u * F * V;
  const int k0 = slice * kSlice;  // the slice's first mode
  const int W = static_cast<int>(V - k0 < kSlice ? V - k0 : kSlice);
  const int ntiles = static_cast<int>((F + kRows - 1) / kRows);
  const int jt0 = split * ntiles / splits, jt1 = (split + 1) * ntiles / splits;
  // every block of the cluster passes the same barriers: as many rounds as
  // the longest split has tiles
  const int rounds = (ntiles + splits - 1) / splits;
  // the pairs whose epilogue this block runs
  const int p0 = slice * kPairs / S, np = (slice + 1) * kPairs / S - p0;

  // the pair table, as in shared_chunk_loss_kernel; a tile of padding only
  // writes its zeros (every block of the cluster leaves together)
  {
    bool mine = false;
    if (t < kPairs) {
      const int64_t q = q0 + t;
      const int g = static_cast<int>(u * gmax + q / N);
      const bool in = q < gmax * N;
      mine = in && (valid == nullptr || valid[g]);
      tab[t] = static_cast<int>(q % N);
      tab[kPairs + t] = g;
      tab[2 * kPairs + t] = (in ? 1 : 0) | (mine ? 2 : 0);
    }
    if (!__syncthreads_or(mine)) {
      for (int p = 0; p < kPairs && rank == 0; ++p) {
        if (!(tab[2 * kPairs + p] & 1)) break;
        const int64_t n = tab[p], g = tab[kPairs + p];
        if (t == 0) {
          for (int c = 0; c < kTerms; ++c) partials[(c * N + n) * G + g] = 0.f;
        }
        if constexpr (kDp) {
          for (int64_t f = t; f < F; f += kThreads) {
            dpr[n * GF + g * F + f] = 0.f;
            dpi[n * GF + g * F + f] = 0.f;
          }
        }
        if constexpr (kAll) {
          for (int64_t k = t; k < V; k += kThreads) {
            dcoeffs[(n * G + g) * V + k] = 0.f;
            dcoeffs[((N + n) * G + g) * V + k] = 0.f;
          }
        }
      }
      return;
    }
  }
  auto in_op = [&](int p) { return (tab[2 * kPairs + p] & 1) != 0; };
  if constexpr (kCot) {  // each pair's cotangents (-2 gx, gr, gi)
    if (t < kPairs) {
      const int64_t n = tab[t];
      cotv[t] = -2.f * cot[n];
      cotv[kPairs + t] = cot[N + n];
      cotv[2 * kPairs + t] = cot[2 * N + n];
    }
  }
  // the slice of the block's coefficients split once into TF32 (hi, lo),
  // `wgmma`'s A operand: row 16 (p / 8) + p % 8 the real part of pair p and
  // 8 rows on its imaginary part, so that warp w's accumulator rows are the
  // real and imaginary parts of its pairs 8 w to 8 w + 7. Zero past the
  // slice's modes and for pairs the operator does not have.
  {
    const bool cvec = (V & 3) == 0 && (reinterpret_cast<uintptr_t>(coeffs2) & 15) == 0;
    for (int q = t; q < kCols * kGroups; q += kThreads) {
      const int row = q / kGroups, c = q % kGroups;  // row: part * 32 + p
      const int p = row % kPairs, part = row / kPairs;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (in_op(p) && 4 * c < W) {
        const float* src =
            coeffs2 + ((part * N + tab[p]) * G + tab[kPairs + p]) * V + k0 + 4 * c;
        if (cvec && 4 * c + 4 <= W) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = 4 * c + e < W ? src[e] : 0.f;
        }
      }
      uint32_t h[4], l[4];
      split4<true>(x[0], x[1], x[2], x[3], h, l);
      const int off = c * kCoefPitch + 16 * (16 * (p / 8) + 8 * part + p % 8);
      store_unit(ahi + off, h);
      store_unit(alo + off, l);
    }
  }

  // this thread's share of a comps tile: row r = (t + 128 i) / 16 (channel
  // f0 + r) and mode group c = t % 16 of the slice, i = 0..3, fetched into
  // registers a tile ahead; zeros past F and past the slice's modes
  using Unit = typename std::conditional<kF32, float4, uint2>::type;
  const bool vec = (V & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(comps) & (4 * sizeof(TC) - 1)) == 0;
  const int uc = t % kGroups;
  Unit raw[4];
  auto fetch = [&](int jt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t f = static_cast<int64_t>(jt) * kRows + (t + kThreads * i) / kGroups;
      if constexpr (kF32) {
        raw[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        raw[i] = make_uint2(0u, 0u);
      }
      if (jt < jt1 && f < F && 4 * uc < W) {
        const TC* src = op + f * V + k0 + 4 * uc;
        if (vec && 4 * uc + 4 <= W) {
          raw[i] = *reinterpret_cast<const Unit*>(src);
        } else if constexpr (kF32) {
          const int n = W - 4 * uc;
          raw[i] = make_float4(src[0], n > 1 ? src[1] : 0.f, n > 2 ? src[2] : 0.f,
                               n > 3 ? src[3] : 0.f);
        } else {
          const int n = W - 4 * uc;
          const uint32_t e0 = __bfloat16_as_ushort(src[0]);
          const uint32_t e1 = n > 1 ? __bfloat16_as_ushort(src[1]) : 0u;
          const uint32_t e2 = n > 2 ? __bfloat16_as_ushort(src[2]) : 0u;
          const uint32_t e3 = n > 3 ? __bfloat16_as_ushort(src[3]) : 0u;
          raw[i] = make_uint2(e0 | e1 << 16, e2 | e3 << 16);
        }
      }
    }
  };
  // the fetched tile into shared memory: float32 split into TF32 (hi, lo),
  // bfloat16 widened (exact in TF32)
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = uc * kCompsPitch + 16 * ((t + kThreads * i) / kGroups);
      uint32_t h[4], l[4];
      if constexpr (kF32) {
        split4<true>(raw[i].x, raw[i].y, raw[i].z, raw[i].w, h, l);
        store_unit(clo + off, l);
      } else {
        h[0] = raw[i].x << 16, h[1] = raw[i].x & 0xffff0000u;
        h[2] = raw[i].y << 16, h[3] = raw[i].y & 0xffff0000u;
      }
      store_unit(chi + off, h);
    }
  };

  // this thread's epilogue entries: pair p0 + 4 j + warp at channel f0 +
  // lane (a warp reads a pair's 32 channels, 128 bytes a plane); zeros past
  // F and for padding
  float e_pr[4], e_pi[4], e_dr[4], e_di[4], e_w[4];
  auto load_planes = [&](int jt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e_pr[j] = e_pi[j] = e_dr[j] = e_di[j] = e_w[j] = 0.f;
      const int p = p0 + 4 * j + warp;
      const int64_t f = static_cast<int64_t>(jt) * kRows + lane;
      if (4 * j + warp < np && (tab[2 * kPairs + p] & 2) && f < F) {
        const int64_t n = tab[p], g = tab[kPairs + p];
        e_pr[j] = pr[n * GF + g * F + f];
        e_pi[j] = pi[n * GF + g * F + f];
        e_dr[j] = dr[n * d_sn + g * d_sg + f * d_sf];
        e_di[j] = di[n * d_sn + g * d_sg + f * d_sf];
        e_w[j] = load_w(w, w_bf16, n * w_sn + g * w_sg + f * w_sf);
      }
    }
  };

  float lacc[4], mracc[4], miacc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) lacc[j] = mracc[j] = miacc[j] = 0.f;
  float bacc[kModeTiles][4];
#pragma unroll
  for (int i = 0; i < kModeTiles; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bacc[i][j] = 0.f;
  }
  // phase B's rows: the warp's pair pe, re (row g) and im (row g + 8); its
  // dv: row pe - 32 r' / S (re) and 16 rows on (im) in the buffer of the
  // block r' that owns it
  const int pe = warp * kWarpPairs + gid;
  const int owner = (S * (pe + 1) - 1) / kPairs;
  const int orow = pe - owner * kPairs / S;
  const float* const dv_src =
      kAll ? static_cast<const float*>(cluster.map_shared_rank(xd, split * S + owner)) + orow * kXS
           : nullptr;
  // phase A's operands: k-step s of the coefficients' halves at 2 s mode
  // groups on, of the comps tile's likewise; 8-row core matrices 128 bytes
  // apart along M and N
  const uint64_t da_hi = smem_desc(ahi, kCoefPitch, 128), da_lo = smem_desc(alo, kCoefPitch, 128);
  const uint64_t db_hi = smem_desc(chi, kCompsPitch, 128), db_lo = smem_desc(clo, kCompsPitch, 128);
  // phase B's comps fragments: channels 8 ks + 2 t and + 1 (k indices t and
  // t + 4), modes 16 q + 2 g (n-tile 2 q) and 16 q + 2 g + 1 (n-tile 2 q +
  // 1), one 8-byte read each: with the pitch 16 bytes past a multiple of
  // 128 a half warp's reads fall in distinct banks
  const unsigned char* const bfrag = chi + (gid >> 1) * kCompsPitch + 8 * (gid & 1) + 32 * tig;

  fetch(jt0);
  load_planes(jt0);
  for (int it = 0; it < rounds; ++it) {
    const int jt = jt0 + it;
    const bool live = jt < jt1;  // else a round of barriers (and a product nobody reads)
    const int64_t f0 = static_cast<int64_t>(jt) * kRows;
    __syncthreads();  // every warp done with tile jt - 1's halves
    stage();
    async_proxy_fence();
    __syncthreads();  // tile jt's halves (and, first, the coefficients') in
    fetch(jt + 1);    // in flight through phase A, the epilogue and phase B
    // phase A: the slice's part of the model of the block's 32 pairs at the
    // tile's 32 channels, (64 x 64) x (64 x 32), in k-steps of 8 modes, each
    // product lo hi, hi lo, hi hi (bfloat16: lo b, hi b); on every round
    // alike, so that no `wgmma` sits on a path the compiler takes as divergent
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSlice / 8; ++s) {
      const uint64_t a = 2 * s * kCoefPitch >> 4, b = 2 * s * kCompsPitch >> 4;
      wgmma_tf32(acc, da_lo + a, db_hi + b);
      if constexpr (kF32) wgmma_tf32(acc, da_hi + a, db_lo + b);
      wgmma_tf32(acc, da_hi + a, db_hi + b);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    // row pe (re) and 32 + pe (im) of the buffer, channel 8 j + 2 tig + c
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float2*>(xa + pe * kXS + 8 * j + 2 * tig) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(xa + (kPairs + pe) * kXS + 8 * j + 2 * tig) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_arrive();
    cluster_wait();  // every slice's part of the tile's model in
    if (live) {
      // the epilogue of the block's pairs, the model summed over the slices
      // in rank order
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * j + warp >= np) continue;
        const int p = p0 + 4 * j + warp;
        float sr = 0.f, si = 0.f;
#pragma unroll 4
        for (int q = 0; q < S; ++q) {
          const float* x = static_cast<const float*>(cluster.map_shared_rank(xa, split * S + q));
          sr += x[p * kXS + lane];
          si += x[(kPairs + p) * kXS + lane];
        }
        const int flags = tab[2 * kPairs + p];
        const int64_t f = f0 + lane;
        const bool ok = (flags & 2) && f < F;
        const float mr = e_pr[j] * sr + e_pi[j] * si;
        const float mi = -e_pi[j] * sr + e_pr[j] * si;
        const float er = e_dr[j] - mr;
        const float ei = e_di[j] - mi;
        if (ok && kTerms > 0) lacc[j] += e_w[j] * (er * er + ei * ei);
        if (ok && kTerms == 3) {
          mracc[j] += e_w[j] * mr;
          miacc[j] += e_w[j] * mi;
        }
        float dmr = ok ? -2.f * e_w[j] * er : 0.f;
        float dmi = ok ? -2.f * e_w[j] * ei : 0.f;
        if constexpr (kCot) {
          dmr = ok ? e_w[j] * fmaf(cotv[p], er, cotv[kPairs + p]) : 0.f;
          dmi = ok ? e_w[j] * fmaf(cotv[p], ei, cotv[2 * kPairs + p]) : 0.f;
        }
        if constexpr (kDp) {
          if ((flags & 1) && f < F) {
            const int64_t n = tab[p], g = tab[kPairs + p];
            dpr[n * GF + g * F + f] = sr * dmr + si * dmi;
            dpi[n * GF + g * F + f] = si * dmr - sr * dmi;
          }
        }
        if constexpr (kAll) {
          xd[(4 * j + warp) * kXS + lane] = e_pr[j] * dmr - e_pi[j] * dmi;
          xd[(kOwned + 4 * j + warp) * kXS + lane] = e_pi[j] * dmr + e_pr[j] * dmi;
        }
      }
    }
    cluster_arrive();
    // the next tile's planes, in flight through the barrier, phase B and
    // phase A
    if (live && jt + 1 < jt1) load_planes(jt + 1);
    cluster_wait();  // the tile's dv of every pair in; every epilogue done with xa
    if (kAll && live) {
      // phase B: dcoeffs^T += dv^T comps over the tile's channels, the k
      // index t read as channel 8 ks + 2 t and t + 4 as 8 ks + 2 t + 1; n-tile
      // 2 q + h holds the modes 16 q + 2 n + h
      float2 re[4], im[4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        re[ks] = *reinterpret_cast<const float2*>(dv_src + 8 * ks + 2 * tig);
        im[ks] = *reinterpret_cast<const float2*>(dv_src + kOwned * kXS + 8 * ks + 2 * tig);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t dhi[4], dlo[4];
        split4<true>(re[ks].x, im[ks].x, re[ks].y, im[ks].y, dhi, dlo);
#pragma unroll
        for (int q = 0; q < kModeTiles / 2; ++q) {
          const unsigned char* b = bfrag + 4 * q * kCompsPitch + 128 * ks;
          const uint2 h0 = *reinterpret_cast<const uint2*>(b);
          const uint2 h1 = *reinterpret_cast<const uint2*>(b + 16);
          mma_tf32(bacc[2 * q], dlo, h0.x, h1.x);
          mma_tf32(bacc[2 * q + 1], dlo, h0.y, h1.y);
          if constexpr (kF32) {
            const uint2 l0 = *reinterpret_cast<const uint2*>(b + kCompsHalf);
            const uint2 l1 = *reinterpret_cast<const uint2*>(b + kCompsHalf + 16);
            mma_tf32(bacc[2 * q], dhi, l0.x, l1.x);
            mma_tf32(bacc[2 * q + 1], dhi, l0.y, l1.y);
          }
          mma_tf32(bacc[2 * q], dhi, h0.x, h1.x);
          mma_tf32(bacc[2 * q + 1], dhi, h0.y, h1.y);
        }
      }
    }
  }

  // each pair's sums over this block's channels: a fixed shuffle tree over
  // the 32 lanes
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      lacc[j] += __shfl_xor_sync(0xffffffffu, lacc[j], m);
      if constexpr (kTerms == 3) {
        mracc[j] += __shfl_xor_sync(0xffffffffu, mracc[j], m);
        miacc[j] += __shfl_xor_sync(0xffffffffu, miacc[j], m);
      }
    }
  }
  __syncthreads();  // every warp is done with the coefficients
  float* red = reinterpret_cast<float*>(ahi);  // (64, W): the block's part of dcoeffs
  float* lsum = red + kCols * kSlice;          // (kTerms, 32): its pairs' sums
  if (lane == 0 && kTerms > 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * j + warp < np) {
        const int p = p0 + 4 * j + warp;
        lsum[p] = lacc[j];
        if (kTerms == 3) {
          lsum[kPairs + p] = mracc[j];
          lsum[2 * kPairs + p] = miacc[j];
        }
      }
    }
  }
  if constexpr (kAll) {
    // n-tiles 2 q and 2 q + 1 hold the modes 16 q + 4 tig + [0, 4)
#pragma unroll
    for (int q = 0; q < kModeTiles / 2; ++q) {
      const float r4[4] = {bacc[2 * q][0], bacc[2 * q + 1][0], bacc[2 * q][1], bacc[2 * q + 1][1]};
      const float i4[4] = {bacc[2 * q][2], bacc[2 * q + 1][2], bacc[2 * q][3], bacc[2 * q + 1][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * q + 4 * tig + e;
        if (k < W) {
          red[pe * W + k] = r4[e];
          red[(kPairs + pe) * W + k] = i4[e];
        }
      }
    }
  }
  // the splits' parts summed in split order, each block of a slice a share
  // of its entries, reading the others' shared memory
  cluster_arrive();
  cluster_wait();
  const int nd = kAll ? kCols * W : 0;
  const int entries = nd + kTerms * np;
  for (int e = split * kThreads + t; e < entries; e += splits * kThreads) {
    const bool loss = e >= nd;
    const int row = loss ? 0 : e / W;
    const int term = loss ? (e - nd) / np : 0;
    const int p = loss ? p0 + (e - nd) % np : row % kPairs;
    if (!in_op(p)) continue;
    const int off = loss ? term * kPairs + p : e;
    float s = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* src =
          static_cast<const float*>(cluster.map_shared_rank(loss ? lsum : red, r * S + slice));
      s += src[off];
    }
    const int64_t n = tab[p], g = tab[kPairs + p];
    if (loss) {
      partials[(term * N + n) * G + g] = s;
    } else {
      dcoeffs[((row / kPairs * N + n) * G + g) * V + k0 + e % W] = s;
    }
  }
  cluster_arrive();
  cluster_wait();  // no block leaves while others read it
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    sms = 132;
  }
  return sms;
}

// The launch plan. V <= 64: a ring of two tiles; the channels of a tile of
// pairs split over a cluster, doubled (up to 8 blocks, each keeping at least
// one channel tile) while the launch has fewer than 8 blocks an SM; bfloat16
// comps' coefficients split once in shared memory. V > 64: a cluster of
// ceil(V / 64) mode slices a tile of pairs, its channels split as well,
// doubled (up to 16 blocks) while the launch has fewer than
// kSlicedTargetBlocks blocks an SM; one staged tile in shared memory (the
// next in registers).
struct Plan {
  int stages, slices, splits, pre;
  long long grid;  // blocks, the clusters' included
  size_t smem;
};

bool make_plan(long long N, long long G, long long F, long long V, long long U, int csize,
               Plan* plan) {
  if (V > static_cast<long long>(kSlice) * kMaxCluster) return false;
  const long long pair_tiles = (G / U * N + kPairs - 1) / kPairs * U;
  const long long ntiles = (F + kRows - 1) / kRows;
  const long long sms = sm_count();
  int splits = 1;
  if (V <= kCapacity) {
    while (splits < 8 && 2 * splits <= ntiles && pair_tiles * splits < 8 * sms) splits *= 2;
    plan->pre = csize == 2;
    plan->stages = 2;
    plan->slices = 1;
    plan->smem = plan->pre ? smem_bytes_pre(V, csize) : smem_bytes(V, csize, 2);
  } else {
    const int slices = static_cast<int>((V + kSlice - 1) / kSlice);
    while (slices * splits * 2 <= kMaxCluster && 2 * splits <= ntiles &&
           pair_tiles * slices * splits < kSlicedTargetBlocks * sms) {
      splits *= 2;
    }
    plan->pre = 0;
    plan->stages = 1;
    plan->slices = slices;
    plan->smem = sliced_smem_bytes(csize);
  }
  plan->splits = splits;
  plan->grid = pair_tiles * plan->slices * splits;
  return plan->grid <= INT_MAX && G / U * N <= INT_MAX;
}

template <typename TC, int MODE, bool kSliced>
auto kernel_of() {
  if constexpr (kSliced) {
    return &shared_chunk_loss_sliced<TC, MODE>;
  } else {
    return &shared_chunk_loss_kernel<TC, MODE, std::is_same<TC, __nv_bfloat16>::value>;
  }
}

// shared memory past 48 KB, and clusters past 8 blocks
template <typename K>
int prepare(K kernel, size_t smem) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return static_cast<int>(err);
}

template <typename TC, int MODE, bool kSliced>
int launch(const Plan& plan, int vec16, cudaStream_t s, const void* comps, const float* coeffs2,
           const float* pr, const float* pi, const float* dr, const float* di, int64_t d_sn,
           int64_t d_sg, int64_t d_sf, const void* w, int w_bf16, int64_t w_sn, int64_t w_sg,
           int64_t w_sf, const unsigned char* valid, float* partials, float* dcoeffs, float* dpr,
           float* dpi, const float* cot, int64_t N, int64_t G, int64_t F, int64_t V,
           int64_t gmax, int blocks_per_op) {
  auto kernel = kernel_of<TC, MODE, kSliced>();
  const int err = prepare(kernel, plan.smem);
  if (err != 0) return err;
  // the blocks of one tile of pairs form a cluster
  const int cluster = plan.slices * plan.splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(plan.grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TC*>(comps), coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w,
      w_bf16, w_sn, w_sg, w_sf, valid, partials, dcoeffs, dpr, dpi, cot, N, G, F, V, gmax,
      blocks_per_op, plan.stages, vec16, plan.slices, plan.splits);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, bool kSliced, typename... Args>
int launch_mode(int mode, Args... args) {
  switch (mode) {
    case kLossOnly: return launch<TC, kLossOnly, kSliced>(args...);
    case kLossDp: return launch<TC, kLossDp, kSliced>(args...);
    case kLossAll: return launch<TC, kLossAll, kSliced>(args...);
    case kSumFwd: return launch<TC, kSumFwd, kSliced>(args...);
    case kSumDp: return launch<TC, kSumDp, kSliced>(args...);
    default: return launch<TC, kSumAll, kSliced>(args...);
  }
}

// blocks an SM of one instance at `smem` bytes of dynamic shared memory, as
// the CUDA runtime's occupancy calculator gives them
template <typename TC, int MODE, bool kSliced>
int occupancy(size_t smem, int* blocks) {
  auto kernel = kernel_of<TC, MODE, kSliced>();
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem));
}

template <typename TC, bool kSliced>
int occupancy_mode(int mode, size_t smem, int* blocks) {
  switch (mode) {
    case kLossOnly: return occupancy<TC, kLossOnly, kSliced>(smem, blocks);
    case kLossDp: return occupancy<TC, kLossDp, kSliced>(smem, blocks);
    case kLossAll: return occupancy<TC, kLossAll, kSliced>(smem, blocks);
    case kSumFwd: return occupancy<TC, kSumFwd, kSliced>(smem, blocks);
    case kSumDp: return occupancy<TC, kSumDp, kSliced>(smem, blocks);
    default: return occupancy<TC, kSumAll, kSliced>(smem, blocks);
  }
}

}  // namespace

extern "C" {

// The launch plan of shared_chunk_loss for these shapes, into out[8]:
// {comps tiles staged in shared memory (a ring of 2; 1 past 64 modes), channel splits a tile of pairs, blocks of the
// grid (the clusters' included), dynamic shared memory a block in bytes, 1
// where the coefficients are split once into shared memory, the blocks an
// SM the CUDA runtime's occupancy calculator gives the instance at that
// shared memory, mode slices a tile of pairs (1 for V <= 64), blocks a
// cluster (slices x splits)}. Returns 0, cudaErrorInvalidValue for a shape
// the kernel does not take, or the runtime's error.
int shared_plan(long long N, long long G, long long F, long long V, long long U,
                int comps_dtype, int mode, long long* out) {
  const int csize = comps_dtype == 0 ? 4 : 2;
  Plan plan;
  if (N <= 0 || G <= 0 || F <= 0 || V <= 0 || U <= 0 || G % U != 0 || mode < kLossOnly ||
      mode > kSumAll || (comps_dtype != 0 && comps_dtype != 1) ||
      !make_plan(N, G, F, V, U, csize, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool sliced = plan.slices > 1;
  int blocks = 0;
  const int err = comps_dtype == 0
                      ? (sliced ? occupancy_mode<float, true>(mode, plan.smem, &blocks)
                                : occupancy_mode<float, false>(mode, plan.smem, &blocks))
                      : (sliced ? occupancy_mode<__nv_bfloat16, true>(mode, plan.smem, &blocks)
                                : occupancy_mode<__nv_bfloat16, false>(mode, plan.smem, &blocks));
  if (err != 0) return err;
  const long long vals[8] = {plan.stages, plan.splits, plan.grid,
                             static_cast<long long>(plan.smem), plan.pre, blocks,
                             plan.slices, static_cast<long long>(plan.slices) * plan.splits};
  for (int q = 0; q < 8; ++q) out[q] = vals[q];
  return 0;
}

// comps: (U, F, V) contiguous, float32 (comps_dtype 0) or bfloat16 (1);
// group g uses operator g / (G / U). coeffs2: (2, N, G, V) contiguous
// float32; pr, pi: (N, G, F) contiguous float32; dr, di: float32 at
// dr[n * d_sn + g * d_sg + f * d_sf]; w: float32 (w_dtype 0) or bfloat16 (1)
// at w[n * w_sn + g * w_sg + f * w_sf] (strides in elements); valid: (G,)
// bytes, nonzero where a group holds a baseline, or null for every group.
// Outputs, float32 and contiguous: partials (T, N, G), summed over G by the
// caller; for modes 1, 2, 4 and 5 dpr and dpi (N, G, F); for modes 2 and 5
// dcoeffs (2, N, G, V). mode 0 is the loss only, 1 the loss with dpr/dpi, 2
// every gradient, each at a loss cotangent of 1 (T = 1: the chi-square);
// mode 3 the "sum" forward (T = 3: the chi-square, M_r, M_i); modes 4 and
// 5 the "sum" backward with dpr/dpi or every gradient at the cotangents
// cot (3, N) float32 contiguous (of the chi-square, M_r and M_i; no
// partials, which may be null). All on the current device. V up to 1024.
// Launches on `stream` and returns the launch's CUDA error (0 on success,
// cudaErrorInvalidValue for a shape it does not take); it does not
// synchronise.
int shared_chunk_loss(const void* comps, int comps_dtype, const float* coeffs2, const float* pr,
                      const float* pi, const float* dr, const float* di, long long d_sn,
                      long long d_sg, long long d_sf, const void* w, int w_dtype, long long w_sn,
                      long long w_sg, long long w_sf, const unsigned char* valid,
                      float* partials, float* dcoeffs, float* dpr, float* dpi,
                      const float* cot, long long N, long long G, long long F, long long V,
                      long long U, int mode, void* stream) {
  const int csize = comps_dtype == 0 ? 4 : 2;
  Plan plan;
  if (N <= 0 || G <= 0 || F <= 0 || V <= 0 || U <= 0 || G % U != 0 || N > INT_MAX ||
      G > INT_MAX || F > INT_MAX || V > INT_MAX || mode < kLossOnly || mode > kSumAll ||
      (comps_dtype != 0 && comps_dtype != 1) || (w_dtype != 0 && w_dtype != 1) ||
      (has_cot(mode) && cot == nullptr) || (n_terms(mode) > 0 && partials == nullptr) ||
      !make_plan(N, G, F, V, U, csize, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long gmax = G / U;
  const int bpo = static_cast<int>((gmax * N + kPairs - 1) / kPairs);
  const int vec16 = reinterpret_cast<uintptr_t>(comps) % 16 == 0 && (V * csize) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SHARED_ARGS                                                                             \
  plan, vec16, s, comps, coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w, w_dtype, w_sn, w_sg, w_sf, \
      valid, partials, dcoeffs, dpr, dpi, cot, N, G, F, V, gmax, bpo
  if (plan.slices > 1) {
    return comps_dtype == 0 ? launch_mode<float, true>(mode, SHARED_ARGS)
                            : launch_mode<__nv_bfloat16, true>(mode, SHARED_ARGS);
  }
  return comps_dtype == 0 ? launch_mode<float, false>(mode, SHARED_ARGS)
                          : launch_mode<__nv_bfloat16, false>(mode, SHARED_ARGS);
#undef SHARED_ARGS
}

}  // extern "C"
