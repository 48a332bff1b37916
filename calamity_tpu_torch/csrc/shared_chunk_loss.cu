// Weighted chi-square of one shared-basis chunk, with its gradients, for a
// batch of N (time, pol) slices, for Hopper (sm_90a).
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
// All accumulation is float32 (no TF32); bfloat16 comps and weights are
// widened where they are read.
//
// What bounds it: bytes and FMAs about equally. Each (slice, group,
// channel) entry reads pr, pi, dr, di and w and writes dpr and dpi (28
// bytes, float32), and costs 4 V fused multiply-adds (2 V for the matvec, 2
// V for the coefficient gradient). At the HERA core's four chunks (7168
// groups, 1536 channels, V = 32 and 64, N = 1) that is 0.31 GB, 0.095 ms
// at 3.35 TB/s, and 5.2 GFLOP, 0.08 ms at the float32 rate. The basis is
// small (one operator serves up to 2048 groups) and stays in L2. What holds
// this design from those lines is shared memory and latency: each thread's
// register tiles (2 x 8 in phase A, 4 x 8 in phase B) read 2.5 and 1.5 bytes
// of shared memory a multiply-add, and a block's channel loop is a chain of
// waits between few warps. Registers are capped at 168 a thread, so three
// blocks share an SM (the HERA core's four launches at N = 1: 0.589 ms
// uncapped, 0.515 ms capped, PERF.md).
//
// Design: every (group, slice) pair of an operator is independent but for
// the operator it reads, so a block takes one operator and a tile of 32
// pairs (64 columns: re and im of each pair's coefficients) and walks its
// channels, 32 a tile. That makes the chunk two small products a tile:
// (32 channels x V) x (V x 64 columns) for the model, and (V x 32
// channels) x (32 channels x 64 columns) for the coefficient gradient.
// - A chunk has few tiles of pairs at N = 1 (32 to 96 at the HERA core's
//   shapes: a block an SM at most, and a block's walk over 48 channel
//   tiles is a chain of latencies), so a tile of pairs is split over the
//   channels among a thread-block cluster of up to 8 blocks, doubled while
//   the launch has fewer than 8 blocks an SM. Each block keeps its part of
//   the losses and of the coefficient gradient in shared memory; after a
//   cluster barrier each block sums a share of the entries over the
//   cluster's blocks in split order, reading their shared memory (DSMEM),
//   and writes them once. With modes past the register tiles (V > 64) the
//   tile is not split.
// - The operator's channel tile is staged in shared memory once per block
//   and tile, in its own dtype (bfloat16 stays bfloat16 and is widened on
//   the read), by `cp.async` 16-byte copies in a ring of two tiles: the
//   next tile loads while this one computes. Rows are padded by 16 bytes so
//   the phase-A reads of four rows fall in distinct banks. Where a row is
//   not a whole number of 16-byte units, the tile is copied by plain loads.
// - The block's coefficients are staged once, as (V, 64) floats in shared
//   memory, and read as float4 broadcasts.
// - Phase A, a 2-channel x 8-column register tile per thread, summed over
//   the modes in order; the results go to a (32, 64) shared tile.
// - Epilogue, one thread per (channel, pair) in turn: the pair's planes
//   are loaded at the top of the tile, before the wait for its comps, so
//   their latency hides behind phase A; the loss goes to per-thread
//   registers, dpr/dpi are written coalesced along the channel axis, dv
//   replaces the model in the shared tile.
// - Phase B, a 4-mode x 8-column register tile of the coefficient gradient
//   per thread, held across the block's channel loop (the first 64 modes);
//   modes past 64 accumulate in the output itself, the block owning its
//   pairs', tile by tile.
// - Padding groups (the packing's record of which groups hold a baseline,
//   `valid`): their planes are not read and their loss, dpr, dpi and
//   dcoeffs come out zero; a block whose pairs are all padding writes its
//   zeros and leaves.
// - Every sum is taken in a fixed order and nothing uses atomics: the
//   per-pair loss partials are summed over a block's channels by a fixed
//   shuffle tree, over the cluster in split order and over groups by the
//   caller, so two launches are equal to the bit.
// Any N, G, F and V are taken for which a ring of two (or one) tiles and
// the coefficients fit in shared memory: V up to 420 float32 or 555
// bfloat16 modes with two tiles, 557 or 664 with one; the gate in
// ops/shared.py leaves larger V to the torch ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;            // blocks an SM (168 registers a thread)
constexpr int kPairs = 32;               // (group, slice) pairs a block
constexpr int kCols = 2 * kPairs;        // columns: (re, im) of each pair
constexpr int kRows = 32;                // channels a tile
constexpr int kCS = kCols + 4;           // row stride of the column tiles (float4-aligned)
constexpr int kModesB = 4;               // phase B: modes a thread (mg + 16 i)
constexpr int kModeGroups = 16;          // phase B: mode lanes
constexpr int kCapacity = kModesB * kModeGroups;  // modes held in registers
constexpr size_t kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

enum Mode { kLossOnly = 0, kLossDp = 1, kLossAll = 2 };

// the comps tile's row stride in elements: V rounded up to 16 bytes, plus 16
// bytes (rows of a phase-A warp's reads in distinct banks)
__host__ __device__ inline long long row_stride(long long V, int csize) {
  const long long unit = 16 / csize;
  return (V + unit - 1) / unit * unit + unit;
}

__host__ __device__ inline size_t smem_bytes(long long V, int csize, int stages) {
  return static_cast<size_t>(stages) * kRows * row_stride(V, csize) * csize +
         static_cast<size_t>(V) * kCS * 4 + static_cast<size_t>(kRows) * kCS * 4;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// s[i][j] += c[i] * (a, b)[j] for two float4 columns
template <int R>
__device__ __forceinline__ void fma8(float (&s)[R][8], const float (&c)[R], const float4 a,
                                     const float4 b) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i][0] = fmaf(c[i], a.x, s[i][0]);
    s[i][1] = fmaf(c[i], a.y, s[i][1]);
    s[i][2] = fmaf(c[i], a.z, s[i][2]);
    s[i][3] = fmaf(c[i], a.w, s[i][3]);
    s[i][4] = fmaf(c[i], b.x, s[i][4]);
    s[i][5] = fmaf(c[i], b.y, s[i][5]);
    s[i][6] = fmaf(c[i], b.z, s[i][6]);
    s[i][7] = fmaf(c[i], b.w, s[i][7]);
  }
}

template <typename TC, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
shared_chunk_loss_kernel(const TC* __restrict__ comps, const float* __restrict__ coeffs2,
                         const float* __restrict__ pr, const float* __restrict__ pi,
                         const float* __restrict__ dr, const float* __restrict__ di,
                         int64_t d_sn, int64_t d_sg, int64_t d_sf, const void* __restrict__ w,
                         int w_bf16, int64_t w_sn, int64_t w_sg, int64_t w_sf,
                         const unsigned char* __restrict__ valid, float* __restrict__ partials,
                         float* __restrict__ dcoeffs, float* __restrict__ dpr,
                         float* __restrict__ dpi, int64_t N, int64_t G, int64_t F, int64_t V,
                         int64_t gmax, int blocks_per_op, int stages, int vec16,
                         int splits) {
  constexpr bool kDp = MODE >= kLossDp;
  constexpr bool kAll = MODE == kLossAll;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int Vs = static_cast<int>(V);
  const int RS = static_cast<int>(row_stride(V, sizeof(TC)));
  const size_t tile_bytes = static_cast<size_t>(kRows) * RS * sizeof(TC);
  float* coef = reinterpret_cast<float*>(smem + stages * tile_bytes);
  float* red = coef + static_cast<size_t>(V) * kCS;

  // a cluster of `splits` blocks takes one tile of pairs; block `split` of it
  // the channel tiles [jt0, jt1)
  const int split = blockIdx.x % splits;
  const int pair_tile = blockIdx.x / splits;
  const int64_t u = pair_tile / blocks_per_op;
  const int64_t q0 = static_cast<int64_t>(pair_tile % blocks_per_op) * kPairs;
  const int64_t npairs = gmax * N;  // the operator's (group, slice) pairs, group-major
  const int64_t GF = G * F;
  const TC* op = comps + u * F * V;
  const int ntiles = static_cast<int>((F + kRows - 1) / kRows);
  const int jt0 = split * ntiles / splits, jt1 = (split + 1) * ntiles / splits;
  // pair p of the block: its slice n and group g; whether the operator has it
  auto pair_at = [&](int p, int& n, int& g) {
    const int64_t q = q0 + p;
    g = static_cast<int>(u * gmax + q / N);
    n = static_cast<int>(q % N);
    return q < npairs;
  };

  // a block of padding only writes its zeros
  {
    bool mine = false;
    if (t < kPairs) {
      int n, g;
      mine = pair_at(t, n, g) && (valid == nullptr || valid[g]);
    }
    if (!__syncthreads_or(mine)) {
      for (int p = 0; p < kPairs && split == 0; ++p) {
        int n, g;
        if (!pair_at(p, n, g)) break;
        if (t == 0) partials[n * G + g] = 0.f;
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

  // the block's coefficients, (V, 64): column 2 p + c is part c of pair p
  for (int64_t idx = t; idx < static_cast<int64_t>(kCols) * V; idx += kThreads) {
    const int col = static_cast<int>(idx / V);
    const int64_t k = idx - col * V;
    int n, g;
    coef[k * kCS + col] = pair_at(col >> 1, n, g)
        ? coeffs2[(((col & 1) * N + n) * G + g) * V + k] : 0.f;
  }

  // phase A: channels ra, ra + 16 and columns [ca * 8, ca * 8 + 8)
  const int ca = t % 8, ra = t / 8;
  // epilogue: channel fe of the tile, pairs pw + 4 j
  const int fe = t % 32, pw = t / 32;
  constexpr int kPer = kPairs / (kThreads / 32);
  // phase B: modes mb + 16 i and columns [cb * 8, cb * 8 + 8)
  const int mb = t % kModeGroups, cb = t / kModeGroups;

  int en[kPer], eg[kPer];  // 32-bit: registers are what the epilogue is short of
  bool ein[kPer], eok[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    ein[j] = pair_at(pw + 4 * j, en[j], eg[j]);
    eok[j] = ein[j] && (valid == nullptr || valid[eg[j]]);
  }
  if constexpr (kAll) {
    // modes past the register tiles accumulate in the output itself; each
    // (mode, column) belongs to one thread throughout
    for (int64_t k0 = kCapacity; k0 < V; k0 += kCapacity) {
#pragma unroll
      for (int i = 0; i < kModesB; ++i) {
        const int64_t k = k0 + mb + kModeGroups * i;
        if (k >= V) continue;
        for (int j = 0; j < 8; ++j) {
          const int col = cb * 8 + j;
          int n, g;
          if (pair_at(col >> 1, n, g)) dcoeffs[(((col & 1) * N + n) * G + g) * V + k] = 0.f;
        }
      }
    }
  }

  // the comps tile jt into its stage
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
          cp_async16(reinterpret_cast<unsigned char*>(dst + r * RS) + 16 * c,
                     reinterpret_cast<const unsigned char*>(src + r * V) + 16 * c);
        }
      } else {
        for (int q = t; q < rows * Vs; q += kThreads) {
          const int r = q / Vs, k = q - r * Vs;
          dst[r * RS + k] = src[static_cast<int64_t>(r) * V + k];
        }
      }
    }
    cp_async_commit();  // one group a tile, empty past the last
  };

  float lacc[kPer];
  float acc[kModesB][8];
#pragma unroll
  for (int j = 0; j < kPer; ++j) lacc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kModesB; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  issue(jt0);
  if (stages > 1) issue(jt0 + 1);
  for (int jt = jt0; jt < jt1; ++jt) {
    const int64_t f0 = static_cast<int64_t>(jt) * kRows;
    const int rows = static_cast<int>(F - f0 < kRows ? F - f0 : kRows);
    const int64_t f = f0 + fe;
    const bool erow = fe < rows;
    // this thread's planes of the tile, loaded before the wait
    float p_r[kPer], p_i[kPer], d_r[kPer], d_i[kPer], wv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      p_r[j] = p_i[j] = d_r[j] = d_i[j] = wv[j] = 0.f;
      if (erow && eok[j]) {
        const int64_t prow = en[j] * GF + eg[j] * F + f;
        const int64_t drow = en[j] * d_sn + eg[j] * d_sg + f * d_sf;
        const int64_t wrow = en[j] * w_sn + eg[j] * w_sg + f * w_sf;
        p_r[j] = pr[prow];
        p_i[j] = pi[prow];
        d_r[j] = dr[drow];
        d_i[j] = di[drow];
        wv[j] = w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[wrow])
                       : static_cast<const float*>(w)[wrow];
      }
    }
    if (stages > 1) {
      cp_async_wait_one();
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();  // the tile (and, first, the coefficients) are in
    const TC* tile = reinterpret_cast<const TC*>(smem + ((jt - jt0) % stages) * tile_bytes);

    // phase A: the model's dot products, over the modes in order; channels
    // past the tile read stale rows and are dropped
    {
      float s[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      }
      const TC* r0 = tile + ra * RS;
      const TC* r1 = tile + (ra + 16) * RS;
      const float* cf = coef + ca * 8;
#pragma unroll 4
      for (int k = 0; k < Vs; ++k) {
        const float c[2] = {to_f32(r0[k]), to_f32(r1[k])};
        const float4 a = *reinterpret_cast<const float4*>(cf + k * kCS);
        const float4 b = *reinterpret_cast<const float4*>(cf + k * kCS + 4);
        fma8<2>(s, c, a, b);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* out = red + (ra + 16 * i) * kCS + ca * 8;
        *reinterpret_cast<float4*>(out) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        *reinterpret_cast<float4*>(out + 4) = make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
      }
    }
    __syncthreads();  // the model tile is complete

    // epilogue: channel fe, this thread's pairs
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (!(erow && ein[j])) continue;
      const int p = pw + 4 * j;
      float* m = red + fe * kCS + 2 * p;
      const float sr = m[0], si = m[1];
      const float mr = p_r[j] * sr + p_i[j] * si;
      const float mi = -p_i[j] * sr + p_r[j] * si;
      const float er = d_r[j] - mr;
      const float ei = d_i[j] - mi;
      lacc[j] += wv[j] * (er * er + ei * ei);
      if constexpr (kDp) {
        const float dmr = -2.f * wv[j] * er;
        const float dmi = -2.f * wv[j] * ei;
        const int64_t prow = en[j] * GF + eg[j] * F + f;
        dpr[prow] = sr * dmr + si * dmi;
        dpi[prow] = si * dmr - sr * dmi;
        if constexpr (kAll) {
          m[0] = p_r[j] * dmr - p_i[j] * dmi;
          m[1] = p_i[j] * dmr + p_r[j] * dmi;
        }
      }
    }

    if constexpr (kAll) {
      __syncthreads();  // the dv tile is complete
      // phase B: the coefficient gradient, over the tile's channels in order
      const float* dcol = red + cb * 8;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const TC* row = tile + r * RS;
        float c[kModesB];
#pragma unroll
        for (int i = 0; i < kModesB; ++i) {
          const int k = mb + kModeGroups * i;
          c[i] = k < Vs ? to_f32(row[k]) : 0.f;
        }
        const float4 a = *reinterpret_cast<const float4*>(dcol + r * kCS);
        const float4 b = *reinterpret_cast<const float4*>(dcol + r * kCS + 4);
        fma8<kModesB>(acc, c, a, b);
      }
      for (int k0 = kCapacity; k0 < Vs; k0 += kCapacity) {
        float x[kModesB][8];
#pragma unroll
        for (int i = 0; i < kModesB; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) x[i][j] = 0.f;
        }
        for (int r = 0; r < rows; ++r) {
          const TC* row = tile + r * RS;
          float c[kModesB];
#pragma unroll
          for (int i = 0; i < kModesB; ++i) {
            const int k = k0 + mb + kModeGroups * i;
            c[i] = k < Vs ? to_f32(row[k]) : 0.f;
          }
          const float4 a = *reinterpret_cast<const float4*>(dcol + r * kCS);
          const float4 b = *reinterpret_cast<const float4*>(dcol + r * kCS + 4);
          fma8<kModesB>(x, c, a, b);
        }
#pragma unroll
        for (int i = 0; i < kModesB; ++i) {
          const int64_t k = k0 + mb + kModeGroups * i;
          if (k >= V) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = cb * 8 + j;
            int n, g;
            if (pair_at(col >> 1, n, g)) dcoeffs[(((col & 1) * N + n) * G + g) * V + k] += x[i][j];
          }
        }
      }
    }
    __syncthreads();  // every read of this stage and of the column tile is done
    issue(jt + stages);
  }

  // each pair's loss over this block's channels: the channel lanes' partials
  // summed by a fixed shuffle tree over the warp
  float* lsum = red;  // (32,): the block's per-pair losses
  float* part = coef;  // (min(V, 64), 64): the block's coefficient gradient
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    float s = lacc[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (fe == 0) lsum[pw + 4 * j] = s;
  }
  if constexpr (kAll) {
#pragma unroll
    for (int i = 0; i < kModesB; ++i) {
      const int k = mb + kModeGroups * i;
      if (k >= Vs) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) part[k * kCols + cb * 8 + j] = acc[i][j];
    }
  }
  // the cluster's blocks sum their parts in split order, each block a share
  // of the entries, reading the others' shared memory (one block: its own)
  const int kv = kAll ? (Vs < kCapacity ? Vs : kCapacity) : 0;
  const int entries = kv * kCols + kPairs;
  if (splits > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  for (int e = split * kThreads + t; e < entries; e += splits * kThreads) {
    const bool loss = e >= kv * kCols;
    const int p = loss ? e - kv * kCols : (e % kCols) >> 1;
    int n, g;
    if (!pair_at(p, n, g)) continue;
    float s = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* src = splits > 1 ? cg::this_cluster().map_shared_rank(loss ? lsum : part, r)
                                    : (loss ? lsum : part);
      s += src[loss ? p : e];
    }
    if (loss) {
      partials[n * G + g] = s;
    } else {
      dcoeffs[((((e % kCols) & 1) * N + n) * G + g) * V + e / kCols] = s;
    }
  }
  if (splits > 1) cg::this_cluster().sync();  // no block leaves while others read it
}

// two tiles in the ring where they fit, else one; 0 where not even one fits
int plan_stages(long long V, int csize) {
  for (int stages = 2; stages >= 1; --stages) {
    if (smem_bytes(V, csize, stages) <= kMaxSmem) return stages;
  }
  return 0;
}

// channel splits a tile of pairs: doubled (up to a cluster of 8, each block
// keeping at least one channel tile) while the launch has fewer than 8
// blocks an SM, so a chunk of few pair tiles still fills the card; one where
// modes past the register tiles accumulate in the output
int plan_splits(long long pair_tiles, long long F, long long V) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    sms = 132;
  }
  const long long ntiles = (F + kRows - 1) / kRows;
  int splits = 1;
  while (V <= kCapacity && splits < 8 && 2 * splits <= ntiles &&
         pair_tiles * splits < 8LL * sms) {
    splits *= 2;
  }
  return splits;
}

template <typename TC, int MODE>
int launch(int grid, int splits, int stages, int vec16, cudaStream_t s, const void* comps,
           const float* coeffs2, const float* pr, const float* pi, const float* dr,
           const float* di, int64_t d_sn, int64_t d_sg, int64_t d_sf, const void* w, int w_bf16,
           int64_t w_sn, int64_t w_sg, int64_t w_sf, const unsigned char* valid,
           float* partials, float* dcoeffs, float* dpr, float* dpi, int64_t N, int64_t G,
           int64_t F, int64_t V, int64_t gmax, int blocks_per_op) {
  const size_t smem = smem_bytes(V, sizeof(TC), stages);
  auto kernel = shared_chunk_loss_kernel<TC, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the blocks of one tile of pairs form a cluster of `splits`
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid) * splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TC*>(comps), coeffs2, pr, pi, dr, di, d_sn, d_sg, d_sf, w,
      w_bf16, w_sn, w_sg, w_sf, valid, partials, dcoeffs, dpr, dpi, N, G, F, V, gmax,
      blocks_per_op, stages, vec16, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC, typename... Args>
int launch_mode(int mode, Args... args) {
  switch (mode) {
    case kLossOnly: return launch<TC, kLossOnly>(args...);
    case kLossDp: return launch<TC, kLossDp>(args...);
    default: return launch<TC, kLossAll>(args...);
  }
}

}  // namespace

extern "C" {

// comps: (U, F, V) contiguous, float32 (comps_dtype 0) or bfloat16 (1);
// group g uses operator g / (G / U). coeffs2: (2, N, G, V) contiguous
// float32; pr, pi: (N, G, F) contiguous float32; dr, di: float32 at
// dr[n * d_sn + g * d_sg + f * d_sf]; w: float32 (w_dtype 0) or bfloat16 (1)
// at w[n * w_sn + g * w_sg + f * w_sf] (strides in elements); valid: (G,)
// bytes, nonzero where a group holds a baseline, or null for every group.
// Outputs, float32 and contiguous: partials (N, G), summed over G by the
// caller; for mode >= 1 dpr and dpi (N, G, F); for mode 2 dcoeffs (2, N, G,
// V); the gradients at a loss cotangent of 1. mode 0 is the loss only, 1
// the loss with dpr/dpi, 2 every gradient. All on the current device.
// Launches on `stream` and returns the launch's CUDA error (0 on success,
// cudaErrorInvalidValue for a shape it does not take); it does not
// synchronise.
int shared_chunk_loss(const void* comps, int comps_dtype, const float* coeffs2, const float* pr,
                      const float* pi, const float* dr, const float* di, long long d_sn,
                      long long d_sg, long long d_sf, const void* w, int w_dtype, long long w_sn,
                      long long w_sg, long long w_sf, const unsigned char* valid,
                      float* partials, float* dcoeffs, float* dpr, float* dpi, long long N,
                      long long G, long long F, long long V, long long U, int mode,
                      void* stream) {
  const int csize = comps_dtype == 0 ? 4 : 2;
  if (N <= 0 || G <= 0 || F <= 0 || V <= 0 || U <= 0 || G % U != 0 || N > INT_MAX ||
      G > INT_MAX || F > INT_MAX || V > INT_MAX || mode < 0 || mode > 2 ||
      (comps_dtype != 0 && comps_dtype != 1) || (w_dtype != 0 && w_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int stages = plan_stages(V, csize);
  const long long gmax = G / U;
  const long long per_op = (gmax * N + kPairs - 1) / kPairs;
  if (stages == 0 || per_op * U > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = reinterpret_cast<uintptr_t>(comps) % 16 == 0 && (V * csize) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(per_op * U);
  const int splits = plan_splits(per_op * U, F, V);
  if (static_cast<long long>(grid) * splits > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bpo = static_cast<int>(per_op);
  if (comps_dtype == 0) {
    return launch_mode<float>(mode, grid, splits, stages, vec16, s, comps, coeffs2, pr, pi, dr,
                              di, d_sn, d_sg, d_sf, w, w_dtype, w_sn, w_sg, w_sf, valid,
                              partials, dcoeffs, dpr, dpi, N, G, F, V, gmax, bpo);
  }
  return launch_mode<__nv_bfloat16>(mode, grid, splits, stages, vec16, s, comps, coeffs2, pr,
                                    pi, dr, di, d_sn, d_sg, d_sf, w, w_dtype, w_sn, w_sg, w_sf,
                                    valid, partials, dcoeffs, dpr, dpi, N, G, F, V, gmax, bpo);
}

}  // extern "C"
