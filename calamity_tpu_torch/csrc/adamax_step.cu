// The Adamax update with the descent's gating, and the descent's carry,
// for Hopper (sm_90a): two kernels, one launch each a step.
//
// What they replace: no TPU kernel. The reference runs its optimizer
// (optax.adamax, calamity_tpu/solver/optimizers.py:152) and the loop's
// bookkeeping inside one jitted lax.while_loop body
// (calamity_tpu/solver/fit.py:172-193 with _tree_where at :79;
// calamity_tpu/parallel/batched.py:505-552 with keep_frozen), which XLA
// fuses into a few loops. The port's torch ops spent about eleven
// elementwise launches a leaf on the update, one torch.where a leaf for
// the parameters, each moment and the best parameters, and some 15 scalar
// launches on the bookkeeping: about 600 launches a step on the full HERA
// array's 38 leaves, each a pass over its leaf.
//
// What bounds them: bytes. `adamax_step` must read the gradient, the
// parameter and both moments of every element it updates and write the
// parameter and both moments back, and the best parameter where the loss
// improved; its arithmetic is 8 operations an element. A frozen slice's
// rows are neither read nor written (unless the slice's loss improved,
// when its parameters are copied to the best ones). `descent_carry` moves
// a few hundred bytes; its time is its launch.
//
// The design:
// - `adamax_step` takes a table of leaves by value in its arguments (so a
//   CUDA-graph capture records it, and no host-to-device copy is
//   captured): each leaf's five pointers, its element count and its row
//   length along the slice axis (0: unbatched). One launch takes up to
//   kMaxLeaves leaves (a table of 48 fits the 4 KB parameter space); the
//   C launcher splits a longer table over more launches, as PyTorch's
//   multi_tensor_apply does.
// - Each leaf is cut into tiles of kThreads x kIters vectors; a block
//   takes one tile and finds its leaf in the table's tile prefix. A thread
//   takes 16-byte vectors (float4, double2) where the leaf's pointers are
//   16-byte aligned and its rows hold whole vectors, else single elements;
//   the leaf's ragged end is taken element by element.
// - Every block computes the gate itself from the carry's device scalars,
//   which only `descent_carry` writes, after it: `live` (the reference's
//   cond) and `is_best`; in the batched descent per row (`~frozen & live`,
//   `recorded_live & losses < best_loss`). Under a mesh `live` is the
//   ranks' any-rows flag, an input. No block writes the step count.
// - The arithmetic is the torch ops', operation by operation, in the
//   parameter's type: every product, sum and quotient rounded on its own
//   (__fmul_rn, __fadd_rn, __fdiv_rn; no fused multiply-add), the
//   hyperparameters rounded to the type first, and the second moment's
//   maximum propagating a NaN as torch.maximum does. So the kernel equals
//   the plain version to the bit, a NaN gradient included.
// - `descent_carry` is one block: the serial carry on one thread; the
//   batched carry a row a thread, the all-frozen test a block reduction
//   taken before any row is written. It writes the history slot, |delta
//   loss|, the best loss, the steps since it, the freeze mask and the
//   slices' step counts, the last loss, the step and the optimizer's count,
//   in the torch ops' order and NaN semantics (torch.minimum propagates a
//   NaN).
//
// C interface (loaded with ctypes): adamax_step(...) and descent_carry(...)
// return the CUDA error of their launches (0 on success); they launch on
// the given stream and do not synchronise.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

extern "C" {

// One leaf of the parameter tree (the host's table; see adamax_step).
struct AdamaxLeaf {
  void* p;          // parameter, updated in place
  const void* g;    // gradient
  void* mu;         // first moment, in place
  void* nu;         // second moment, in place
  void* best;       // best parameter, in place; null where none is tracked
  long long n;      // elements
  long long row;    // elements a slice along the leading axis; 0: unbatched
};

// The descent's carry on the device. Serial (batched == 0): `step`,
// `end`, `delta`, `prev`, `best_loss`, `since`, `loss` (0-d) and a
// (capacity,) history, all floats in the parameters' type. Batched: `step`
// is the segment's live steps taken and `end` their limit, `warmup` the
// unrecorded steps at its start, `step0` the global steps before it,
// `frozen` (nbatch,) bool, `prev` and `loss` (nbatch,) in the parameters'
// type, `best_loss` null unless tracked, `since` null without patience,
// `nsteps_slice` (nbatch,) int64, a (capacity, nbatch) float32 history,
// and `live` the 0-d any-rows flag under a mesh (else null).
struct DescentCarry {
  int batched;
  int nbatch;
  long long* step;
  long long* end;
  const long long* warmup;
  const long long* step0;
  void* delta;
  void* prev;
  void* best_loss;
  long long* since;
  const void* loss;
  void* history;
  unsigned char* frozen;
  const unsigned char* live;
  long long* nsteps_slice;
  long long* count;
  long long capacity;
  long long patience;  // 0: none
  double tol;
  double big;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 4;       // vectors a thread a tile
constexpr int kMaxLeaves = 48;  // leaves one launch of adamax_step takes

struct DevLeaf {
  void* p;
  const void* g;
  void* mu;
  void* nu;
  void* best;
  long long n;
  long long row;
  int vec;  // 16-byte vectors
};

struct Hyper {
  const void* bias;  // 1 - b1**k, k = 0 .. bias_len - 1, in the parameters' type
  long long bias_len;
  double c1;  // 1 - beta_1, as the host forms it
  double b1;
  double b2;
  double eps;
  double neg_lr;
};

struct StepArgs {
  DevLeaf leaf[kMaxLeaves];
  long long tile0[kMaxLeaves + 1];  // tiles before each leaf
  int nleaves;
  DescentCarry carry;
  Hyper hyper;
};
static_assert(sizeof(StepArgs) <= 4096, "the leaf table must fit the kernel's parameters");

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
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(double a) { return __double2float_rn(a); }
__device__ __forceinline__ bool finite(float a) { return fabsf(a) <= FLT_MAX; }
__device__ __forceinline__ bool finite(double a) { return fabs(a) <= DBL_MAX; }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }

// torch.maximum / torch.minimum on CUDA: a NaN operand is returned as it is
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return a != a ? a : (b != b ? b : max_of(a, b));
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return a != a ? a : (b != b ? b : min_of(a, b));
}

// The reference's cond (solver/fit.py:_Descent._live)
template <typename T>
__device__ __forceinline__ bool serial_live(const DescentCarry& c) {
  bool live = *c.step < *c.end && *static_cast<const T*>(c.delta) >= static_cast<T>(c.tol)
              && finite(*static_cast<const T*>(c.prev));
  if (c.patience > 0) live = live && *c.since < c.patience;
  return live;
}

// The batched step's live flag: within the segment and some slice runs
// (under a mesh the ranks' any-rows flag). Every thread of the block calls
// it: the all-frozen test is a block reduction.
__device__ __forceinline__ bool batched_live(const DescentCarry& c) {
  int all = 1;
  if (c.live == nullptr) {
    for (int r = threadIdx.x; r < c.nbatch; r += blockDim.x) all &= c.frozen[r] != 0;
  }
  all = __syncthreads_and(all);
  if (c.live != nullptr) return *c.live != 0;
  return *c.step < *c.end && !all;
}

template <typename T>
struct Consts {
  T c1, b1, b2, eps, neg_lr, bc;
};

// optimizers.adamax's update of one element, the torch ops' order:
// mu' = (1-b1) g + b1 mu; nu' = maximum(|g| + eps, b2 nu);
// p' = p + ((mu' / bc) / nu') * (-lr)
template <typename T>
__device__ __forceinline__ void update(T g, T& p, T& m, T& v, const Consts<T>& k) {
  const T m2 = add_rn(mul_rn(k.c1, g), mul_rn(k.b1, m));
  const T v2 = nan_max(add_rn(abs_of(g), k.eps), mul_rn(k.b2, v));
  p = add_rn(p, mul_rn(div_rn(div_rn(m2, k.bc), v2), k.neg_lr));
  m = m2;
  v = v2;
}

// VEC elements from `e` of one leaf (all in one row): updated where
// `active`, the (updated) parameters copied to the best ones where `best`
template <typename T, int VEC>
__device__ __forceinline__ void update_at(const DevLeaf& L, long long e, bool active, bool best,
                                          const Consts<T>& k) {
  using V = Vec<T, VEC>;
  V* p = reinterpret_cast<V*>(static_cast<T*>(L.p) + e);
  V pv = *p;
  if (active) {
    const V gv = *reinterpret_cast<const V*>(static_cast<const T*>(L.g) + e);
    V* mu = reinterpret_cast<V*>(static_cast<T*>(L.mu) + e);
    V* nu = reinterpret_cast<V*>(static_cast<T*>(L.nu) + e);
    V mv = *mu, nv = *nu;
#pragma unroll
    for (int c = 0; c < VEC; ++c) update(gv.v[c], pv.v[c], mv.v[c], nv.v[c], k);
    *p = pv;
    *mu = mv;
    *nu = nv;
  }
  if (best) *reinterpret_cast<V*>(static_cast<T*>(L.best) + e) = pv;
}

// One tile of one leaf, VEC elements at a time (VEC = 1: element by
// element); the gate of a batched leaf read per row.
template <typename T, int VEC>
__device__ void update_tile(const DevLeaf& L, long long t, const DescentCarry& c, bool live,
                            bool rec_live, bool is_best, const Consts<T>& k) {
  constexpr long long kTileElems = static_cast<long long>(kThreads) * kIters * (16 / sizeof(T));
  const long long start = t * kTileElems;
  const long long stop = start + kTileElems < L.n ? start + kTileElems : L.n;
  const T* losses = static_cast<const T*>(c.loss);
  const T* best_loss = static_cast<const T*>(c.best_loss);
  const bool track = L.best != nullptr;
  bool active = live, best = is_best && track;
  long long row_end = -1;  // a batched leaf: the end of the row the flags are of
  for (long long e = start + static_cast<long long>(threadIdx.x) * VEC; e < stop;
       e += static_cast<long long>(kThreads) * VEC) {
    if (L.row > 0 && e >= row_end) {  // a new row: its gate (one division a row crossed)
      const long long r = e / L.row;
      row_end = (r + 1) * L.row;
      active = live && c.frozen[r] == 0;
      best = track && rec_live && losses[r] < best_loss[r];
    }
    if (!active && !best) continue;  // a frozen slice's rows are not read
    if (VEC == 1 || e + VEC <= stop) {
      update_at<T, VEC>(L, e, active, best, k);
    } else {
      for (long long x = e; x < stop; ++x) update_at<T, 1>(L, x, active, best, k);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adamax_step_kernel(const __grid_constant__ StepArgs a) {
  const DescentCarry& c = a.carry;
  bool live, rec_live = false, is_best = false;
  if (c.batched) {
    live = batched_live(c);
    rec_live = live && *c.step - *c.warmup >= 0;
  } else {
    live = serial_live<T>(c);
    is_best = live && *static_cast<const T*>(c.loss) < *static_cast<const T*>(c.best_loss);
  }
  if (!live) return;  // no row moves, and no row is recorded

  int i = 0;
  while (i + 1 < a.nleaves && static_cast<long long>(blockIdx.x) >= a.tile0[i + 1]) ++i;
  const DevLeaf& L = a.leaf[i];
  const long long t = static_cast<long long>(blockIdx.x) - a.tile0[i];

  const T* bias = static_cast<const T*>(a.hyper.bias);
  const long long next = *c.count + 1;
  Consts<T> k;
  k.c1 = static_cast<T>(a.hyper.c1);
  k.b1 = static_cast<T>(a.hyper.b1);
  k.b2 = static_cast<T>(a.hyper.b2);
  k.eps = static_cast<T>(a.hyper.eps);
  k.neg_lr = static_cast<T>(a.hyper.neg_lr);
  k.bc = bias[next < a.hyper.bias_len - 1 ? next : a.hyper.bias_len - 1];

  if (L.vec) {
    update_tile<T, 16 / sizeof(T)>(L, t, c, live, rec_live, is_best, k);
  } else {
    update_tile<T, 1>(L, t, c, live, rec_live, is_best, k);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
descent_carry_kernel(const __grid_constant__ DescentCarry c) {
  const T big = static_cast<T>(c.big);
  const T tol = static_cast<T>(c.tol);
  if (!c.batched) {
    // solver/fit.py:_Descent's bookkeeping: nothing changes on a step
    // that is not live
    if (threadIdx.x != 0 || !serial_live<T>(c)) return;
    const T loss = *static_cast<const T*>(c.loss);
    T* prev = static_cast<T*>(c.prev);
    T* best_loss = static_cast<T*>(c.best_loss);
    const T old_prev = *prev, old_best = *best_loss;
    const bool is_best = loss < old_best;
    const long long slot = *c.step < c.capacity - 1 ? *c.step : c.capacity - 1;
    static_cast<T*>(c.history)[slot] = loss;
    *static_cast<T*>(c.delta) = old_prev < big ? abs_of(sub_rn(loss, old_prev)) : big;
    *best_loss = nan_min(loss, old_best);
    *c.since = is_best ? 0 : *c.since + 1;
    *prev = loss;
    *c.step += 1;
    *c.count += 1;
    return;
  }
  // parallel/batched.py:_BatchedDescent's bookkeeping, a row a thread
  const bool live = batched_live(c);  // every thread has read the freeze mask
  const long long idx = *c.step - *c.warmup;  // -1 on the warm-up step
  const bool rec = idx >= 0;
  const long long gstep = *c.step0 + idx;
  const long long slot = idx < 0 ? 0 : (idx < c.capacity - 1 ? idx : c.capacity - 1);
  const T* losses = static_cast<const T*>(c.loss);
  T* prev = static_cast<T*>(c.prev);
  T* best_loss = static_cast<T*>(c.best_loss);
  float* history = static_cast<float*>(c.history) + slot * c.nbatch;
  for (int r = threadIdx.x; r < c.nbatch; r += blockDim.x) {
    const bool active = live && c.frozen[r] == 0;
    const bool recording = active && rec;
    const bool recorded_live = live && rec;
    const T loss = losses[r];
    if (recording) history[r] = to_f32(loss);
    bool newly = recording && (!finite(loss)
                               || (gstep >= 1 && abs_of(sub_rn(loss, prev[r])) < tol));
    bool is_best = false;
    if (best_loss != nullptr) {
      is_best = recorded_live && loss < best_loss[r];
      if (is_best) best_loss[r] = loss;
    }
    if (c.since != nullptr && recording) {
      const long long since = is_best ? 0 : c.since[r] + 1;
      c.since[r] = since;
      newly = newly || since >= c.patience;
    }
    if (newly) {
      c.nsteps_slice[r] = gstep + 1;
      c.frozen[r] = 1;
    }
    if (recorded_live) prev[r] = loss;
  }
  __syncthreads();  // every thread has read the step before it moves
  if (threadIdx.x == 0 && live) {
    *c.step += 1;
    *c.count += 1;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch_steps(const AdamaxLeaf* leaves, int nleaves, const DescentCarry& carry,
                 const Hyper& hyper, cudaStream_t stream, int* launched) {
  constexpr long long kVec = 16 / sizeof(T);
  constexpr long long kTileElems = static_cast<long long>(kThreads) * kIters * kVec;
  for (int first = 0; first < nleaves; first += kMaxLeaves) {
    StepArgs a;
    a.nleaves = nleaves - first < kMaxLeaves ? nleaves - first : kMaxLeaves;
    a.carry = carry;
    a.hyper = hyper;
    long long tiles = 0;
    for (int i = 0; i < a.nleaves; ++i) {
      const AdamaxLeaf& h = leaves[first + i];
      DevLeaf& d = a.leaf[i];
      d.p = h.p;
      d.g = h.g;
      d.mu = h.mu;
      d.nu = h.nu;
      d.best = h.best;
      d.n = h.n;
      d.row = h.row;
      d.vec = aligned16(h.p) && aligned16(h.g) && aligned16(h.mu) && aligned16(h.nu)
              && (h.best == nullptr || aligned16(h.best)) && h.row % kVec == 0;
      a.tile0[i] = tiles;
      tiles += (h.n + kTileElems - 1) / kTileElems;
    }
    a.tile0[a.nleaves] = tiles;
    if (tiles == 0) continue;
    if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    adamax_step_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return 0;
}

bool carry_ok(const DescentCarry* c) {
  if (c == nullptr || c->step == nullptr || c->end == nullptr || c->prev == nullptr
      || c->loss == nullptr || c->history == nullptr || c->count == nullptr
      || c->capacity < 1) {
    return false;
  }
  if (!c->batched) {
    return c->delta != nullptr && c->best_loss != nullptr && c->since != nullptr;
  }
  return c->nbatch >= 1 && c->warmup != nullptr && c->step0 != nullptr
         && c->frozen != nullptr && c->nsteps_slice != nullptr
         && (c->since == nullptr || c->best_loss != nullptr);
}

}  // namespace

extern "C" {

// The Adamax update of `nleaves` leaves (`leaves`: a host array), gated by
// `carry` as the descent's step gates it; every leaf of one floating type
// (dtype 0: float32, 1: float64), contiguous; `bias` the optimizer's
// bias-correction table in that type on the device (`bias_len` entries).
// `*launched` takes the number of launches (kMaxLeaves leaves each; none
// when the leaves hold no element).
int adamax_step(const AdamaxLeaf* leaves, int nleaves, const DescentCarry* carry,
                const void* bias, long long bias_len, double c1, double b1, double b2,
                double eps, double neg_lr, int dtype, int* launched, void* stream) {
  *launched = 0;
  if (nleaves < 0 || (nleaves > 0 && leaves == nullptr) || !carry_ok(carry) || bias == nullptr
      || bias_len < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < nleaves; ++i) {
    const AdamaxLeaf& h = leaves[i];
    if (h.p == nullptr || h.g == nullptr || h.mu == nullptr || h.nu == nullptr || h.n < 0
        || (carry->batched ? h.row < 1 || h.n != h.row * carry->nbatch : h.row != 0)
        || (h.best != nullptr && carry->best_loss == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Hyper hyper{bias, bias_len, c1, b1, b2, eps, neg_lr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_steps<float>(leaves, nleaves, *carry, hyper, s, launched)
                    : launch_steps<double>(leaves, nleaves, *carry, hyper, s, launched);
}

// The descent's bookkeeping after adamax_step (see DescentCarry), in the
// parameters' type (dtype 0: float32, 1: float64); one launch.
int descent_carry(const DescentCarry* carry, int dtype, void* stream) {
  if (!carry_ok(carry) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    descent_carry_kernel<float><<<1, kThreads, 0, s>>>(*carry);
  } else {
    descent_carry_kernel<double><<<1, kThreads, 0, s>>>(*carry);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
