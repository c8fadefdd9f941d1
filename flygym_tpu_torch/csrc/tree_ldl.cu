// Tree-sparse LDL^T factor (K1) and solve (K1b) of the contact Hessian for
// NVIDIA Hopper (sm_90a): one warp per world, four worlds per block.
//
// What each function replaces (TPU kernels of the JAX package):
//   tree_ldl_factor_f32  ->  flygym_tpu/ops/ldl_pallas.py  _factor_kernel
//                            (launched by _factor_batched_pallas)
//   tree_ldl_solve_f32   ->  flygym_tpu/ops/ldl_pallas.py  _solve_kernel
//                            (launched by _solve_batched_pallas)
// Their plain PyTorch versions, used for CPU tensors and as the oracle on the
// card, are flygym_tpu_torch/engine/linalg.py tree_ldl_factor/tree_ldl_solve.
// scripts/k1_before_redesign/tree_ldl.cu keeps the kernels as they stood
// before this design (one thread per world over a dense world-minor working
// copy of H); these give its L, d and x to the last bit.
//
// The work: a chain of dependent scalar updates per world over static
// tables. DoFs are eliminated leaves-first, one height level at a time; DoF
// i's row downdates the lower triangle of its ancestor block. Only the
// envelope is ever read: each DoF's diagonal and its row over its ancestor
// chain (813 of the benchmark fly's 5,184 entries of H).
//
// Design. A warp holds one world in shared memory: the envelope, packed row
// by row (flygym_tpu_torch/engine/linalg.py kernel_tables), and L over the
// chains. It reads the envelope straight from H as the engine writes it,
// (B, nv, nv) batch-first, and writes L (B, nv, maxc) with its zero padding
// and d (B, nv), coalesced. Per height level the lanes take the level's L
// entries (each with 1 / d_i: IEEE division rounds once, so recomputing it
// per entry gives the serial kernel's bits), then its downdates through
// owner tables: each target entry belongs to one lane, which subtracts the
// target's contributions in elimination order. So every entry sees the same
// sequence of roundings as in the serial elimination (DoFs of one level are
// never ancestors of each other, so a level's rows are final together), and
// with -fmad=false the bits are the serial kernel's. The solve holds y and
// L's chain entries: its first pass runs the same owner tables per height
// level, then the diagonal, then one lane per DoF of each depth level
// gathers over its chain in order. __syncwarp() separates the phases.
// Four worlds per block: 1, 2, 4 and 8 took the same time within 3% on the
// H100 (scripts/ldl_worlds_sweep.py builds the others with -DLDL_WORLDS).
//
// What bounds it on the H100: one warp's latency. Per world the factor
// applies 4,721 contributions to 3,566 targets over 17 levels (the fly),
// the solve ~1,500 operations; their bytes (H's envelope, L, d, b, x) take
// 8 and 5 us at the memory's rate for 4096 worlds. Each target is one 8-byte
// record read through the read-only path, four in flight per lane, but a
// level still waits on reads from the L2 (the shared memory of 31 worlds
// an SM leaves the L1 smaller than the tables), so one world alone takes
// about half of the factor's 4096-world time and most of the solve's.

// The same file compiles as host C++ (g++ -x c++): the warp becomes a loop
// over its lanes' items, in order or reversed (tree_ldl_factor_host_f32,
// tree_ldl_solve_host_f32), so the schedule is tested on the CPU against
// the serial kernels, and a result that depends on the order of a phase's
// items (a race on the card) shows there.
//
// Interface: plain C, bound with ctypes (flygym_tpu_torch/ops/_build.py).
// Pointers are device pointers; the kernels allocate nothing, launch on the
// caller's stream, do not synchronise, and return cudaGetLastError().
//
// Arrays (float32, C order): H (B, nv, nv), L (B, nv, maxc), d, b, x
// (B, nv); tables: the int32 buffer LdlTables.kernel.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LDL_FN __device__ __forceinline__
#define LDL_HD __host__ __device__ inline
#define LDL_SYNC() __syncwarp()
#define LDL_UNROLL4 _Pragma("unroll 4")
#else
#include <vector>
#define LDL_FN inline
#define LDL_HD inline
#define LDL_UNROLL4
struct int2 {
  int x, y;
};
#define LDL_SYNC() \
  do {             \
  } while (0)
#endif

#include <cstddef>

// Worlds per block: ops/ldl.py WORLDS sizes the launch check from the same
// value. Only scripts/ldl_worlds_sweep.py builds another.
#ifndef LDL_WORLDS
#define LDL_WORLDS 4
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kWorlds = LDL_WORLDS;
static_assert(kWorlds >= 1 && kWorlds <= 32, "LDL_WORLDS: 1 to 32");
// Blocks per SM the registers must allow: 32 warps, 64 registers a thread.
// The shared memory keeps no more resident (the fly: 31 worlds an SM).
constexpr int kMinBlocks = 32 / kWorlds;
// Shared memory a block may use on the H100. It also keeps every packed
// offset below 2^16.
constexpr size_t kMaxShared = 232448;

// The sections of the tables buffer (linalg.py SECTIONS, in this order):
// t[s] is the offset of section s in t, t[kSections] the buffer's length,
// t[kSections + 1 + s] the section's length; each section starts on 16
// bytes. The owner tables (f_*: the factor's downdates, s_*: the solve's
// first pass) hold per level one record per target, {the target | its
// count << 16, its first contribution}, and its q-th contribution (q >= 1)
// at more[round[q - 1] + k], k the record's index.
enum Section {
  kEnvSrc,      // (n_env) row * nv + col in H of each envelope entry
  kScalePtr,    // (height levels + 1) into kScale
  kScale,       // {L offset | DoF << 16, envelope offset of the DoF's diagonal}
  kFRecPtr,     // (height levels + 1) into kFRec, in records
  kFRec,        // {envelope offset | count << 16, L offset | envelope offset << 16}
  kFRoundPtr,   // (height levels + 1) into kFRound
  kFRound,      // each level's rounds q >= 1: offset in kFMore less the level's first record
  kFMore,       // L offset | envelope offset << 16
  kSRecPtr,     // as kFRecPtr .. kFMore, for the solve's first pass:
  kSRec,        //   {DoF | count << 16, L offset | source DoF << 16}
  kSRoundPtr,
  kSRound,
  kSMore,
  kDepthPtr,    // (depth levels + 1) into kOrderDepth
  kOrderDepth,  // (nv) the depth levels concatenated
  kChainPtr,    // (nv + 1) into kChainIdx; row a of the envelope at
                // chain_ptr[a] + a, its diagonal at chain_ptr[a + 1] + a
  kChainIdx,    // (n_chain) ancestors, root first
  kChainDof,    // (n_chain) the DoF whose chain holds the entry
  kSections
};

// Reads of the tables: on the card through the read-only path, so that the
// compiler may issue them ahead of the shared-memory stores around them.
#ifdef __CUDACC__
LDL_FN int ld(const int* p) { return __ldg(p); }
LDL_FN int2 ld(const int2* p) { return __ldg(p); }
#else
inline int ld(const int* p) { return *p; }
inline int2 ld(const int2* p) { return *p; }
#endif

struct Tables {
  const int* t;
  LDL_FN const int* operator[](int s) const { return t + ld(t + s); }
  LDL_FN int count(int s) const { return ld(t + kSections + 1 + s); }
};

LDL_FN unsigned lo16(int e) { return static_cast<unsigned>(e) & 0xffffu; }
LDL_FN unsigned hi16(int e) { return static_cast<unsigned>(e) >> 16; }

// One of the owner tables (s: kFRecPtr or kSRecPtr), and a level of it:
// its records [lo, hi) and its rounds.
struct Level {
  int lo, hi;
  const int* round;
};
struct Owners {
  const int* rec_ptr;
  const int2* rec;
  const int* round_ptr;
  const int* round;
  const int* more;
  LDL_FN Owners(Tables t, int s)
      : rec_ptr(t[s]),
        rec(reinterpret_cast<const int2*>(t[s + 1])),
        round_ptr(t[s + 2]),
        round(t[s + 3]),
        more(t[s + 4]) {}
  LDL_FN Level level(int lev) const {
    return {ld(rec_ptr + lev), ld(rec_ptr + lev + 1), round + ld(round_ptr + lev)};
  }
  // Record k applied: x[target] less its contributions Lp[l] * x[r]
  // (l | r << 16), in order.
  LDL_FN void apply(int2 r, int k, const int* lev_round, const float* __restrict__ Lp,
                    float* __restrict__ x) const {
    float acc = x[lo16(r.x)];
    acc -= Lp[lo16(r.y)] * x[hi16(r.y)];
    for (unsigned q = 1; q < hi16(r.x); ++q) {
      const int e = ld(more + ld(lev_round + q - 1) + k);
      acc -= Lp[lo16(e)] * x[hi16(e)];
    }
    x[lo16(r.x)] = acc;
  }
};

// The items of a phase spread over the warp: on the card lane l takes
// lo + l, lo + l + 32, ...; on the host every item, in order or reversed.
struct ParIt {
  int i, step;
  LDL_FN int operator*() const { return i; }
  LDL_FN ParIt& operator++() {
    i += step;
    return *this;
  }
  LDL_FN bool operator!=(const ParIt& e) const { return step > 0 ? i < e.i : i > e.i; }
};
struct Par {
  int b, e, step;
  LDL_FN ParIt begin() const { return {b, step}; }
  LDL_FN ParIt end() const { return {e, step}; }
};
#ifdef __CUDACC__
struct Warp {
  int lane;
  LDL_FN Par each(int lo, int hi) const { return {lo + lane, hi, kWarp}; }
};
#else
struct Warp {
  bool reversed;
  Par each(int lo, int hi) const { return reversed ? Par{hi - 1, lo - 1, -1} : Par{lo, hi, 1}; }
};
#endif

// Floats of shared memory per world.
LDL_HD size_t factor_floats(int n_env, int n_chain) {
  return static_cast<size_t>(n_env) + n_chain;
}
LDL_HD size_t solve_floats(int nv, int n_chain) { return static_cast<size_t>(nv) + n_chain; }

inline bool bad_args(int nv, int maxc, int n_env, int n_chain, int B) {
  return nv <= 0 || maxc <= 0 || B <= 0 || n_env != nv + n_chain ||
         kWorlds * sizeof(float) * factor_floats(n_env, n_chain) > kMaxShared;
}

// One level of owner tables over the warp: each record's target owned by
// one lane. The factor's x is the envelope, the solve's y. On the card each
// lane reads four of its records at once, then applies them.
LDL_FN void owners(const Owners& o, Level lev, const float* __restrict__ Lp,
                   float* __restrict__ x, Warp w) {
#ifdef __CUDACC__
  constexpr int kAhead = 4;
  for (int k = lev.lo + w.lane; k < lev.hi; k += kAhead * kWarp) {
    int2 r[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (k + u * kWarp < lev.hi) r[u] = ld(o.rec + k + u * kWarp);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (k + u * kWarp < lev.hi) o.apply(r[u], k + u * kWarp, lev.round, Lp, x);
    }
  }
#else
  for (int k : w.each(lev.lo, lev.hi)) o.apply(ld(o.rec + k), k, lev.round, Lp, x);
#endif
}

// One world's factor. H: its (nv, nv) matrix; L (nv, maxc), d (nv): its
// outputs; env (n_env), Lp (n_chain): its shared scratch.
LDL_FN void factor_world(const float* __restrict__ H, float* __restrict__ L,
                         float* __restrict__ d, Tables t, int nv, int maxc,
                         float* __restrict__ env, float* __restrict__ Lp, Warp w) {
  const int* env_src = t[kEnvSrc];
  const int* scale_ptr = t[kScalePtr];
  const int2* scale = reinterpret_cast<const int2*>(t[kScale]);
  const int* chain_ptr = t[kChainPtr];
  const Owners owned(t, kFRecPtr);
  LDL_UNROLL4
  for (int p : w.each(0, t.count(kEnvSrc))) env[p] = H[ld(env_src + p)];
  LDL_SYNC();
  const int levels = t.count(kScalePtr) - 1;
  for (int lev = 0; lev < levels; ++lev) {
    const int s0 = ld(scale_ptr + lev), s1 = ld(scale_ptr + lev + 1);
    const Level down = owned.level(lev);
    // L[i, c] = A[i, chain(i)[c]] * (1 / d_i), entry p of the chains at
    // p + i of the envelope; 1 / d_i as the serial kernel rounds it, once
    // per entry.
    LDL_UNROLL4
    for (int k : w.each(s0, s1)) {
      const int2 e = ld(scale + k);
      const float inv_d = 1.0f / env[e.y];
      Lp[lo16(e.x)] = env[lo16(e.x) + hi16(e.x)] * inv_d;
    }
    LDL_SYNC();
    // A[a, b] -= L[i, ca] * A[i, cb] for the level's i, in their order.
    owners(owned, down, Lp, env, w);
    LDL_SYNC();
  }
  for (int k : w.each(0, nv * maxc)) {
    const int i = k / maxc, c = k - i * maxc;
    const int c0 = ld(chain_ptr + i);
    L[k] = c < ld(chain_ptr + i + 1) - c0 ? Lp[c0 + c] : 0.0f;
  }
  for (int i : w.each(0, nv)) d[i] = env[ld(chain_ptr + i + 1) + i];
}

// One world's solve L D L^T x = b. L (nv, maxc), d, b, x (nv): its rows;
// y (nv), Lp (n_chain): its shared scratch.
LDL_FN void solve_world(const float* __restrict__ L, const float* __restrict__ d,
                        const float* __restrict__ b, float* __restrict__ x, Tables t,
                        int nv, int maxc, float* __restrict__ y, float* __restrict__ Lp,
                        Warp w) {
  const int* chain_ptr = t[kChainPtr];
  const int* chain_idx = t[kChainIdx];
  const int* chain_dof = t[kChainDof];
  const int* depth_ptr = t[kDepthPtr];
  const int* order = t[kOrderDepth];
  for (int i : w.each(0, nv)) y[i] = b[i];
  LDL_UNROLL4
  for (int p : w.each(0, t.count(kChainIdx))) {
    const int i = ld(chain_dof + p);
    Lp[p] = L[i * maxc + p - ld(chain_ptr + i)];
  }
  LDL_SYNC();
  // Pass 1, leaves -> root: y_i is final at its height level and pushes to
  // its ancestors, each target's pushes in elimination order.
  const Owners owned(t, kSRecPtr);
  const int levels = t.count(kSRecPtr) - 1;
  for (int lev = 0; lev < levels; ++lev) {
    owners(owned, owned.level(lev), Lp, y, w);
    LDL_SYNC();
  }
  // The diagonal.
  for (int i : w.each(0, nv)) y[i] /= d[i];
  LDL_SYNC();
  // Pass 2, root -> leaves: one lane per DoF of a depth level gathers from
  // its final ancestors, c = 0 .. n - 1.
  const int depths = t.count(kDepthPtr) - 1;
  for (int lev = 0; lev < depths; ++lev) {
    for (int k : w.each(ld(depth_ptr + lev), ld(depth_ptr + lev + 1))) {
      const int i = ld(order + k);
      const int c0 = ld(chain_ptr + i), c1 = ld(chain_ptr + i + 1);
      float acc = y[i];
      LDL_UNROLL4
      for (int c = c0; c < c1; ++c) acc -= Lp[c] * y[ld(chain_idx + c)];
      y[i] = acc;
    }
    LDL_SYNC();
  }
  for (int i : w.each(0, nv)) x[i] = y[i];
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kWorlds * kWarp, kMinBlocks)
factor_kernel(const float* __restrict__ H, float* __restrict__ L, float* __restrict__ d,
              const int* __restrict__ t, int nv, int maxc, int n_env, int n_chain, int B) {
  extern __shared__ float sh[];
  const int warp = threadIdx.x / kWarp;
  const int world = blockIdx.x * kWorlds + warp;
  if (world >= B) return;  // the whole warp
  float* env = sh + warp * factor_floats(n_env, n_chain);
  const size_t w = static_cast<size_t>(world);
  factor_world(H + w * nv * nv, L + w * nv * maxc, d + w * nv, Tables{t}, nv, maxc, env,
               env + n_env, Warp{static_cast<int>(threadIdx.x % kWarp)});
}

__global__ void __launch_bounds__(kWorlds * kWarp, kMinBlocks)
solve_kernel(const float* __restrict__ L, const float* __restrict__ d,
             const float* __restrict__ b, float* __restrict__ x, const int* __restrict__ t,
             int nv, int maxc, int n_chain, int B) {
  extern __shared__ float sh[];
  const int warp = threadIdx.x / kWarp;
  const int world = blockIdx.x * kWorlds + warp;
  if (world >= B) return;  // the whole warp
  float* y = sh + warp * solve_floats(nv, n_chain);
  const size_t w = static_cast<size_t>(world);
  solve_world(L + w * nv * maxc, d + w * nv, b + w * nv, x + w * nv, Tables{t}, nv, maxc, y,
              y + nv, Warp{static_cast<int>(threadIdx.x % kWarp)});
}

// Lets kernel take smem dynamic shared bytes where that exceeds the default.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline dim3 grid_for(int B) { return dim3((B + kWorlds - 1) / kWorlds); }

}  // namespace

extern "C" int tree_ldl_factor_f32(const void* H, void* L, void* d, const void* tables,
                                   int nv, int maxc, int n_env, int n_chain, int B,
                                   void* stream) {
  if (bad_args(nv, maxc, n_env, n_chain, B)) return cudaErrorInvalidValue;
  const size_t smem = kWorlds * sizeof(float) * factor_floats(n_env, n_chain);
  const cudaError_t err = allow_shared(factor_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factor_kernel<<<grid_for(B), kWorlds * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(H), static_cast<float*>(L), static_cast<float*>(d),
      static_cast<const int*>(tables), nv, maxc, n_env, n_chain, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tree_ldl_solve_f32(const void* L, const void* d, const void* b, void* x,
                                  const void* tables, int nv, int maxc, int n_env,
                                  int n_chain, int B, void* stream) {
  if (bad_args(nv, maxc, n_env, n_chain, B)) return cudaErrorInvalidValue;
  const size_t smem = kWorlds * sizeof(float) * solve_floats(nv, n_chain);
  const cudaError_t err = allow_shared(solve_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  solve_kernel<<<grid_for(B), kWorlds * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(d), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<const int*>(tables), nv, maxc, n_chain, B);
  return static_cast<int>(cudaGetLastError());
}

// This build's launch for a model: shape[0] threads per block (32 per
// world), shape[1] and shape[2] the factor's dynamic shared bytes per block
// and blocks resident per SM, shape[3] and shape[4] the solve's.
extern "C" int tree_ldl_shape(int nv, int n_env, int n_chain, int* shape) {
  if (bad_args(nv, 1, n_env, n_chain, 1)) return cudaErrorInvalidValue;
  const size_t f_smem = kWorlds * sizeof(float) * factor_floats(n_env, n_chain);
  const size_t s_smem = kWorlds * sizeof(float) * solve_floats(nv, n_chain);
  cudaError_t err = allow_shared(factor_kernel, f_smem);
  if (err == cudaSuccess) err = allow_shared(solve_kernel, s_smem);
  int f_blocks = 0, s_blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f_blocks, factor_kernel,
                                                        kWorlds * kWarp, f_smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s_blocks, solve_kernel,
                                                        kWorlds * kWarp, s_smem);
  }
  shape[0] = kWorlds * kWarp;
  shape[1] = static_cast<int>(f_smem);
  shape[2] = f_blocks;
  shape[3] = static_cast<int>(s_smem);
  shape[4] = s_blocks;
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else

}  // namespace

// The kernels on the host, world after world, each warp's phases as loops
// over their items: in order (order 0) or reversed (1).
extern "C" int tree_ldl_factor_host_f32(const float* H, float* L, float* d, const int* tables,
                                        int nv, int maxc, int n_env, int n_chain, int B,
                                        int order) {
  if (bad_args(nv, maxc, n_env, n_chain, B)) return 1;
  std::vector<float> sh(factor_floats(n_env, n_chain));
  for (size_t w = 0; w < static_cast<size_t>(B); ++w) {
    factor_world(H + w * nv * nv, L + w * nv * maxc, d + w * nv, Tables{tables}, nv, maxc,
                 sh.data(), sh.data() + n_env, Warp{order != 0});
  }
  return 0;
}

extern "C" int tree_ldl_solve_host_f32(const float* L, const float* d, const float* b,
                                       float* x, const int* tables, int nv, int maxc,
                                       int n_env, int n_chain, int B, int order) {
  if (bad_args(nv, maxc, n_env, n_chain, B)) return 1;
  std::vector<float> sh(solve_floats(nv, n_chain));
  for (size_t w = 0; w < static_cast<size_t>(B); ++w) {
    solve_world(L + w * nv * maxc, d + w * nv, b + w * nv, x + w * nv, Tables{tables}, nv,
                maxc, sh.data(), sh.data() + nv, Warp{order != 0});
  }
  return 0;
}

#endif
