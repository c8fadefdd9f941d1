// Mega-step kernel K2: whole physics steps of one world per CUDA thread
// block, for NVIDIA Hopper (sm_90a).
//
// Replaces (TPU kernel of the JAX package): flygym_tpu/ops/megastep.py
// make_megastep.<kernel> (body emit_step), launched by pallas_call in
// _megastep_impl. Its plain PyTorch version, used for CPU tensors and as the
// oracle on the card, is flygym_tpu_torch/ops/megastep.py emit_step.
//
// One step per world: FK over the tree (a forest where several flies share
// the world), motion subspace, velocities and bias accelerations, spatial
// inertias, CRBA and RNEA, the forces of every actuator kind (motor,
// position, velocity, intvelocity, damper, cylinder, MuJoCo's muscle;
// adhesion's force is applied by the solver) with their limits, every
// contact candidate (no top-K): ground rows against the flat plane or, on a
// heightfield world, their sampled local planes, and fly-fly pair rows
// capsule against capsule with two-body (+1/-1) Jacobian rows, compressed
// or not (a compressed row's geom2 is its group's winner, sampled outside
// the kernel and read by index); pyramid rows
// with impedance and the adhesion split, primal Newton on the tree-LDL^T
// Hessian (cross-tree fill-in of pair rows dropped, as the emitter drops
// it) with the bisection + regula-falsi line search: the Hessian factored
// once per step, or with SOLVER_EXACT (MuJoCo's exact Newton) re-filled from
// the current active set and re-factored at every iteration after the
// first; semi-implicit Euler, the activation states (intvelocity's integral,
// cylinder's filter, muscle activation) and, on the last of the K fused
// steps only, the outputs (state, FK, actuator forces, contact sensors). The
// K-1 inner steps write their qpos rows only. A world without contact
// candidates (a tethered fly; NCAND 0) compiles without the contact section
// (if constexpr): qacc is the tree solve of Mh against the forces. The
// header pads a table that would be empty (no candidates, free joints,
// sensors or sites) with one unread entry, so no array has length 0.
//
// Design. One world per thread block of THREADS threads (32, 64 or 128,
// from the generated header megastep_model.h; 128 ships), one block per
// world. The world's arrays (FK, S, inertias, the tree-sparse entries of Mh
// and of the Hessian, the contact rows) live in the block's dynamic shared
// memory, ordered by how often a step reads them; a header whose arrays
// pass the 227 KB a block may hold keeps its coldest rows in a world-major
// global buffer that the wrapper allocates (ops/megastep.py:scratch_layout).
// The body arrays of the dynamics and the Newton loop's rows share rows:
// the first are dead once the candidates are built, the second live only
// after. The loops of the step are spread over the block: one thread per
// body of a tree level, per DoF, per Hessian entry, per candidate, per
// actuator or per sensor, with barriers between phases. Every value is
// computed by the same operations in the same order as the serial loop
// computed it; only the thread changes. A sum whose terms come from
// several candidates or columns has one owner thread that adds them in the
// serial order, walking a transposed table of the header (the candidates
// of each DoF, the mh_mul terms of each output, the factor's updates of
// each entry, each body's children): no atomics and no shuffle or tree
// reductions, which would change the bits. Where the serial chain is long
// (the line search's 4 NCAND terms; the factor's and the forward solve's
// terms of one depth group of the tree), the terms are computed in
// parallel into the shared rows S_TERM first and the owner only adds them.
// The factor and both passes of the solve run by depth group of the DoF
// tree, one barrier each, instead of column by column.
//
// What bounds it on the H100: the dependent chains of each world's step
// (the ordered sums, the tree's levels and depth groups, 17 each for a fly)
// at the latency of shared memory and of the tables' reads, which miss the
// L1 left beside 4 blocks of 53 KB: 4 blocks of 4 warps per SM for the
// one-fly headers, 1-2 for the multi-fly ones. The operation bound is 0.13
// ms per K = 8 launch at 4096 worlds; PERF.md has the times and the
// profile build's phase shares.
//
// Numerics. Built with -fmad=false and IEEE div and sqrt, and the header's
// constants are the float32 values the emitter's Python arithmetic gives, so
// the arithmetic is the emitter's, term for term and in the same order. The
// emitter folds multiplies by the model's structural 0 and 1 at trace time;
// this code multiplies densely, and x*0 = 0, x*1 = x, x + 0 = x are exact.
// sin and cos are glibc's algorithm (ms_sincosf), as the JAX package's CPU
// backend and the plain version round them, so the kernel repeats both.
//
// The same file compiles as host C++ (g++ -x c++), where a block becomes a
// loop over worlds and each parallel loop a serial one, run in order or
// reversed (megastep_host_f32's `order`): a loop whose result depends on
// the order of its indices is a race on the card, and shows on the CPU as
// a gap to the plain version.
//
// Interface: plain C, bound with ctypes (flygym_tpu_torch/ops/_build.py).
// Pointers are device pointers; the kernel allocates nothing, launches on the
// caller's stream, does not synchronise, and returns the first CUDA error
// (the shared-memory attribute's, set at the first launch, or the
// launch's). The profile build (-DMS_PROFILE) times the step's phases with
// clock64() into one more buffer (megastep_profile_f32).

// The model's tables live in global memory, read through the L1: the
// threads of a warp read different entries.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MS_FN __device__ __forceinline__
#define MS_TABLE __device__ const
#define MS_NOUNROLL _Pragma("unroll 1")
#define MS_UNROLL4 _Pragma("unroll 4")
#define MS_SYNC() __syncthreads()
#else
#include <cmath>
#define MS_FN inline
#define MS_TABLE static const
#define MS_NOUNROLL
#define MS_UNROLL4
#define MS_SYNC() \
  do {            \
  } while (0)
#endif

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "megastep_model.h"

// Heightfield worlds (slice d; the header defines MS_HFIELD): the local
// ground plane [h, nx, ny, nz] of each candidate follows the state rows of
// the input (N_AUX = 4 NCAND rows, sampled outside the kernel and read for
// all K steps), and each candidate's contact frame (n, t1, t2) is kept in
// the scratch rows S_FRAME. Flat worlds contact along the world's axes.
#ifdef MS_HFIELD
constexpr bool kHasHfield = true;
#else
constexpr bool kHasHfield = false;
#ifndef MS_PAIRS_COMPRESSED
constexpr int N_AUX = 0;
#endif
#endif

// Fly-fly pair rows (slice e; the header defines MS_PAIRS): candidates
// [NGROUND, NCAND) are capsule against capsule. A pair row's DoF path is the
// first body's DoFs with sign +1, then from kPairSplit on the second body's
// with sign -1 (kPathDof past the bodies' paths, found by kCandSlot), and
// the row keeps its contact frame in S_FRAME.
#ifndef MS_PAIRS
constexpr int NGROUND = NCAND;
#endif
#if !defined(MS_HFIELD) && !defined(MS_PAIRS)
constexpr int S_FRAME = 0;
#endif

// Compressed pair rows (slice e compressed; the header also defines
// MS_PAIRS_COMPRESSED): pair row NGROUND + g stands for group g, whose
// members (kGroupBase[g] .. kGroupBase[g + 1] of the kMem* tables) are the
// capsules of one opposing fly that face geom1. The group's winner, a
// member index sampled outside the kernel from the cached pose (once per
// launch, as the planes are), is input row NQ + NV + K NU + NA + NV + g
// (N_AUX = NPAIR rows); run_world keeps it as a flat member index in
// S_WIN. The row is the uncompressed pair row
// with the winner's geom2: its frame, r2, h2 and inverse weight read by
// index, which gives the bits of the plain version's one-hot blend (one
// term times 1, the rest exact zeros). Its DoF path is geom1's body path
// (+1), then the winner's (-1): the plain version walks the members' whole
// DoF union in DoF order, where the other members' DoFs add exact zeros,
// and megastep_supported checks that the winner's DoFs come in its body
// path's order.
namespace {

constexpr int kThreads = THREADS;
static_assert(kThreads == 32 || kThreads == 64 || kThreads == 128, "THREADS: 32, 64 or 128");
constexpr bool kSolverExact = SOLVER_EXACT != 0;
// Actuator kinds (flygym_tpu_torch/engine/model.py ActKind).
constexpr int kMotor = 0, kPosition = 1, kVelocity = 2, kIntVelocity = 3, kDamper = 4,
              kAdhesion = 5, kCylinder = 6, kMuscle = 7;

// The indices of a loop spread over the block: on the card thread t takes
// t, t + THREADS, ...; on the host every index, in order or reversed.
struct ParIt {
  int i, step;
  MS_FN int operator*() const { return i; }
  MS_FN ParIt& operator++() {
    i += step;
    return *this;
  }
  MS_FN bool operator!=(const ParIt& e) const { return step > 0 ? i < e.i : i > e.i; }
};
struct Par {
  int b, e, step;
  MS_FN ParIt begin() const { return {b, step}; }
  MS_FN ParIt end() const { return {e, step}; }
};
#ifdef __CUDACC__
MS_FN Par par(int n) { return {static_cast<int>(threadIdx.x), n, kThreads}; }
// Whether this thread runs the block's serial sections.
MS_FN bool lead() { return threadIdx.x == 0; }
#else
bool g_reversed = false;
MS_FN Par par(int n) { return g_reversed ? Par{n - 1, -1, -1} : Par{0, n, 1}; }
MS_FN bool lead() { return true; }
#endif

// One world's scratch rows: [0, N_SHARED) in the block's shared memory,
// the rest in its world-major global row.
struct Rows {
  float* sh;
  float* gl;
  MS_FN float& operator[](int r) const {
    return (N_GLOBAL == 0 || r < N_SHARED) ? sh[r] : gl[r - N_SHARED];
  }
};
// One world's column of a world-minor (rows, B) input or output buffer.
struct Col {
  float* p;
  size_t stride;
  MS_FN float& operator[](int r) const { return p[static_cast<size_t>(r) * stride]; }
};

// The profile build's per-phase clock counters (the block's first thread's,
// read just after a barrier), in the order of ops/megastep.py
// PROFILE_PHASES.
enum Phase {
  kPhDynamics, kPhForces, kPhCandidates, kPhFirstPass, kPhRefill, kPhSolve, kPhMhMul,
  kPhJd, kPhLineSearch, kPhUpdate, kPhOutputs, kPhEuler, kNumPhases
};
#if defined(MS_PROFILE) && defined(__CUDACC__)
MS_FN long long ms_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct Prof {
  long long acc[kNumPhases];
  long long t;
  MS_FN Prof() : t(ms_clock()) {
    for (int i = 0; i < kNumPhases; ++i) acc[i] = 0;
  }
  MS_FN void mark(int p) {
    const long long now = ms_clock();
    acc[p] += now - t;
    t = now;
  }
};
#else
struct Prof {
  MS_FN void mark(int) {}
};
#endif

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};
struct V6 {  // (angular, linear) motion or (moment, force) force vector
  V3 w, v;
};

MS_FN V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
MS_FN V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
MS_FN V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
MS_FN V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
MS_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
MS_FN Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
// Rotate c by q (the emitter's _qrot_c, densely).
MS_FN V3 qrot(Q4 q, V3 c) {
  const V3 qv = {q.x, q.y, q.z};
  const V3 t = scale(cross(qv, c), 2.0f);
  const V3 u = cross(qv, t);
  return {q.w * t.x + u.x + c.x, q.w * t.y + u.y + c.y, q.w * t.z + u.z + c.z};
}
MS_FN V6 add6(V6 a, V6 b) { return {add(a.w, b.w), add(a.v, b.v)}; }
MS_FN V6 scale6(V6 a, float s) { return {scale(a.w, s), scale(a.v, s)}; }
MS_FN V6 cross6(V6 m, V6 o) { return {cross(m.w, o.w), add(cross(m.w, o.v), cross(m.v, o.w))}; }
MS_FN float dot6(V6 a, V6 b) { return dot(a.w, b.w) + dot(a.v, b.v); }
MS_FN float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
// powf(x, y) for x >= 0 and y > 0 as glibc computes it
// (sysdeps/ieee754/flt-32/e_powf.c), which is how the JAX package's CPU
// backend rounds pow: log2(x) from a 16-entry table and a float64
// polynomial, times y, exp2 from a 32-entry table and a float64
// polynomial, rounded to float32. XLA's CPU backend reads subnormal floats
// as zero: glibc normalises a subnormal x as the bits of x * 2^23 less 23
// exponents, which reads as 2^-150 there, so x^y is 2^(-150 y); a subnormal
// result is 0, and so is 0^y. It is not correctly rounded, and x*x*x
// differs from it in a quarter of arguments. The plain version
// (engine/maths.py powf) is the same algorithm.
MS_TABLE double kPowInvC[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010b0p+0, 0x1.3c995b0b80385p+0,
    0x1.30d190c8864a5p+0, 0x1.25e227b0b8ea0p+0, 0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0,
    0x1.0953f419900a7p+0, 0x1.0000000000000p+0, 0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aa0p-1,
    0x1.b2036576afce6p-1, 0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1, 0x1.767dcf5534862p-1};
MS_TABLE double kPowLogC[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2, -0x1.39de91a6dcf7bp-2,
    -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7af0p-3, -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4,
    -0x1.a6f9db6475fcep-5, 0x0.0p+0, 0x1.338ca9f24f53dp-4, 0x1.476a9543891bap-3,
    0x1.e840b4ac4e4d2p-3, 0x1.40645f0c6651cp-2, 0x1.88e9c2c1b9ff8p-2, 0x1.ce0a44eb17bccp-2};
MS_TABLE double kPowA[5] = {0x1.27616c9496e0bp-2, -0x1.71969a075c67ap-2, 0x1.ec70a6ca7baddp-2,
                             -0x1.7154748bef6c8p-1, 0x1.71547652ab82bp+0};
// 2^(i/32) as float64 bits, minus i << 47.
MS_TABLE uint64_t kExp2Tab[32] = {
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540};
MS_TABLE double kExp2C[3] = {0x1.c6af84b912394p-5, 0x1.ebfce50fac4f3p-3, 0x1.62e42ff0c52d6p-1};
constexpr double kExp2Shift = 0x1.8p52 / 32;

MS_FN float ms_powf(float x, float y) {
  uint32_t ix;
  memcpy(&ix, &x, sizeof ix);
  if (ix == 0) return 0.0f;
  if (ix < 0x00800000u) ix = 0u - (23u << 23);
  const uint32_t tmp = ix - 0x3f330000u;
  const int i = static_cast<int>((tmp >> 19) % 16);
  const uint32_t top = tmp & 0xff800000u;
  const uint32_t iz = ix - top;
  const int k = static_cast<int32_t>(top) >> 23;
  float zf;
  memcpy(&zf, &iz, sizeof zf);
  const double z = zf;
  const double r = z * kPowInvC[i] - 1.0;
  const double y0 = kPowLogC[i] + static_cast<double>(k);
  const double r2 = r * r;
  const double ya = kPowA[0] * r + kPowA[1];
  const double p = kPowA[2] * r + kPowA[3];
  const double r4 = r2 * r2;
  double q = kPowA[4] * r + y0;
  q = p * r2 + q;
  const double ylogx = static_cast<double>(y) * (ya * r4 + q);
  if (ylogx <= -150.0) return 0.0f;
  double kd = ylogx + kExp2Shift;
  uint64_t ki;
  memcpy(&ki, &kd, sizeof ki);
  kd -= kExp2Shift;
  const double rr = ylogx - kd;
  const uint64_t t = kExp2Tab[ki % 32] + (ki << 47);
  double s;
  memcpy(&s, &t, sizeof s);
  const double zc = kExp2C[0] * rr + kExp2C[1];
  const double yv = (zc * (rr * rr) + (kExp2C[2] * rr + 1.0)) * s;
  const float out = static_cast<float>(yv);
  return out < 0x1p-126f ? 0.0f : out;
}

// sinf and cosf as glibc computes them (sysdeps/ieee754/flt-32/s_sinf.c,
// s_cosf.c, sincosf.h), which is how the JAX package's CPU backend rounds
// them: reduce by pi/2 in float64, a float64 polynomial, round to float32.
// CUDA's sinf is another algorithm; its 1-ulp differences, amplified by the
// contact solve, flip line-search brackets within tens of steps. The plain version (ops/megastep.py _sincosf) is the same algorithm.
constexpr double kHpiInv = 0x1.45F306DC9C883p+23;  // 2/pi * 2^24
constexpr double kHpi = 0x1.921FB54442D18p0;       // pi/2
constexpr double kC0 = 1.0, kC1 = -0x1.ffffffd0c621cp-2, kC2 = 0x1.55553e1068f19p-5,
                 kC3 = -0x1.6c087e89a359dp-10, kC4 = 0x1.99343027bf8c3p-16;
constexpr double kS1 = -0x1.555545995a603p-3, kS2 = 0x1.1107605230bc4p-7,
                 kS3 = -0x1.994eb3774cf24p-13;
constexpr uint32_t kTopTiny = 0x39800000u >> 20, kTopPio4 = 0x3f490fdbu >> 20,
                   kTopBig = 0x42f00000u >> 20;  // 2^-12, pi/4, 120

MS_FN double sincos_poly(double x, double x2, bool odd) {
  if (!odd) {
    const double x3 = x * x2;
    const double s = x + x3 * kS1;
    return s + (x3 * x2) * (kS2 + x2 * kS3);
  }
  const double x4 = x2 * x2;
  const double c = (kC0 + x2 * kC1) + x4 * kC2;
  return c + (x4 * x2) * (kC3 + x2 * kC4);
}

MS_FN float ms_sincosf(float y, bool want_cos) {
  uint32_t bits;
  memcpy(&bits, &y, sizeof bits);
  const uint32_t top = (bits >> 20) & 0x7ffu;
  const double x = y;
  if (top < kTopTiny) return want_cos ? 1.0f : y;
  if (top < kTopPio4) return static_cast<float>(sincos_poly(x, x * x, want_cos));
  if (top >= kTopBig) return static_cast<float>(want_cos ? cos(x) : sin(x));
  const int n = (static_cast<int32_t>(x * kHpiInv) + 0x800000) >> 24;
  const double xr = x - n * kHpi;
  const double sign = ((n & 3) == 1 || (n & 3) == 2) ? -1.0 : 1.0;
  const bool odd = ((n ^ static_cast<int>(want_cos)) & 1) != 0;
  const double v = sincos_poly(xr * sign, xr * xr, odd);
  return static_cast<float>(((n & 2) && odd) ? -v : v);
}
MS_FN float ms_sinf(float y) { return ms_sincosf(y, false); }
MS_FN float ms_cosf(float y) { return ms_sincosf(y, true); }

MS_FN V3 ld3(const Rows& s, int r) { return {s[r], s[r + 1], s[r + 2]}; }
MS_FN void st3(const Rows& s, int r, V3 a) {
  s[r] = a.x;
  s[r + 1] = a.y;
  s[r + 2] = a.z;
}
MS_FN Q4 ld4(const Rows& s, int r) { return {s[r], s[r + 1], s[r + 2], s[r + 3]}; }
MS_FN void st4(const Rows& s, int r, Q4 a) {
  s[r] = a.w;
  s[r + 1] = a.x;
  s[r + 2] = a.y;
  s[r + 3] = a.z;
}
MS_FN V6 ld6(const Rows& s, int r) { return {ld3(s, r), ld3(s, r + 3)}; }
MS_FN void st6(const Rows& s, int r, V6 a) {
  st3(s, r, a.w);
  st3(s, r + 3, a.v);
}

#define TV3(tab, i) (V3{tab[3 * (i)], tab[3 * (i) + 1], tab[3 * (i) + 2]})
#define TQ4(tab, i) (Q4{tab[4 * (i)], tab[4 * (i) + 1], tab[4 * (i) + 2], tab[4 * (i) + 3]})

// Spatial inertia about ref in world axes, stored as 9 rows: TL (00, 01, 02,
// 11, 12, 22) and the top-right block m c× by its entries 01, 02, 12
// (TR10 = -TR01, TR20 = -TR02, TR21 = -TR12, zero diagonal).
MS_FN V6 inertia_mul(const Rows& s, int r, float m, V6 x) {
  const float tl[3][3] = {{s[r], s[r + 1], s[r + 2]},
                          {s[r + 1], s[r + 3], s[r + 4]},
                          {s[r + 2], s[r + 4], s[r + 5]}};
  const float a = s[r + 6], b = s[r + 7], c = s[r + 8];
  const float tr[3][3] = {{0.0f, a, b}, {-a, 0.0f, c}, {-b, -c, 0.0f}};
  const float w[3] = {x.w.x, x.w.y, x.w.z}, v[3] = {x.v.x, x.v.y, x.v.z};
  float n[3], f[3];
  for (int i = 0; i < 3; ++i) {
    n[i] = tl[i][0] * w[0] + tl[i][1] * w[1] + tl[i][2] * w[2] + tr[i][0] * v[0] +
           tr[i][1] * v[1] + tr[i][2] * v[2];
    f[i] = tr[0][i] * w[0] + tr[1][i] * w[1] + tr[2][i] * w[2] + m * v[i];
  }
  return {{n[0], n[1], n[2]}, {f[0], f[1], f[2]}};
}

// The contact's pyramid rows (slice g.3; the header's NROWS and NTAG): the
// normal row alone at condim 1 (NTAG 0), else two rows n + mu_t J_t,
// n - mu_t J_t per friction direction t of the NTAG tags: the tangents t1
// and t2 (condim 3), the torsion about n (condim 4, the rotational Jacobian)
// and the rolling about t1 and t2 (condim 6). NDIR = 1 + NTAG Jacobian
// directions per path entry; mu_t per candidate and tag in kMuDir, mu_t^2
// in kMuDir2, as the emitter's Python arithmetic rounds them.
constexpr int NDIR = 1 + NTAG;
// Candidate c's weights (coef): the gradient's (n, then one per tag), then
// the Hessian's W, Bt (one per tag) and Wt (one per tag).
constexpr int NCOEF = 2 + 3 * NTAG;
constexpr int O_W = 1 + NTAG, O_BT = 2 + NTAG, O_WT = 2 + 2 * NTAG;

// Candidate c's rows: S_JAR, S_JD (NROWS each: the pyramid rows), S_CD (the
// constraint's D), S_CACT (active), S_CADH (adhesion force), S_CPOS (3),
// S_COEF (NCOEF: the gradient's and the Hessian's weights of its rows, see
// coef), S_COMP (its path's Jacobian components along the NDIR directions).
MS_FN int comp_row(int c, int i, int t) { return S_COMP + NDIR * (MAXP * c + i) + t; }
// Whether candidate c has a contact frame of its own (terrain or pair row;
// flat ground rows contact along the world's axes), and its 9 rows.
MS_FN bool has_frame(int c) { return kHasHfield || c >= NGROUND; }
MS_FN int frame_row(int c) { return S_FRAME + 9 * (kHasHfield ? c : c - NGROUND); }

#ifdef MS_PAIRS_COMPRESSED
// Compressed pair row c's winner, as an index into the kMem* tables.
MS_FN int winner(const Rows& s, int c) { return static_cast<int>(s[S_WIN + (c - NGROUND)]); }
#endif

// Candidate c's path: n DoFs, split at `split` into the two bodies' parts
// (ground rows have one); entry i < split is kPathDof[p1 + i], entry i >=
// split kPathDof[p2 + i - split] (p2 = p1 + split but on compressed rows).
// Entry i has sign +1 in the first part and -1 in the second. Each part
// runs down one chain of its tree, so DoF d lies at entry (the part's
// start) + its number of ancestors, and the Hessian keeps (path[i],
// path[j]), i <= j, where both lie in one part.
struct CPath {
  int p1, split, p2, n;
};
MS_FN CPath cand_path(const Rows& s, int c) {
#if defined(MS_PAIRS_COMPRESSED)
  const int b1 = kCandBody[c], p1 = kPathPtr[b1], n1 = kPathPtr[b1 + 1] - p1;
  if (c < NGROUND) return {p1, n1, p1 + n1, n1};
  const int b2 = kMemBody2[winner(s, c)], p2 = kPathPtr[b2];
  return {p1, n1, p2, n1 + kPathPtr[b2 + 1] - p2};
#elif defined(MS_PAIRS)
  (void)s;
  const int slot = kCandSlot[c], p = kPathPtr[slot], n = kPathPtr[slot + 1] - p;
  return {p, c < NGROUND ? n : kPairSplit[c - NGROUND], p, n};
#else
  (void)s;
  const int b = kCandBody[c], p = kPathPtr[b], n = kPathPtr[b + 1] - p;
  return {p, n, p, n};
#endif
}
MS_FN int path_dof(const CPath& cp, int i) {
#ifdef MS_PAIRS_COMPRESSED
  return kPathDof[i < cp.split ? cp.p1 + i : cp.p2 + (i - cp.split)];
#else
  return kPathDof[cp.p1 + i];
#endif
}

// Where DoF d lies in the path of candidate c of its list (kDc*), whose
// part starts at off: off plus dep, d's number of ancestors; -1 where d is
// not on the path (off -1: the second part of a compressed row, whose
// winner's body path may lack d).
MS_FN int dc_pos(const Rows& s, int c, int off, int d, int dep) {
#ifdef MS_PAIRS_COMPRESSED
  if (off < 0) {
    const int b2 = kMemBody2[winner(s, c)], p2 = kPathPtr[b2];
    if (dep >= kPathPtr[b2 + 1] - p2 || kPathDof[p2 + dep] != d) return -1;
    const int b1 = kCandBody[c];
    return kPathPtr[b1 + 1] - kPathPtr[b1] + dep;
  }
#else
  (void)s;
  (void)c;
  (void)d;
#endif
  return off + dep;
}
// The halves of a packed walk entry (model_header's _pack16).
MS_FN int lo16(int v) { return v & 0xffff; }
MS_FN int hi16(int v) { return v >> 16; }

// Direction products J_t · x along candidate c's path, t = n and the tags.
MS_FN void products(const Rows& s, int c, int x_row, float p[NDIR]) {
  const CPath cp = cand_path(s, c);
  const float x0 = s[x_row + path_dof(cp, 0)];
  for (int t = 0; t < NDIR; ++t) p[t] = s[comp_row(c, 0, t)] * x0;
  MS_UNROLL4
  for (int i = 1; i < cp.n; ++i) {
    const float xd = s[x_row + path_dof(cp, i)];
    for (int t = 0; t < NDIR; ++t) p[t] = p[t] + s[comp_row(c, i, t)] * xd;
  }
}

// Pyramid rows [n] (condim 1), else [n + mu_t J_t, n - mu_t J_t] per tag.
MS_FN void row_combos(int c, const float p[NDIR], float out[NROWS]) {
  if constexpr (NTAG == 0) {
    (void)c;
    out[0] = p[0];
  } else {
    for (int t = 0; t < NTAG; ++t) {
      const float mu = kMuDir[NTAG * c + t];
      out[2 * t] = p[0] + mu * p[1 + t];
      out[2 * t + 1] = p[0] - mu * p[1 + t];
    }
  }
}

// Candidate c's weights in the gradient J^T (D m jar) (n, then per tag)
// and in the Hessian fill J^T Σ J (W, Bt per tag, Wt per tag), from its
// rows. At condim 1 the normal row's weights alone, without the 0 + of the
// sums.
MS_FN void coef(const Rows& s, int c) {
  const float D = s[S_CD + c];
  float wk[NROWS], wa[NROWS];
  for (int r = 0; r < NROWS; ++r) {
    const float jar = s[S_JAR + NROWS * c + r];
    const float m = jar < 0.0f ? 1.0f : 0.0f;
    wk[r] = D * m * jar;
    wa[r] = D * m;
  }
  const int o = S_COEF + NCOEF * c;
  if constexpr (NTAG == 0) {
    s[o] = wk[0];
    s[o + O_W] = wa[0];
  } else {
    float cn = 0.0f, W = 0.0f;
    for (int r = 0; r < NROWS; ++r) cn = cn + wk[r];
    for (int r = 0; r < NROWS; ++r) W = W + wa[r];
    s[o] = cn;
    s[o + O_W] = W;
    for (int t = 0; t < NTAG; ++t) {
      const float mu = kMuDir[NTAG * c + t], mu2 = kMuDir2[NTAG * c + t];
      s[o + 1 + t] = mu * (wk[2 * t] - wk[2 * t + 1]);
      s[o + O_BT + t] = mu * (wa[2 * t] - wa[2 * t + 1]);
      s[o + O_WT + t] = mu2 * (wa[2 * t] + wa[2 * t + 1]);
    }
  }
}

// The contact gradient S_GC = J^T (D m jar), and with `first` the adhesion
// forces taken from S_QFRC, one thread per DoF adding its candidates' terms
// in candidate order.
MS_FN void dof_sums(const Rows& s, bool first) {
  for (int d : par(NV)) {
    const int dep = kPkPtr[d + 1] - 1 - kPkPtr[d];
    float qf = first ? s[S_QFRC + d] : 0.0f, g = 0.0f;
    MS_UNROLL4
    for (int e = kDcPtr[d]; e < kDcPtr[d + 1]; ++e) {
      const int c = lo16(kDcCO[e]), j = dc_pos(s, c, hi16(kDcCO[e]) - 1, d, dep);
      if (j < 0) continue;
      const int o = S_COEF + NCOEF * c;
      const float n = s[comp_row(c, j, 0)];
      if (first) qf = qf - n * s[S_CADH + c];
      float gc = n * s[o];
      for (int t = 1; t < NDIR; ++t) gc = gc + s[comp_row(c, j, t)] * s[o + t];
      g = g + gc;
    }
    if (first) s[S_QFRC + d] = qf;
    s[S_GC + d] = g;
  }
}

// The Hessian S_H = Mh + J^T Σ J + 1e-9 I over the tree-sparse entries, one
// thread per entry (a, d) adding the terms of the candidates on d's path in
// candidate order (a, an ancestor-or-self of d, lies in the same part). The
// entries are dealt to the threads longest first (kHf: thread t takes
// positions t, t + THREADS, ...; -1 pads).
MS_FN void hess_fill(const Rows& s) {
  for (int p : par(NHF)) {
    const int k = kHf[p];
    if (k < 0) continue;
    const int d = kPkCol[k], dep = kPkPtr[d + 1] - 1 - kPkPtr[d], ia = k - kPkPtr[d];
    float h = s[S_MH + k];
    MS_UNROLL4
    for (int e = kDcPtr[d]; e < kDcPtr[d + 1]; ++e) {
      const int c = lo16(kDcCO[e]), j = dc_pos(s, c, hi16(kDcCO[e]) - 1, d, dep);
      if (j < 0) continue;
      const int i = j - dep + ia, o = S_COEF + NCOEF * c;
      // u_j = Σ g_j (n, then u per tag), then g_i^T u_j in the same order.
      const float nj = s[comp_row(c, j, 0)];
      float un = nj * s[o + O_W], u[NDIR];
      for (int t = 0; t < NTAG; ++t) {
        const float dj = s[comp_row(c, j, 1 + t)], bt = s[o + O_BT + t];
        un = un + dj * bt;
        u[1 + t] = nj * bt + dj * s[o + O_WT + t];
      }
      float val = s[comp_row(c, i, 0)] * un;
      for (int t = 1; t < NDIR; ++t) val = val + s[comp_row(c, i, t)] * u[t];
      h = h + val;
    }
    if (ia == dep) h = h + 1e-9f;
    s[S_H + k] = h;
  }
}

// out = Mh x over the tree-sparse entries: one thread per output DoF, its
// diagonal term first, then its terms (kMv*) in the serial loop's order.
MS_FN void mh_mul(const Rows& s, int x_row, int out_row) {
  for (int o : par(NV)) {
    float acc = s[S_MH + kPkPtr[o + 1] - 1] * s[x_row + o];
    MS_UNROLL4
    for (int e = kMvPtr[o]; e < kMvPtr[o + 1]; ++e)
      acc = acc + s[S_MH + lo16(kMvKX[e])] * s[x_row + hi16(kMvKX[e])];
    s[out_row + o] = acc;
  }
  MS_SYNC();
}

// Tree LDL^T of S_H in place: column i's ancestor entries become L, its
// diagonal entry d_i. The serial loop eliminated the DoFs leaves first,
// each column updating its ancestors' entries. Here each entry
// takes all its updates at once, in the same order (kLu*), from columns
// that are final: the DoFs' depth groups run deepest first, and in each
// the updates' terms are computed in parallel into S_TERM, then each entry
// of the group's columns subtracts its own in order; 1 / d_i is taken once,
// into S_INV, by the thread of the diagonal. Each entry of L is then its
// column's entry times 1 / d_i, as the serial loop scaled it.
MS_FN void tree_ldl(const Rows& s) {
  MS_NOUNROLL
  for (int gi = NDG - 1; gi >= 0; --gi) {
    const int p0 = kGePtr[gi], p1 = kGePtr[gi + 1], u0 = kLuPtr[p0], nu = kLuPtr[p1] - u0;
    if (nu > 0) {
      for (int u : par(nu)) {
        const int ba = kLuBA[u0 + u];
        s[S_TERM + u] = (s[S_H + lo16(ba)] * s[S_INV + kLuCol[u0 + u]]) * s[S_H + hi16(ba)];
      }
      MS_SYNC();
    }
    for (int j : par(p1 - p0)) {
      const int p = p0 + j, k = kGe[p];
      float acc = s[S_H + k];
      MS_UNROLL4
      for (int u = kLuPtr[p] - u0; u < kLuPtr[p + 1] - u0; ++u) acc = acc - s[S_TERM + u];
      s[S_H + k] = acc;
      const int d = kPkCol[k];
      if (k == kPkPtr[d + 1] - 1) s[S_INV + d] = 1.0f / acc;
    }
    MS_SYNC();
  }
  for (int k : par(NPK)) {
    const int d = kPkCol[k];
    if (k != kPkPtr[d + 1] - 1) s[S_H + k] = s[S_H + k] * s[S_INV + d];
  }
  MS_SYNC();
}

// Solve with the factor in S_H, in place on the rows at y_row. Forward:
// each DoF takes the terms of the DoFs below it in elimination order
// (kFw*), depth groups deepest first, each group's terms computed in
// parallel into S_TERM and subtracted in order by their DoF's thread; the
// diagonal; backward: each DoF its ancestors' terms (kBw*), depth groups
// shallowest first, in the same two steps.
MS_FN void tree_solve(const Rows& s, int y_row) {
  MS_NOUNROLL
  for (int gi = NDG - 1; gi >= 0; --gi) {
    const int p0 = kDgPtr[gi], p1 = kDgPtr[gi + 1], u0 = kFwPtr[p0], nu = kFwPtr[p1] - u0;
    if (nu == 0) continue;
    for (int u : par(nu)) {
      const int v = kFwKI[u0 + u];
      s[S_TERM + u] = s[S_H + lo16(v)] * s[y_row + hi16(v)];
    }
    MS_SYNC();
    for (int j : par(p1 - p0)) {
      const int p = p0 + j, a = kDgDof[p];
      float acc = s[y_row + a];
      MS_UNROLL4
      for (int u = kFwPtr[p] - u0; u < kFwPtr[p + 1] - u0; ++u) acc = acc - s[S_TERM + u];
      s[y_row + a] = acc;
    }
    MS_SYNC();
  }
  for (int i : par(NV)) s[y_row + i] = s[y_row + i] / s[S_H + kPkPtr[i + 1] - 1];
  MS_SYNC();
  MS_NOUNROLL
  for (int gi = 0; gi < NDG; ++gi) {
    const int p0 = kDgPtr[gi], p1 = kDgPtr[gi + 1], u0 = kBwPtr[p0], nu = kBwPtr[p1] - u0;
    if (nu == 0) continue;
    for (int u : par(nu)) {
      const int v = kBwKA[u0 + u];
      s[S_TERM + u] = s[S_H + lo16(v)] * s[y_row + hi16(v)];
    }
    MS_SYNC();
    for (int j : par(p1 - p0)) {
      const int p = p0 + j, i = kDgDof[p];
      float acc = s[y_row + i];
      MS_UNROLL4
      for (int u = kBwPtr[p] - u0; u < kBwPtr[p + 1] - u0; ++u) acc = acc - s[S_TERM + u];
      s[y_row + i] = acc;
    }
    MS_SYNC();
  }
}

// φ'(α) of the line search along delta: each candidate's NROWS terms into the
// rows of S_TERM, then their sum in the serial order by the lead thread,
// its result through S_RED to the block. Both rows are double: calls take them
// in turn, so that a call's writes never meet the previous call's reads.
MS_FN float dphi(const Rows& s, float gMd, float dMd, float alpha, bool at_zero, int& turn) {
  const int t0 = S_TERM + NROWS * NCAND * (turn & 1), r0 = S_RED + (turn & 1);
  ++turn;
  for (int c : par(NCAND)) {
    const float D = s[S_CD + c];
    for (int r = 0; r < NROWS; ++r) {
      const float jr = s[S_JAR + NROWS * c + r], jd = s[S_JD + NROWS * c + r];
      const float ja = at_zero ? jr : jr + alpha * jd;
      const float m = ja < 0.0f ? 1.0f : 0.0f;
      s[t0 + NROWS * c + r] = m * (D * jd) * ja;
    }
  }
  MS_SYNC();
  if (lead()) {
    // In runs of 16: the loads of a run issue together, the adds follow in
    // order.
    float d = at_zero ? gMd : gMd + alpha * dMd;
    constexpr int kRun = 16, kTerms = NROWS * NCAND, kFull = kTerms - kTerms % kRun;
    MS_NOUNROLL
    for (int e = 0; e < kFull; e += kRun) {
      float v[kRun];
      for (int j = 0; j < kRun; ++j) v[j] = s[t0 + e + j];
      for (int j = 0; j < kRun; ++j) d = d + v[j];
    }
    for (int e = kFull; e < kTerms; ++e) d = d + s[t0 + e];
    s[r0] = d;
  }
  MS_SYNC();
  return s[r0];
}

// MuJoCo's muscle force of actuator u at tendon length len, velocity vel and
// activation a (the emitter's _muscle_force_lane): the force-length curve
// times the force-velocity curve times a, plus the passive force. kMus
// holds the constants as the emitter's Python arithmetic folds them
// (ops/megastep.py _MUSCLE_KEYS): lr0, L0, range0, the velocity scale, lmin,
// a, b, lmax, the rise, plateau-low, plateau-high and fall widths, y, y's
// floor, fvmax, -peak, -peak fpmax / 2, -peak fpmax. Each chain of selects
// takes its one live branch; the branches have no side effects, so this
// gives the bits of the emitter's select of every branch.
MS_FN float muscle_force(int u, float len, float vel, float a) {
  const int m = NMUS * u;
  const float L = kMus[m + 2] + (len - kMus[m]) / kMus[m + 1];
  const float V = vel / kMus[m + 3];
  const float lmin = kMus[m + 4], la = kMus[m + 5], lb = kMus[m + 6], lmax = kMus[m + 7];
  float gl = 0.0f;
  if (L <= lmin) {
    gl = 0.0f;
  } else if (L <= la) {
    const float x = (L - lmin) / kMus[m + 8];
    gl = 0.5f * (x * x);
  } else if (L <= 1.0f) {
    const float x = (1.0f - L) / kMus[m + 9];
    gl = 1.0f - 0.5f * (x * x);
  } else if (L <= lb) {
    const float x = (L - 1.0f) / kMus[m + 10];
    gl = 1.0f - 0.5f * (x * x);
  } else if (L <= lmax) {
    const float x = (lmax - L) / kMus[m + 11];
    gl = 0.5f * (x * x);
  }
  const float y = kMus[m + 12], fvmax = kMus[m + 14];
  float gv;
  if (V <= -1.0f) {
    gv = 0.0f;
  } else if (V <= 0.0f) {
    const float x = V + 1.0f;
    gv = x * x;
  } else if (V <= y) {
    const float x = y - V;
    gv = fvmax - (x * x) / kMus[m + 13];
  } else {
    gv = fvmax;
  }
  const float gain = kMus[m + 15] * gl * gv;
  float bias = 0.0f;
  if (L <= 1.0f) {
    bias = 0.0f;
  } else if (L <= lb) {
    const float x = (L - 1.0f) / kMus[m + 10];
    bias = kMus[m + 16] * (x * x);
  } else {
    bias = kMus[m + 17] * (0.5f + (L - lb) / kMus[m + 10]);
  }
  return gain * a + bias;
}

// FK of body b from its parent's pose: a free joint's pose from qpos, else
// the hinges' rotations in slot order (their half-angle cosines and sines
// in S_HCS); the world hinge axes into S_HAX.
MS_FN void fk_body(const Rows& s, int b) {
  const int p = kParent[b];
  if (kFreeQ[b] >= 0) {
    const int qa = S_Q + kFreeQ[b];
    st3(s, S_XPOS + 3 * b, ld3(s, qa));
    st4(s, S_XQUAT + 4 * b, ld4(s, qa + 3));
    return;
  }
  const Q4 qp = ld4(s, S_XQUAT + 4 * p);
  Q4 cur = qmul(qp, TQ4(kBodyQuat, b));
  for (int hi = kBodyHingePtr[b]; hi < kBodyHingePtr[b + 1]; ++hi) {
    const int h = kBodyHinge[hi];
    const V3 ax = TV3(kHingeAxis, h);
    // The world hinge axis uses the rotation before the hinge.
    st3(s, S_HAX + 3 * h, qrot(cur, ax));
    const float ch = s[S_HCS + 2 * h], sh = s[S_HCS + 2 * h + 1];
    cur = qmul(cur, Q4{ch, sh * ax.x, sh * ax.y, sh * ax.z});
  }
  st4(s, S_XQUAT + 4 * b, cur);
  st3(s, S_XPOS + 3 * b, add(ld3(s, S_XPOS + 3 * p), qrot(qp, TV3(kBodyPos, b))));
}

// Body b's spatial velocity and bias acceleration from its parent's.
MS_FN void vel_body(const Rows& s, int b) {
  const int p = kParent[b];
  V6 vel = ld6(s, S_CVEL + 6 * p), acc = ld6(s, S_CACC + 6 * p);
  if (kFreeV[b] >= 0) {
    const int va = kFreeV[b];
    for (int i = 0; i < 6; ++i)
      vel = add6(vel, scale6(ld6(s, S_SM + 6 * (va + i)), s[S_V + va + i]));
    const V3 vlin = ld3(s, S_V + va), omg = ld3(s, S_V + va + 3);
    acc = add6(acc, V6{{0.0f, 0.0f, 0.0f}, cross(vlin, omg)});
  } else {
    for (int di = kBodyDofPtr[b]; di < kBodyDofPtr[b + 1]; ++di) {
      const int d = kBodyDof[di];
      const V6 sd = scale6(ld6(s, S_SM + 6 * d), s[S_V + d]);
      acc = add6(acc, cross6(vel, sd));
      vel = add6(vel, sd);
    }
  }
  st6(s, S_CVEL + 6 * b, vel);
  st6(s, S_CACC + 6 * b, acc);
}

// Body b's spatial inertia about ref (S_IB), and a copy that becomes its
// composite inertia (S_IC).
MS_FN void inertia_body(const Rows& s, int b, V3 ref) {
  const Q4 xq = ld4(s, S_XQUAT + 4 * b);
  const Q4 qi = qmul(xq, TQ4(kBodyIQuat, b));
  const float w = qi.w, x = qi.x, y = qi.y, z = qi.z;
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z), 2.0f * (x * z + w * y)},
      {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - w * x)},
      {2.0f * (x * z - w * y), 2.0f * (y * z + w * x), 1.0f - 2.0f * (x * x + y * y)}};
  const float I1 = kBodyInertia[3 * b], I2 = kBodyInertia[3 * b + 1],
              I3 = kBodyInertia[3 * b + 2];
  float ib[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j)
      ib[i][j] = R[i][0] * R[j][0] * I1 + R[i][1] * R[j][1] * I2 + R[i][2] * R[j][2] * I3;
  const float m = kBodyMass[b];
  const V3 com = add(ld3(s, S_XPOS + 3 * b), qrot(xq, TV3(kBodyIPos, b)));
  const V3 c = sub(com, ref);
  const float c2 = c.x * c.x + c.y * c.y + c.z * c.z;
  const float v[9] = {ib[0][0] + m * (c2 - c.x * c.x), ib[0][1] - m * c.x * c.y,
                      ib[0][2] - m * c.x * c.z,         ib[1][1] + m * (c2 - c.y * c.y),
                      ib[1][2] - m * c.y * c.z,         ib[2][2] + m * (c2 - c.z * c.z),
                      -m * c.z,                         m * c.y,
                      -m * c.x};
  for (int e = 0; e < 9; ++e) {
    s[S_IB + 9 * b + e] = v[e];
    s[S_IC + 9 * b + e] = v[e];
  }
}

// Rows [row + n b, row + n b + n) of body b plus those of its children, in
// reverse topological order (composite inertias, subtree forces).
MS_FN void add_children(const Rows& s, int row, int n, int b) {
  for (int e = 0; e < n; ++e) {
    float acc = s[row + n * b + e];
    for (int ci = kChildPtr[b]; ci < kChildPtr[b + 1]; ++ci)
      acc = acc + s[row + n * kChild[ci] + e];
    s[row + n * b + e] = acc;
  }
}

// Actuator u's force (S_AF) from its clamped control (S_CCL) at step k.
MS_FN void actuator(const Col& in, const Rows& s, int u, int k) {
  float c = in[NQ + NV + k * NU + u];
  if (kCtrlLim[u]) c = clampf(c, kCtrlRange[2 * u], kCtrlRange[2 * u + 1]);
  s[S_CCL + u] = c;
  const int kind = kActKind[u];
  const float gain = kActGain[u];
  if (kind == kAdhesion) {  // the commanded force, applied by the solver
    s[S_AF + u] = gain * c;
    return;
  }
  const int h = kActHinge[u], adr = kActAdr[u];
  const float qh = h >= 0 ? s[S_Q + kHingeQ[h]] : 0.0f;
  const float vh = h >= 0 ? s[S_V + kHingeV[h]] : 0.0f;
  const float a = adr >= 0 ? s[S_ACT + adr] : 0.0f;
  float force = 0.0f;
  switch (kind) {
    case kMotor: force = gain * c; break;
    case kPosition: force = gain * (c - qh) - kActKv[u] * vh; break;
    case kVelocity: force = gain * (c - vh); break;
    case kIntVelocity: force = gain * (a - qh) - kActKv[u] * vh; break;
    case kDamper: force = -gain * c * vh; break;
    case kCylinder: force = gain * a; break;
    case kMuscle: force = muscle_force(u, qh, vh, a); break;
    default: break;
  }
  if (kForceLim[u]) force = clampf(force, kForceRange[2 * u], kForceRange[2 * u + 1]);
  s[S_AF + u] = force;
}

// Contact candidate c: ground row against the flat plane or its terrain
// plane, or pair row capsule against capsule; its frame, impedance, D,
// Jacobian components along its path, reference acceleration and rows
// jar = J a - aref from the warm start, and its weights (coef).
MS_FN void candidate(const Col& in, const Rows& s, int c, int K, V3 ref) {
  const int b = kCandBody[c];
  const V3 xp = ld3(s, S_XPOS + 3 * b);
  const Q4 xq = ld4(s, S_XQUAT + 4 * b);
  const V3 gpos = add(xp, qrot(xq, TV3(kCandGPos, c)));
  const V3 zax = qrot(qmul(xq, TQ4(kCandGQuat, c)), V3{0.0f, 0.0f, 1.0f});
  const float rad = kCandRad[c];
  float dist = 0.0f;
  V3 cpos{}, fn{};
  if (c >= NGROUND) {
#ifdef MS_PAIRS
    // Closest points of the two capsule axes (the emitter's _cand_geom
    // pair branch, the branchless Ericson clamp), the normal from geom2
    // toward geom1, +z where the axes meet. geom2 is the winner's on a
    // compressed row.
#ifdef MS_PAIRS_COMPRESSED
    const int pi = c - NGROUND, m = winner(s, c), b2 = kMemBody2[m];
    const Q4 xq2 = ld4(s, S_XQUAT + 4 * b2);
    const V3 gpos2 = add(ld3(s, S_XPOS + 3 * b2), qrot(xq2, TV3(kMemGPos2, m)));
    const V3 zax2 = qrot(qmul(xq2, TQ4(kMemGQuat2, m)), V3{0.0f, 0.0f, 1.0f});
    const float h1 = kPairH1[pi], h2 = kMemH2[m], r2 = kMemR2[m];
#else
    const int pi = c - NGROUND, b2 = kPairBody2[pi];
    const Q4 xq2 = ld4(s, S_XQUAT + 4 * b2);
    const V3 gpos2 = add(ld3(s, S_XPOS + 3 * b2), qrot(xq2, TV3(kPairGPos2, pi)));
    const V3 zax2 = qrot(qmul(xq2, TQ4(kPairGQuat2, pi)), V3{0.0f, 0.0f, 1.0f});
    const float h1 = kPairH1[pi], h2 = kPairH2[pi], r2 = kPairR2[pi];
#endif
    const V3 a0 = sub(gpos, scale(zax, h1)), d1 = scale(zax, 2.0f * h1);
    const V3 b0 = sub(gpos2, scale(zax2, h2)), d2 = scale(zax2, 2.0f * h2);
    const V3 r = sub(a0, b0);
    const float aq = dot(d1, d1), eq = dot(d2, d2), fq = dot(d2, r), cq = dot(d1, r),
                bq = dot(d1, d2);
    const float denom = aq * eq - bq * bq;
    float sp = denom > 1e-12f ? clampf((bq * fq - cq * eq) / fmaxf(denom, 1e-12f), 0.0f, 1.0f)
                              : 0.0f;
    float tp = eq > 1e-12f ? (bq * sp + fq) / fmaxf(eq, 1e-12f) : 0.0f;
    tp = clampf(tp, 0.0f, 1.0f);
    sp = aq > 1e-12f ? clampf((bq * tp - cq) / fmaxf(aq, 1e-12f), 0.0f, 1.0f) : 0.0f;
    const V3 c1 = add(a0, scale(d1, sp)), c2 = add(b0, scale(d2, tp));
    const V3 dv = sub(c1, c2);
    const float dn = sqrtf(fmaxf(dot(dv, dv), 1e-18f));
    const bool ok = dn > 1e-9f;
    fn = V3{ok ? dv.x / dn : 0.0f, ok ? dv.y / dn : 0.0f, ok ? dv.z / dn : 1.0f};
    dist = dn - rad - r2;
    cpos = sub(c1, scale(fn, rad + 0.5f * dist));
#endif
  } else if (kHasHfield) {
    // Distance along the plane's normal.
    const V3 ep = add(gpos, scale(zax, kCandEndH[c]));
    const int pr = NQ + NV + K * NU + NA + NV + 4 * c;
    const float h = in[pr];
    fn = V3{in[pr + 1], in[pr + 2], in[pr + 3]};
    dist = (ep.z - h) * fn.z - rad;
    cpos = sub(ep, scale(fn, rad + 0.5f * dist));
  } else {
    const V3 ep = add(gpos, scale(zax, kCandEndH[c]));
    dist = ep.z - kGroundZ - rad;
    cpos = V3{ep.x, ep.y, ep.z - (rad + 0.5f * dist)};
  }
  const bool framed = has_frame(c);
  V3 f1{}, f2{};
  if (framed) {
    // The frame as the emitter's _contact_frames builds it: t1 from the
    // x axis (the y axis for a steep normal) made orthogonal to n,
    // t2 = n x t1.
    const bool use_ey = fabsf(fn.x) > 0.9f;
    const V3 seed = {use_ey ? 0.0f : 1.0f, use_ey ? 1.0f : 0.0f, 0.0f};
    f1 = sub(seed, scale(fn, dot(seed, fn)));
    f1 = scale(f1, 1.0f / fmaxf(sqrtf(dot(f1, f1)), 1e-12f));
    f2 = cross(fn, f1);
    st3(s, frame_row(c), fn);
    st3(s, frame_row(c) + 3, f1);
    st3(s, frame_row(c) + 6, f2);
  }
  const bool active = dist < kCandMargin[c];
  const float pos_err = fminf(dist - kCandMargin[c], 0.0f);
  const float x = clampf(fabsf(pos_err) / kSolWidth[c], 0.0f, 1.0f);
  const float y = x < kSolMid[c] ? kSolA[c] * ms_powf(x, kSolPow[c])
                                 : 1.0f - kSolB[c] * ms_powf(1.0f - x, kSolPow[c]);
  const float imp = clampf(kSolDmin[c] + y * kSolDmm[c], 1e-4f, 0.9999f);
#ifdef MS_PAIRS_COMPRESSED
  const float invw = c < NGROUND ? kInvW[c] : kMemInvW[winner(s, c)];
#else
  const float invw = kInvW[c];
#endif
  const float R = (1.0f - imp) / imp * invw;
  s[S_CACT + c] = active ? 1.0f : 0.0f;
  s[S_CD + c] = active ? 1.0f / fmaxf(R, 1e-12f) : 0.0f;
  s[S_CADH + c] = 0.0f;
  st3(s, S_CPOS + 3 * c, cpos);
  // Jacobian direction components jp = sgn (S_v + S_w x rel) along n, t1,
  // t2, and above condim 3 sgn S_w about n (torsion), t1 and t2 (rolling):
  // dots with the contact frame, or the z, x, y components on flat ground;
  // sgn = -1 (an exact negation) on the second body's DoFs.
  const V3 rel = sub(cpos, ref);
  const CPath cp = cand_path(s, c);
  for (int i = 0; i < cp.n; ++i) {
    const V6 sd = ld6(s, S_SM + 6 * path_dof(cp, i));
    const V3 jp = add(sd.v, cross(sd.w, rel));
    const float sg = i < cp.split ? 1.0f : -1.0f;
    s[comp_row(c, i, 0)] = sg * (framed ? dot(jp, fn) : jp.z);
    if constexpr (NTAG >= 2) {
      s[comp_row(c, i, 1)] = sg * (framed ? dot(jp, f1) : jp.x);
      s[comp_row(c, i, 2)] = sg * (framed ? dot(jp, f2) : jp.y);
    }
    if constexpr (NTAG >= 3) s[comp_row(c, i, 3)] = sg * (framed ? dot(sd.w, fn) : sd.w.z);
    if constexpr (NTAG == 5) {
      s[comp_row(c, i, 4)] = sg * (framed ? dot(sd.w, f1) : sd.w.x);
      s[comp_row(c, i, 5)] = sg * (framed ? dot(sd.w, f2) : sd.w.y);
    }
  }
  // The reference acceleration and the rows at the warm start.
  float p[NDIR], vel[NROWS], jr[NROWS];
  products(s, c, S_V, p);
  row_combos(c, p, vel);
  const float kimp = kKGain[c] * imp;
  products(s, c, S_A, p);
  row_combos(c, p, jr);
  for (int r = 0; r < NROWS; ++r)
    s[S_JAR + NROWS * c + r] = jr[r] - (kNegBGain[c] * vel[r] - kimp * pos_err);
  coef(s, c);
}

// Per-leg 16-value net-force sensor sn into its output rows.
MS_FN void sensor(const Col& out, const Rows& s, int sn, int o_sens) {
  const int r0 = o_sens + 16 * sn;
  float row[16] = {};
  const int j0 = kSensPtr[sn], j1 = kSensPtr[sn + 1];
  if (j1 > j0) {
    float count = 0.0f, fmag = 0.0f;
    V3 ff = {0.0f, 0.0f, 0.0f}, posw = ff, posp = ff, tw = ff;
    for (int j = j0; j < j1; ++j) count = count + s[S_CACT + kSensCand[j]];
    // Contact-frame force (n, t1, t2) of a candidate from its final rows,
    // before and after the active mask: the normal force sums every row,
    // the tangential ones take the sliding rows (none at condim 1).
    auto raw_force = [&](int c) {
      const float D = s[S_CD + c];
      float lam[NROWS];
      for (int r = 0; r < NROWS; ++r) {
        const float jr = s[S_JAR + NROWS * c + r];
        lam[r] = fmaxf(-D * (jr < 0.0f ? 1.0f : 0.0f) * jr, 0.0f);
      }
      float fn = 0.0f;
      for (int r = 0; r < NROWS; ++r) fn = fn + lam[r];
      if constexpr (NTAG == 0) return V3{fn, 0.0f, 0.0f};
      else return V3{fn, kMu[c] * (lam[0] - lam[1]), kMu[c] * (lam[2] - lam[3])};
    };
    auto frame_force = [&](int c) { return scale(raw_force(c), s[S_CACT + c]); };
    // World force: the frame's axes weighted, or (t1, t2, n) = (x, y, z).
    auto world_force = [&](int c) {
      if (!has_frame(c)) {
        const V3 f = frame_force(c);
        return V3{f.y, f.z, f.x};
      }
      const V3 f = raw_force(c);
      const int fr = frame_row(c);
      const V3 fw = add(add(scale(ld3(s, fr), f.x), scale(ld3(s, fr + 3), f.y)),
                        scale(ld3(s, fr + 6), f.z));
      return scale(fw, s[S_CACT + c]);
    };
    for (int j = j0; j < j1; ++j) {
      const int c = kSensCand[j];
      ff = add(ff, scale(frame_force(c), s[S_CACT + c]));
    }
    for (int j = j0; j < j1; ++j) {
      const int c = kSensCand[j];
      const float w = s[S_CACT + c];
      const float fm = fabsf(frame_force(c).x) * w;
      const V3 cp = ld3(s, S_CPOS + 3 * c);
      fmag = fmag + fm;
      posw = add(posw, scale(cp, fm));
      posp = add(posp, scale(cp, w));
    }
    const bool by_force = fmag > 1e-12f;
    const float fden = fmaxf(fmag, 1e-12f), cden = fmaxf(count, 1.0f);
    const V3 pos = {by_force ? posw.x / fden : posp.x / cden,
                    by_force ? posw.y / fden : posp.y / cden,
                    by_force ? posw.z / fden : posp.z / cden};
    // The sensor frame. Flat ground: normal z, tangent x. Terrain: the
    // weighted mean normal and the mean t1 made orthogonal to it.
    V3 nrm = {0.0f, 0.0f, 1.0f}, tan = {1.0f, 0.0f, 0.0f};
    if (kHasHfield) {
      V3 nsum = {0.0f, 0.0f, 0.0f}, tsum = nsum;
      for (int j = j0; j < j1; ++j) {
        const int c = kSensCand[j];
        const float w = s[S_CACT + c];
        nsum = add(nsum, scale(ld3(s, frame_row(c)), w));
        tsum = add(tsum, scale(ld3(s, frame_row(c) + 3), w));
      }
      const float nn = sqrtf(dot(nsum, nsum));
      const bool nok = nn > 1e-9f;
      const float nden = fmaxf(nn, 1e-12f);
      nrm = V3{nok ? nsum.x / nden : 0.0f, nok ? nsum.y / nden : 0.0f,
               nok ? nsum.z / nden : 1.0f};
      tsum = sub(tsum, scale(nrm, dot(tsum, nrm)));
      const float tn = sqrtf(dot(tsum, tsum));
      const bool tok = tn > 1e-9f;
      const float tden = fmaxf(tn, 1e-12f);
      tan = V3{tok ? tsum.x / tden : 1.0f, tok ? tsum.y / tden : 0.0f,
               tok ? tsum.z / tden : 0.0f};
    }
    for (int j = j0; j < j1; ++j) {
      const int c = kSensCand[j];
      const float w = s[S_CACT + c];
      const V3 tq = cross(sub(ld3(s, S_CPOS + 3 * c), pos), world_force(c));
      tw = add(tw, scale(tq, w));
    }
    const V3 t2 = cross(nrm, tan);
    const float vals[16] = {count > 0.0f ? 1.0f : 0.0f, ff.x, ff.y, ff.z,
                            dot(tw, nrm), dot(tw, tan), dot(tw, t2),
                            pos.x, pos.y, pos.z, nrm.x, nrm.y, nrm.z, tan.x, tan.y, tan.z};
    for (int r = 0; r < 16; ++r) row[r] = vals[r];
  }
  for (int r = 0; r < 16; ++r) out[r0 + r] = row[r];
}

// qacc (S_A) with the contact rows: candidates, adhesion, the first pass
// (gradient, Hessian, factor) and the Newton iterations with their line
// search, from the forces in S_QFRC and the warm start in S_A.
MS_FN void contact_accel(const Col& in, const Rows& s, int K, V3 ref, Prof& prof) {
  // ---------------- contact candidates ------------------------------------
  for (int c : par(NCAND)) candidate(in, s, c, K, ref);
  MS_SYNC();
  // Adhesion: each actuator's force split over its active candidates.
  for (int gi : par(NADH)) {
    const int u = kAdhAct[gi];
    const float total = kActGain[u] * s[S_CCL + u];
    float count = 0.0f;
    for (int j = kAdhPtr[gi]; j < kAdhPtr[gi + 1]; ++j) count = count + s[S_CACT + kAdhCand[j]];
    const float per = total / fmaxf(count, 1.0f);
    for (int j = kAdhPtr[gi]; j < kAdhPtr[gi + 1]; ++j) {
      const int c = kAdhCand[j];
      s[S_CADH + c] = s[S_CACT + c] != 0.0f ? per : 0.0f;
    }
  }
  MS_SYNC();
  prof.mark(kPhCandidates);

  // ---------------- first pass: adhesion, gradient, Hessian, factor ------
  dof_sums(s, true);
  hess_fill(s);
  MS_SYNC();
  tree_ldl(s);
  prof.mark(kPhFirstPass);

  // ---------------- Newton: frozen Hessian, or exact (SOLVER_EXACT) -------
  // The exact Newton re-fills the Hessian from Mh (S_MH, which the factor
  // leaves intact) at the current active set and re-factors it in S_H.
  mh_mul(s, S_A, S_MA);
  prof.mark(kPhMhMul);
  int turn = 0;
  MS_NOUNROLL
  for (int it = 0; it < NEWTON_ITERS; ++it) {
    if (it > 0) {
      dof_sums(s, false);
      if (kSolverExact) hess_fill(s);
      MS_SYNC();
      if (kSolverExact) tree_ldl(s);
    }
    prof.mark(kPhRefill);
    for (int d : par(NV)) s[S_DEL + d] = s[S_MA + d] - s[S_QFRC + d] + s[S_GC + d];
    MS_SYNC();
    tree_solve(s, S_DEL);
    for (int d : par(NV)) s[S_DEL + d] = -s[S_DEL + d];
    MS_SYNC();
    prof.mark(kPhSolve);
    mh_mul(s, S_DEL, S_MD);
    prof.mark(kPhMhMul);
    float dMd = 0.0f, gMd = 0.0f;
    MS_UNROLL4
    for (int d = 0; d < NV; ++d) {
      const float del = s[S_DEL + d], md = s[S_MD + d];
      dMd = dMd + del * md;
      gMd = gMd + s[S_A + d] * md - s[S_QFRC + d] * del;
    }
    for (int c : par(NCAND)) {
      float p[NDIR], jd[NROWS];
      products(s, c, S_DEL, p);
      row_combos(c, p, jd);
      for (int r = 0; r < NROWS; ++r) s[S_JD + NROWS * c + r] = jd[r];
    }
    MS_SYNC();
    prof.mark(kPhJd);
    // Bisection with a final regula falsi: only the sign of φ' feeds back.
    float dlo = dphi(s, gMd, dMd, 0.0f, true, turn);
    const float d0 = dlo;
    float dhi = dphi(s, gMd, dMd, 0.0f + kAlphaMax, false, turn);
    float lo = 0.0f, hi = 0.0f + kAlphaMax;
    MS_NOUNROLL
    for (int kb = 0; kb < LS_BISECT; ++kb) {
      const float mid = 0.5f * (lo + hi);
      const float dm = dphi(s, gMd, dMd, mid, false, turn);
      const bool neg = dm < 0.0f;
      lo = neg ? mid : lo;
      dlo = neg ? dm : dlo;
      hi = neg ? hi : mid;
      dhi = neg ? dhi : dm;
    }
    const float t = -dlo / fmaxf(dhi - dlo, 1e-12f);
    float alpha = lo + clampf(t, 0.0f, 1.0f) * (hi - lo);
    alpha = d0 < 0.0f ? alpha : 0.0f;
    prof.mark(kPhLineSearch);
    for (int d : par(NV)) {
      s[S_A + d] = s[S_A + d] + alpha * s[S_DEL + d];
      s[S_MA + d] = s[S_MA + d] + alpha * s[S_MD + d];
    }
    for (int c : par(NCAND)) {
      for (int r = 0; r < NROWS; ++r)
        s[S_JAR + NROWS * c + r] = s[S_JAR + NROWS * c + r] + alpha * s[S_JD + NROWS * c + r];
      coef(s, c);
    }
    MS_SYNC();
    prof.mark(kPhUpdate);
  }
}

// qacc (S_A) of a world without contact candidates: Mh qacc = qfrc through
// the tree factor of Mh (the emitter's _contacts without candidates; no
// 1e-9 on the diagonal, which only the contact Hessian takes).
MS_FN void free_accel(const Rows& s) {
  for (int k : par(NPK)) s[S_H + k] = s[S_MH + k];
  for (int d : par(NV)) s[S_A + d] = s[S_QFRC + d];
  MS_SYNC();
  tree_ldl(s);
  tree_solve(s, S_A);
}

// One physics step of one world: state in scratch rows S_Q, S_V, S_A (warm
// start) and S_ACT (activations), controls from input rows of step k; the
// last step writes outputs. Every thread of the block runs it; the loops
// over bodies, DoFs, entries, candidates, actuators and sensors are spread
// over the block, with a barrier where a loop reads what another wrote.
MS_FN void step_world(const Col& in, const Col& out, const Rows& s, int k, int K, Prof& prof) {
  const bool last = k == K - 1;

  // ---------------- FK: parent -> child, one tree level at a time --------
  // The hinges' half-angle cosines and sines first, all at once.
  for (int h : par(NHINGE)) {
    const float half = 0.5f * s[S_Q + kHingeQ[h]];
    s[S_HCS + 2 * h] = ms_cosf(half);
    s[S_HCS + 2 * h + 1] = ms_sinf(half);
  }
  if (lead()) {
    st3(s, S_XPOS, V3{0.0f, 0.0f, 0.0f});
    st4(s, S_XQUAT, Q4{1.0f, 0.0f, 0.0f, 0.0f});
  }
  MS_NOUNROLL
  for (int l = 0; l < NLEVEL; ++l) {
    MS_SYNC();
    for (int j : par(kLevelPtr[l + 1] - kLevelPtr[l])) fk_body(s, kLevelBody[kLevelPtr[l] + j]);
  }
  MS_SYNC();
  const V3 ref = ld3(s, S_XPOS + 3 * REF_BODY);

  // ---------------- motion subspace S = (angular, linear) at ref, and the
  // spatial inertias about ref --------------------------------------------
  for (int h : par(NHINGE)) {
    const V3 aw = ld3(s, S_HAX + 3 * h);
    const V3 anchor = sub(ld3(s, S_XPOS + 3 * kHingeBody[h]), ref);
    st6(s, S_SM + 6 * kHingeV[h], V6{aw, cross(anchor, aw)});
  }
  for (int j : par(NFREE)) {
    const int b = kFreeBody[j], va = kFreeV[b];
    const V3 p = sub(ld3(s, S_XPOS + 3 * b), ref);
    for (int i = 0; i < 3; ++i) {
      const V3 e = {i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f, i == 2 ? 1.0f : 0.0f};
      st6(s, S_SM + 6 * (va + i), V6{{0.0f, 0.0f, 0.0f}, e});
      st6(s, S_SM + 6 * (va + 3 + i), V6{e, cross(p, e)});
    }
  }
  for (int ti : par(NTOPO)) inertia_body(s, kTopo[ti], ref);
  if (lead()) {
    st6(s, S_CVEL, V6{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}});
    st6(s, S_CACC, V6{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}});
  }
  MS_SYNC();

  // ---------------- velocities top-down, composite inertias bottom-up ----
  MS_NOUNROLL
  for (int l = 0; l < NLEVEL; ++l) {
    for (int j : par(kLevelPtr[l + 1] - kLevelPtr[l])) vel_body(s, kLevelBody[kLevelPtr[l] + j]);
    const int lu = NLEVEL - 1 - l;
    for (int j : par(kLevelPtr[lu + 1] - kLevelPtr[lu]))
      add_children(s, S_IC, 9, kLevelBody[kLevelPtr[lu] + j]);
    MS_SYNC();
  }

  // ---------------- CRBA: tree-sparse Mh = M + armature + dt*damping; RNEA's
  // body forces ----------------------------------------------------------
  for (int d : par(NV)) {
    const int bd = kDofBody[d];
    const V6 F = inertia_mul(s, S_IC + 9 * bd, kCompMass[bd], ld6(s, S_SM + 6 * d));
    for (int idx = kPkPtr[d]; idx < kPkPtr[d + 1]; ++idx) {
      const int a = kPkRow[idx];
      float val = dot6(ld6(s, S_SM + 6 * a), F);
      if (a == d) val = val + kDofArm[d] + kDofDtDamp[d];
      s[S_MH + idx] = val;
    }
  }
  const V3 g = {kGrav[0], kGrav[1], kGrav[2]};
  for (int ti : par(NTOPO)) {
    const int b = kTopo[ti];
    const V6 cv = ld6(s, S_CVEL + 6 * b), ca = ld6(s, S_CACC + 6 * b);
    const V6 Ia = inertia_mul(s, S_IB + 9 * b, kBodyMass[b], V6{ca.w, sub(ca.v, g)});
    const V6 Iv = inertia_mul(s, S_IB + 9 * b, kBodyMass[b], cv);
    const V6 fc = {add(cross(cv.w, Iv.w), cross(cv.v, Iv.v)), cross(cv.w, Iv.v)};
    st6(s, S_FSUB + 6 * b, add6(Ia, fc));
  }
  MS_NOUNROLL
  for (int l = NLEVEL - 1; l >= 0; --l) {
    MS_SYNC();
    for (int j : par(kLevelPtr[l + 1] - kLevelPtr[l]))
      add_children(s, S_FSUB, 6, kLevelBody[kLevelPtr[l] + j]);
  }
  MS_SYNC();
  prof.mark(kPhDynamics);

  // ---------------- passive + actuator forces -----------------------------
  for (int d : par(NV)) {
    const float bias = dot6(ld6(s, S_SM + 6 * d), ld6(s, S_FSUB + 6 * kDofBody[d]));
    float f = kDofNegDamp[d] * s[S_V + d] - bias;
    const int h = kDofHinge[d];
    if (h >= 0) f = f - kHingeK[h] * (s[S_Q + kHingeQ[h]] - kHingeRef[h]);
    s[S_QFRC + d] = f;
  }
  for (int u : par(NU)) actuator(in, s, u, k);
  MS_SYNC();
  for (int d : par(NV)) {
    float f = s[S_QFRC + d];
    for (int j = kDofActPtr[d]; j < kDofActPtr[d + 1]; ++j) f = f + s[S_AF + kDofAct[j]];
    s[S_QFRC + d] = f;
  }
  MS_SYNC();
  prof.mark(kPhForces);

  // ---------------- qacc: the contact solve, or (no candidates) the tree
  // solve of Mh against the forces ----------------------------------------
  if constexpr (NCAND > 0) {
    contact_accel(in, s, K, ref, prof);
  } else {
    free_accel(s);
    prof.mark(kPhSolve);
  }

  // ---------------- outputs of the last step (pre-integration FK) ---------
  const int o0 = (K - 1) * NQ;  // the state rows follow the K-1 qpos rows
  const int o_xpos = o0 + NQ + 2 * NV + NA;
  const int o_xquat = o_xpos + 3 * NBODY;
  const int o_site = o_xquat + 4 * NBODY;
  const int o_af = o_site + 3 * NSITE;
  const int o_sens = o_af + NU;
  if (last) {
    for (int r : par(3 * NBODY)) out[o_xpos + r] = s[S_XPOS + r];
    for (int r : par(4 * NBODY)) out[o_xquat + r] = s[S_XQUAT + r];
    for (int si : par(NSITE)) {
      const int b = kSiteBody[si];
      const V3 sp = add(ld3(s, S_XPOS + 3 * b), qrot(ld4(s, S_XQUAT + 4 * b), TV3(kSitePos, si)));
      out[o_site + 3 * si] = sp.x;
      out[o_site + 3 * si + 1] = sp.y;
      out[o_site + 3 * si + 2] = sp.z;
    }
    for (int u : par(NU)) out[o_af + u] = s[S_AF + u];
    for (int sn : par(NSENSOR)) sensor(out, s, sn, o_sens);
  }
  prof.mark(kPhOutputs);

  // ---------------- semi-implicit Euler -----------------------------------
  for (int d : par(NV)) s[S_V + d] = s[S_V + d] + kDt * s[S_A + d];
  MS_SYNC();
  for (int h : par(NHINGE)) {
    const int qa = S_Q + kHingeQ[h];
    s[qa] = s[qa] + kDt * s[S_V + kHingeV[h]];
  }
  for (int j : par(NFREE)) {
    const int b = kFreeBody[j], qa = S_Q + kFreeQ[b], va = S_V + kFreeV[b];
    for (int i = 0; i < 3; ++i) s[qa + i] = s[qa + i] + kDt * s[va + i];
    const V3 om = ld3(s, va + 3);
    const float ang = sqrtf(dot(om, om) + 1e-24f) * kDt;
    const float sc = ang > 1e-12f ? ms_sinf(0.5f * ang) / fmaxf(ang / kDt, 1e-12f) : kHalfDt;
    const Q4 dq = {ms_cosf(0.5f * ang), om.x * sc, om.y * sc, om.z * sc};
    const Q4 nq = qmul(dq, ld4(s, qa + 3));
    const float norm = sqrtf(nq.w * nq.w + nq.x * nq.x + nq.y * nq.y + nq.z * nq.z);
    st4(s, qa + 3, Q4{nq.w / norm, nq.x / norm, nq.y / norm, nq.z / norm});
  }

  // ---------------- activation dynamics -----------------------------------
  // From the clamped controls and the activations at the start of the step
  // (each slot belongs to one actuator, so the update is in place).
  for (int u : par(NU)) {
    const int adr = kActAdr[u];
    if (adr < 0) continue;
    const int kind = kActKind[u];
    const float c = s[S_CCL + u], a = s[S_ACT + adr];
    if (kind == kIntVelocity) {
      s[S_ACT + adr] = a + kDt * c;
    } else if (kind == kCylinder) {
      s[S_ACT + adr] = a + kDt * (c - a) / kActTau0[u];
    } else if (kind == kMuscle) {
      const float cm = clampf(c, 0.0f, 1.0f), sc = 0.5f + 1.5f * a;
      const float tau = cm > a ? kActTau0[u] * sc : kActTau1[u] / sc;
      s[S_ACT + adr] = clampf(a + kDt * (cm - a) / fmaxf(tau, 1e-9f), 0.0f, 1.0f);
    }
  }
  MS_SYNC();

  if (!last) {
    for (int i : par(NQ)) out[k * NQ + i] = s[S_Q + i];
  } else {
    for (int i : par(NQ)) out[o0 + i] = s[S_Q + i];
    for (int i : par(NV)) out[o0 + NQ + i] = s[S_V + i];
    for (int i : par(NA)) out[o0 + NQ + NV + i] = s[S_ACT + i];
    for (int i : par(NV)) out[o0 + NQ + NV + NA + i] = s[S_A + i];
  }
  prof.mark(kPhEuler);
}

// K steps of world w: in (n_in, B), out (n_out, B) world-minor.
MS_FN void run_world(const float* in, float* out, const Rows& S, int w, int B, int K,
                     Prof& prof) {
  const size_t sB = static_cast<size_t>(B);
  const Col I{const_cast<float*>(in) + w, sB}, O{out + w, sB};
  for (int i : par(NQ)) S[S_Q + i] = I[i];
  for (int i : par(NV)) S[S_V + i] = I[NQ + i];
  for (int i : par(NA)) S[S_ACT + i] = I[NQ + NV + K * NU + i];
  for (int i : par(NV)) S[S_A + i] = I[NQ + NV + K * NU + NA + i];
#ifdef MS_PAIRS_COMPRESSED
  for (int g : par(NPAIR)) {
    const int w_g = static_cast<int>(I[NQ + NV + K * NU + NA + NV + g]);
    S[S_WIN + g] = static_cast<float>(kGroupBase[g] + w_g);
  }
#endif
  MS_SYNC();
  MS_NOUNROLL
  for (int k = 0; k < K; ++k) step_world(I, O, S, k, K, prof);
}

constexpr size_t kSharedBytes = sizeof(float) * static_cast<size_t>(N_SHARED);

#ifdef __CUDACC__
// One block per world; its rows [0, N_SHARED) in dynamic shared memory,
// the rest at scratch + w N_GLOBAL. prof (the profile build's) is
// (kNumPhases, B) clock cycles.
__global__ void __launch_bounds__(kThreads)
megastep_kernel(const float* __restrict__ in, float* __restrict__ out,
                float* __restrict__ scratch, long long* __restrict__ prof, int B, int K) {
  extern __shared__ float sh[];
  const int w = blockIdx.x;
  const Rows S{sh, scratch + static_cast<size_t>(w) * N_GLOBAL};
  Prof p;
  run_world(in, out, S, w, B, K, p);
#ifdef MS_PROFILE
  if (threadIdx.x == 0)
    for (int i = 0; i < kNumPhases; ++i) prof[static_cast<size_t>(i) * B + w] = p.acc[i];
#else
  (void)prof;
#endif
}

// ms_powf elementwise, to hold the step's pow against its plain version.
__global__ void powf_kernel(const float* __restrict__ x, const float* __restrict__ y,
                            float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = ms_powf(x[i], y[i]);
}

// The kernel's dynamic shared memory above the default 48 KB.
cudaError_t set_attributes() {
  return cudaFuncSetAttribute(megastep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSharedBytes));
}

int launch(const void* in, void* out, void* scratch, void* prof, int B, int K, void* stream) {
  if (B <= 0 || K < 1) return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = set_attributes();
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  megastep_kernel<<<B, kThreads, kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), static_cast<float*>(scratch),
      static_cast<long long*>(prof), B, K);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int megastep_f32(const void* in, void* out, void* scratch, int B, int K,
                            void* stream) {
  return launch(in, out, scratch, nullptr, B, K, stream);
}

#ifdef MS_PROFILE
extern "C" int megastep_profile_f32(const void* in, void* out, void* scratch, void* prof, int B,
                                    int K, void* stream) {
  return launch(in, out, scratch, prof, B, K, stream);
}
#endif

// The launch's shape: threads per block, dynamic shared bytes per block,
// global scratch floats per world, and the blocks per SM the card can keep
// resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor) in out[3].
extern "C" int megastep_shape(int* shape) {
  shape[0] = kThreads;
  shape[1] = static_cast<int>(kSharedBytes);
  shape[2] = N_GLOBAL;
  cudaError_t err = set_attributes();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shape[3], megastep_kernel, kThreads,
                                                        kSharedBytes);
  return static_cast<int>(err);
}

// out[i] = ms_powf(x[i], y[i]) for i < n, the step's pow alone.
extern "C" int megastep_powf_f32(const void* x, const void* y, void* out, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  powf_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#else
// The kernel's blocks as a loop over worlds, each parallel loop run in
// order (order 0) or reversed (order 1). scratch holds B N_SHARED floats
// that stand for the blocks' shared memory, then B N_GLOBAL.
extern "C" int megastep_host_f32(const float* in, float* out, float* scratch, int B, int K,
                                 int order) {
  if (B <= 0 || K < 1 || (order != 0 && order != 1)) return 1;
  g_reversed = order == 1;
  for (int w = 0; w < B; ++w) {
    const Rows S{scratch + static_cast<size_t>(w) * N_SHARED,
                 scratch + static_cast<size_t>(B) * N_SHARED + static_cast<size_t>(w) * N_GLOBAL};
    Prof p;
    run_world(in, out, S, w, B, K, p);
  }
  return 0;
}

// out[i] = ms_powf(x[i], y[i]) for i < n, the step's pow alone.
extern "C" int megastep_powf_host_f32(const float* x, const float* y, float* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = ms_powf(x[i], y[i]);
  return 0;
}
#endif
