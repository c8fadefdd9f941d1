// Retina kernel K3: both compound eyes of every world, one ray per
// ommatidium, nearest hit against the scene's capsules and the ground plane,
// shaded and weighted into two spectral channels; for NVIDIA Hopper (sm_90a).
//
// Replaces (TPU kernel of the JAX package): flygym_tpu/ops/retina_pallas.py
// make_retina_kernel.<kernel> (_build_kernel), launched by pallas_call in
// render_batched, in both of its lane layouts. Its plain PyTorch version,
// used for CPU tensors and as the oracle on the card, is
// flygym_tpu_torch/ops/retina.py retina_plain.
//
// Design. The first design (one block per (world, eye), one thread per ray
// in lattice order, every ray sweeping every geom) is kept as the yardstick
// in scripts/k3_before_redesign/retina.cu. This one:
// - Rays in compact warp tiles. ops/retina.py:ray_tiles orders each eye's
//   rays into T tiles of 32 slots (recursive bisection of the directions)
//   and gives each tile a cone, its unit axis in the eye frame and a
//   half-angle rounded outward, that holds its rays. A warp shades one tile,
//   a lane one slot, and writes the ray's two intensities to the ray's own
//   ommatidium index; the pad slots of the last tile shade nothing.
// - Geoms culled per (world, eye, tile). A block hoists, for its eye, the
//   ray-free quantities of every geom (segment, axis, the quadratic's
//   terms, the cone branch's inside-the-geom gate; retina_pallas.py:146-177)
//   and the geom's bounding sphere as the eye sees it. Each warp rotates its
//   tile's axis into the world frame and tests the G spheres against its
//   cone, 32 geoms at a time (keep_geom); the survivors go, in ascending
//   order, to the warp's list in shared memory (__ballot_sync, __popc). The
//   warp then sweeps only its list, the same geom on every lane.
// - The winner's index, not its data: the sweep carries the nearest hit's t
//   and geom index and the largest coverage and its geom index; the
//   winner's segment and colour are read back from shared memory after it.
// - The hoisted rows are geom-major float4 words: a pair reads four of them.
// - kWarps warps per block (-DRT_WARPS, 4 unless built otherwise), each
//   warp one tile: a block takes kWarps consecutive tiles of one (world,
//   eye) and hoists its eye's geoms; grid 2B * ceil(T / kWarps). The 4-warp
//   build ships (8 blocks of 57 registers a thread fill an SM's
//   registers); ops/_build.py:build_retina(warps=) builds 2, 8 and 24 (24:
//   the whole eye in one block), which chip_smoke.py times in turns.
//
// What bounds it on the H100: operations. Each (world, eye, ray) sweeps the
// geoms its tile kept at ~80 fp32 operations each (cone branch); a few
// percent of the (ray, geom) pairs contribute anything, a fifth of them are
// swept (PERF.md has the counts).
//
// Numerics. The body is the Pallas kernel's arithmetic, term for term and
// in the same order: built with -fmad=false and IEEE div and sqrt, it
// repeats retina_plain to the last bit wherever no silhouette or checker
// edge flips on an ulp, and the first design's build on every output (the
// cull drops only geoms whose every update would be a no-op; keep_geom
// says why). jnp.mod is a floored modulo (x - 2 floor(x / 2) here, exact on
// the integer-valued checker sums); ties keep the kernel's rules: a geom
// replaces the nearest hit only if strictly nearer (the ground plane is
// entered first), the sky is index -2 and the ground -1, and a geom's
// coverage replaces the running one only if strictly larger; the geoms are
// swept in ascending order. fmaxf/fminf differ from jnp.maximum/minimum
// only on NaN, which finite inputs do not produce (a sphere's zero-length
// segment is carried by the 1e-12 guards).
//
// The same file compiles as host C++ (g++ -x c++), where the blocks become
// loops over worlds, eyes, tiles and slots running the same hoist, cull and
// sweep (retina_tiles_host_f32, which can also export the cull's keep mask;
// retina_host_f32 takes the rays in lattice order, each ray a tile of its
// own), so the arithmetic and the cull are tested on the CPU.
//
// Interface: plain C, bound with ctypes (flygym_tpu_torch/ops/_build.py).
// Pointers are device pointers; the kernel allocates nothing, launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().
// Built with -DRT_PROFILE it also exports retina_profile_f32, which writes
// the cull's keep mask too: keep (B, 2, T, G) uint8, 1 where the tile sweeps
// the geom.
//
// Arrays (float32 unless said, C order; S = 32 T slots per eye):
//   in       (B, 14 + 6G)  per world: eye 0 pos (3), quat wxyz (4); eye 1
//                          pos, quat; then per geom p0 (3), p1 (3) in world
//   ray      (2, S) int32  the ommatidium index of each slot, -1 for a pad
//   tdirs    (2, S, 3)     each slot's ray direction in its eye's frame
//   tweights (2, S, 2, 3)  each slot's rgb weights of the two channels
//   axis     (2, T, 4)     each tile's unit axis (eye frame) and half-angle
//   radius   (G,)          capsule / sphere radius
//   rgb      (G, 3)        colour
//   out      (B, 2, R, 2)  intensities, in lattice order

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RT_FN __host__ __device__ __forceinline__
#else
#include <math.h>

#include <vector>
#define RT_FN inline
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
#endif
#include <stdint.h>

#ifndef RT_WARPS
#define RT_WARPS 4
#endif

namespace {

constexpr float kBig = 1e30f;
constexpr int kTile = 32;  // rays per tile: one warp
constexpr int kMaxGeoms = 512;
constexpr int kWarps = RT_WARPS;  // tiles per block
// The cull's margins: an angle (rad) added to every tile's reach, and the
// distance, relative to a bounding sphere's radius, within which the eye
// keeps the geom whatever the angle.
constexpr float kCullAngle = 1.0f / 64.0f;
constexpr float kCullNear = 1.0f + 1.0f / 64.0f;
constexpr float kAlwaysKeep = 8.0f;  // a reach beyond any angle (> pi)

// Hoisted rows of one geom, one float4 each, geom-major: H[g * kRows + row].
enum Row {
  kSeg,   // ba = p1 - p0, baba = |ba|^2
  kEye0,  // oa = eye - p0, baoa = ba . oa
  kEye1,  // ob = eye - p1, c_cyl
  kQuad,  // c_s0, c_s1, radius, outside (1 if the eye is outside the geom)
  kWin,   // p0, 1 / |ba|^2: the winner's normal
  kCol,   // rgb, 0
  kCull,  // unit vector eye -> bounding-sphere centre, the sphere's reach
  kRows
};

RT_FN float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// The checker's floored modulo by 2 (jnp.mod).
RT_FN float mod2(float x) { return x - 2.0f * floorf(x / 2.0f); }

// d rotated by the unit quaternion q (wxyz) into v (retina_pallas.py:179-186).
RT_FN void rotate(const float* q, const float* d, float* v) {
  const float dx = d[0], dy = d[1], dz = d[2];
  const float w_ = q[0], x_ = q[1], y_ = q[2], z_ = q[3];
  const float tx = 2.0f * (y_ * dz - z_ * dy);
  const float ty = 2.0f * (z_ * dx - x_ * dz);
  const float tz = 2.0f * (x_ * dy - y_ * dx);
  v[0] = dx + w_ * tx + (y_ * tz - z_ * ty);
  v[1] = dy + w_ * ty + (z_ * tx - x_ * tz);
  v[2] = dz + w_ * tz + (x_ * ty - y_ * tx);
}

// Geom g's ray-free quantities for an eye at opos (retina_pallas.py:146-177),
// and its bounding sphere: centre (p0 + p1) / 2, radius rho = |ba| / 2 + r,
// stored as the unit vector from the eye to the centre and the sphere's
// angular radius asin(rho / dist), or kAlwaysKeep where the eye lies within
// kCullNear * rho of the centre.
RT_FN void hoist_geom(float4* Hg, const float* opos, const float* seg, float r,
                      const float* col) {
  const float p0[3] = {seg[0], seg[1], seg[2]};
  const float p1[3] = {seg[3], seg[4], seg[5]};
  float ba[3], oa[3], ob[3], v[3];
  for (int k = 0; k < 3; ++k) {
    ba[k] = p1[k] - p0[k];
    oa[k] = opos[k] - p0[k];
    ob[k] = opos[k] - p1[k];
    v[k] = 0.5f * (p0[k] + p1[k]) - opos[k];
  }
  const float baba = ba[0] * ba[0] + ba[1] * ba[1] + ba[2] * ba[2];
  const float baoa = ba[0] * oa[0] + ba[1] * oa[1] + ba[2] * oa[2];
  const float oaoa = oa[0] * oa[0] + oa[1] * oa[1] + oa[2] * oa[2];
  const float obob = ob[0] * ob[0] + ob[1] * ob[1] + ob[2] * ob[2];
  const float rr = r * r;
  const float s0g = clip01(baoa / fmaxf(baba, 1e-12f));
  const float d0sq = oaoa - 2.0f * s0g * baoa + s0g * s0g * baba;
  Hg[kSeg] = make_float4(ba[0], ba[1], ba[2], baba);
  Hg[kEye0] = make_float4(oa[0], oa[1], oa[2], baoa);
  Hg[kEye1] = make_float4(ob[0], ob[1], ob[2], baba * oaoa - baoa * baoa - rr * baba);
  Hg[kQuad] = make_float4(oaoa - rr, obob - rr, r, d0sq > rr ? 1.0f : 0.0f);
  Hg[kWin] = make_float4(p0[0], p0[1], p0[2], 1.0f / fmaxf(baba, 1e-12f));
  Hg[kCol] = make_float4(col[0], col[1], col[2], 0.0f);
  const float dist = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  const float rho = 0.5f * sqrtf(baba) + r;
  const bool near = !(dist > kCullNear * rho);
  const float inv = near ? 0.0f : 1.0f / dist;
  Hg[kCull] = make_float4(v[0] * inv, v[1] * inv, v[2] * inv, near ? kAlwaysKeep : asinf(rho / dist));
}

// A tile's own reach: its half-angle, in the cone branch the widening by
// the acceptance cone, and the margin.
RT_FN float tile_reach(float half, bool cone, float tanh_cone) {
  return half + (cone ? asinf(fminf(fmaxf(tanh_cone, 1e-3f), 1.0f)) : 0.0f) + kCullAngle;
}

// Whether a tile whose axis is aw (world frame) keeps a geom: the angle
// from aw to the geom's bounding-sphere centre is at most the geom's reach
// plus the tile's.
//
// Why a geom it drops changes no output bit. Let o be the eye, c and rho
// the geom's bounding sphere, dist = |c - o| > kCullNear * rho, and rd a ray
// of the tile: rd lies within the half-angle of the tile's axis (the tables
// round it outward). In the sweep a geom changes the running state only if
// t_g < t_min or c_g2 > cov. t_min starts at kBig or the ground's t, so the
// first needs t_g < kBig: a cylinder hit (h >= 0, 0 < y_c < baba,
// t_cyl > 0) or an endpoint-sphere hit (h >= 0, t > 0), either way a point
// o + t rd, t > 0, within r of the segment p0-p1, hence inside the
// bounding sphere; so angle(rd, c - o) <= asin(rho / dist). cov starts at 0
// and c_g2 is clipped to [0, 1], so the second needs c_g2 > 0 before the
// outside and tc < t_bg gates (which only zero it): dperp - r < width, that
// is, the point q = o + tc rd lies within r + width of the segment and so
// within rho + width of c, where tc >= 1e-6 (the clamp) and width =
// max(tc tan(cone), 1e-9) <= tc max(tan(cone), 1e-3). The point q'' of the
// bounding sphere nearest q lies within width of q, which is tc away from o:
// angle(rd, q'' - o) <= asin(width / tc) <= asin(max(tan(cone), 1e-3)),
// the widening tile_reach adds, and angle(q'' - o, c - o) <= asin(rho /
// dist). A geom whose centre lies farther from the axis than the sum (plus
// the tile's half-angle) is therefore neither hit nor covered by any ray of
// the tile: t_g stays kBig, never < t_min, and c_g2 is 0, never > cov.
// Skipping it leaves t_min, idx, cov and its index as they were, so the
// outputs keep their bits. That holds in exact arithmetic; kCullAngle
// (1/64 rad) and kCullNear (1 + 1/64) cover the float32 rounding of these
// tests and of the kernel's own (the discriminants' cancellation moves a
// grazing ray's verdict by about sqrt(k eps) ~ 1e-3 rad at most; the
// quaternion rotations, the tables' float32 axes and acosf by ~1e-6).
// tests/test_torch_retina_cull.py checks the kept set against every
// contributing (tile, geom) pair of adversarial poses, and chip_smoke.py
// (phase 7) the outputs against the first design's build bit for bit.
RT_FN bool keep_geom(const float4& cull, const float* aw, float reach) {
  const float c = fminf(fmaxf(cull.x * aw[0] + cull.y * aw[1] + cull.z * aw[2], -1.0f), 1.0f);
  return acosf(c) <= cull.w + reach;
}

// One ray: nearest hit over the geoms of list (ascending), shading, channel
// weights (retina_pallas.py:179-396). d is the ray in the eye frame, w (2, 3)
// its channel weights; the two intensities go to out[0] and out[1].
template <bool kCone>
RT_FN void shade_ray(const float4* H, const uint16_t* list, int n, const float* opos,
                     const float* q, const float* d, const float* w, float ground_z,
                     float tanh_cone, float* out) {
  float rd[3];
  rotate(q, d, rd);
  const float rdx = rd[0], rdy = rd[1], rdz = rd[2];

  float t_min = kBig;
  int idx = -2;

  // Ground plane.
  const float oz = opos[2];
  const float tp = (ground_z - oz) / (fabsf(rdz) < 1e-12f ? 1e-12f : rdz);
  const bool hitp = (tp > 0.0f) && (fabsf(rdz) > 1e-12f);
  if (hitp) {
    t_min = tp;
    idx = -1;
  }
  float t_bg = kBig, bg_r = 0.0f, bg_g = 0.0f, bg_b = 0.0f;
  float cov = 0.0f;
  int cov_idx = -1;
  if (kCone) {
    t_bg = hitp ? tp : kBig;
    const float hxb = opos[0] + tp * rdx;
    const float hyb = opos[1] + tp * rdy;
    const float chk_b = mod2(floorf(hxb) + floorf(hyb));
    const float bgc = chk_b > 0.5f ? 0.4f : 0.3f;
    const float bg_shade = hitp ? 0.5f + 0.5f * fabsf(rdz) : 1.0f;
    bg_r = (hitp ? bgc : 0.65f) * bg_shade;
    bg_g = (hitp ? bgc : 0.75f) * bg_shade;
    bg_b = (hitp ? bgc : 0.9f) * bg_shade;
  }

  for (int i = 0; i < n; ++i) {
    const int g = list[i];
    const float4* Hg = H + g * kRows;
    const float4 seg = Hg[kSeg], e0 = Hg[kEye0], e1 = Hg[kEye1], qd = Hg[kQuad];
    const float bax = seg.x, bay = seg.y, baz = seg.z, baba = seg.w;
    const float oax = e0.x, oay = e0.y, oaz = e0.z, baoa = e0.w;
    const float bard = bax * rdx + bay * rdy + baz * rdz;
    const float rdoa = oax * rdx + oay * rdy + oaz * rdz;
    const float a_ = baba - bard * bard;
    const float b_ = baba * rdoa - baoa * bard;
    const float h_ = b_ * b_ - a_ * e1.w;
    const float safe_a = fabsf(a_) < 1e-12f ? 1e-12f : a_;
    const float t_cyl = (-b_ - sqrtf(fmaxf(h_, 0.0f))) / safe_a;
    const float y_c = baoa + t_cyl * bard;
    const bool cyl_ok = (h_ >= 0.0f) && (y_c > 0.0f) && (y_c < baba) && (t_cyl > 0.0f);
    // Endpoint spheres.
    const float b_s0 = rdoa;
    const float h_s0 = b_s0 * b_s0 - qd.x;
    float t_s0 = -b_s0 - sqrtf(fmaxf(h_s0, 0.0f));
    t_s0 = (h_s0 >= 0.0f && t_s0 > 0.0f) ? t_s0 : kBig;
    const float b_s1 = e1.x * rdx + e1.y * rdy + e1.z * rdz;
    const float h_s1 = b_s1 * b_s1 - qd.y;
    float t_s1 = -b_s1 - sqrtf(fmaxf(h_s1, 0.0f));
    t_s1 = (h_s1 >= 0.0f && t_s1 > 0.0f) ? t_s1 : kBig;
    const float t_g = cyl_ok ? t_cyl : fminf(t_s0, t_s1);
    if (t_g < t_min) {
      t_min = t_g;
      idx = g;
    }
    if (kCone) {
      // Ray-axis closest approach -> angular coverage of the cone.
      const float s_c = clip01((baoa - bard * b_s0) / fmaxf(a_, 1e-12f));
      const float tc = fmaxf(bard * s_c - b_s0, 1e-6f);
      const float dxc = oax + tc * rdx - s_c * bax;
      const float dyc = oay + tc * rdy - s_c * bay;
      const float dzc = oaz + tc * rdz - s_c * baz;
      const float dperp = sqrtf(dxc * dxc + dyc * dyc + dzc * dzc);
      const float width = fmaxf(tc * tanh_cone, 1e-9f);
      float c_g2 = clip01(0.5f - 0.5f * (dperp - qd.z) / width);
      c_g2 = c_g2 * qd.w;
      c_g2 = tc < t_bg ? c_g2 : 0.0f;
      if (c_g2 > cov) {
        cov = c_g2;
        cov_idx = g;
      }
    }
  }

  // The winner's segment and colour, read back by index: the floats the
  // sweep would have carried.
  float wp0[3] = {0.0f, 0.0f, 0.0f}, wba[3] = {0.0f, 0.0f, 0.0f}, w_ibaba = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  const bool is_geom = idx >= 0;
  if (is_geom) {
    const float4 seg = H[idx * kRows + kSeg], win = H[idx * kRows + kWin];
    const float4 col = H[idx * kRows + kCol];
    wp0[0] = win.x;
    wp0[1] = win.y;
    wp0[2] = win.z;
    w_ibaba = win.w;
    wba[0] = seg.x;
    wba[1] = seg.y;
    wba[2] = seg.z;
    cr = col.x;
    cg = col.y;
    cb = col.z;
  }
  // The winner's normal, from its segment.
  const float hx = opos[0] + t_min * rdx;
  const float hy = opos[1] + t_min * rdy;
  const float hz = opos[2] + t_min * rdz;
  float s_ = ((hx - wp0[0]) * wba[0] + (hy - wp0[1]) * wba[1] + (hz - wp0[2]) * wba[2]) * w_ibaba;
  s_ = clip01(s_);
  const float dx_ = hx - (wp0[0] + s_ * wba[0]);
  const float dy_ = hy - (wp0[1] + s_ * wba[1]);
  const float dz_ = hz - (wp0[2] + s_ * wba[2]);
  const float nrm = sqrtf(dx_ * dx_ + dy_ * dy_ + dz_ * dz_);
  const float inv_n = 1.0f / fmaxf(nrm, 1e-12f);
  const float nx = is_geom ? dx_ * inv_n : 0.0f;
  const float ny = is_geom ? dy_ * inv_n : 0.0f;
  const float nz = is_geom ? dz_ * inv_n : 1.0f;
  const float lam = fabsf(-(nx * rdx + ny * rdy + nz * rdz));
  if (kCone) {
    // Coverage blend: the shaded nearest geom where the ray hits, half its
    // colour for a near-miss, mixed with the background by coverage.
    float cov_r = 0.0f, cov_g = 0.0f, cov_b = 0.0f;
    if (cov_idx >= 0) {
      const float4 col = H[cov_idx * kRows + kCol];
      cov_r = col.x;
      cov_g = col.y;
      cov_b = col.z;
    }
    const float gshade = 0.5f + 0.5f * lam;
    const float g_r = is_geom ? cr * gshade : 0.5f * cov_r;
    const float g_g = is_geom ? cg * gshade : 0.5f * cov_g;
    const float g_b = is_geom ? cb * gshade : 0.5f * cov_b;
    cr = clip01(cov * g_r + (1.0f - cov) * bg_r);
    cg = clip01(cov * g_g + (1.0f - cov) * bg_g);
    cb = clip01(cov * g_b + (1.0f - cov) * bg_b);
  } else {
    const bool is_ground = idx == -1;
    const bool is_sky = idx == -2;
    const float checker = mod2(floorf(hx) + floorf(hy));
    const float gcol = checker > 0.5f ? 0.4f : 0.3f;
    cr = is_ground ? gcol : (is_sky ? 0.65f : cr);
    cg = is_ground ? gcol : (is_sky ? 0.75f : cg);
    cb = is_ground ? gcol : (is_sky ? 0.9f : cb);
    const float shade = is_sky ? 1.0f : 0.5f + 0.5f * lam;
    cr = clip01(cr * shade);
    cg = clip01(cg * shade);
    cb = clip01(cb * shade);
  }
  for (int k = 0; k < 2; ++k) {
    out[k] = cr * w[3 * k] + cg * w[3 * k + 1] + cb * w[3 * k + 2];
  }
}

RT_FN bool bad_args(int B, int R, int T, int G) {
  return B <= 0 || R <= 0 || T <= 0 || T * kTile < R || G < 0 || G > kMaxGeoms;
}

RT_FN const float* eye_row(const float* in, int world, int G) {
  return in + static_cast<size_t>(world) * (14 + 6 * G);
}

#ifdef __CUDACC__

template <bool kCone>
__global__ void __launch_bounds__(kWarps * kTile)
retina_kernel(const float* __restrict__ in, const int* __restrict__ ray,
              const float* __restrict__ tdirs, const float* __restrict__ tweights,
              const float4* __restrict__ axis, const float* __restrict__ radius,
              const float* __restrict__ rgb, float* __restrict__ out, int R, int T, int G,
              float ground_z, float tanh_cone, uint8_t* keep) {
  extern __shared__ float4 H[];  // (G, kRows), then the warps' lists (kWarps, G)
  uint16_t* list = reinterpret_cast<uint16_t*>(H + G * kRows) + (threadIdx.x / kTile) * G;
  const int groups = (T + kWarps - 1) / kWarps;
  const int we = blockIdx.x / groups;  // world * 2 + eye
  const int world = we >> 1, eye = we & 1;
  const int tile = (blockIdx.x % groups) * kWarps + threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const float* row = eye_row(in, world, G);
  const float opos[3] = {__ldg(row + 7 * eye), __ldg(row + 7 * eye + 1), __ldg(row + 7 * eye + 2)};
  const float q[4] = {__ldg(row + 7 * eye + 3), __ldg(row + 7 * eye + 4),
                      __ldg(row + 7 * eye + 5), __ldg(row + 7 * eye + 6)};
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float seg[6], col[3];
    for (int k = 0; k < 6; ++k) seg[k] = __ldg(row + 14 + 6 * g + k);
    for (int k = 0; k < 3; ++k) col[k] = __ldg(rgb + 3 * g + k);
    hoist_geom(H + g * kRows, opos, seg, __ldg(radius + g), col);
  }
  __syncthreads();
  if (tile >= T) return;  // the whole warp

  // The tile's survivors, in ascending order.
  const float4 ax = __ldg(axis + eye * T + tile);
  const float a[3] = {ax.x, ax.y, ax.z};
  float aw[3];
  rotate(q, a, aw);
  const float reach = tile_reach(ax.w, kCone, tanh_cone);
  int n = 0;
  for (int g0 = 0; g0 < G; g0 += kTile) {
    const int g = g0 + lane;
    const bool k = g < G && keep_geom(H[g * kRows + kCull], aw, reach);
    const unsigned mask = __ballot_sync(0xffffffffu, k);
    if (k) list[n + __popc(mask & ((1u << lane) - 1u))] = static_cast<uint16_t>(g);
    n += __popc(mask);
#ifdef RT_PROFILE
    if (g < G) keep[(static_cast<size_t>(we) * T + tile) * G + g] = k;
#endif
  }
  __syncwarp();

  const int slot = (eye * T + tile) * kTile + lane;
  const int r = __ldg(ray + slot);
  if (r < 0) return;  // a pad slot
  const float d[3] = {__ldg(tdirs + 3 * slot), __ldg(tdirs + 3 * slot + 1),
                      __ldg(tdirs + 3 * slot + 2)};
  float w[6];
  for (int k = 0; k < 6; ++k) w[k] = __ldg(tweights + 6 * slot + k);
  float o[2];
  shade_ray<kCone>(H, list, n, opos, q, d, w, ground_z, tanh_cone, o);
  reinterpret_cast<float2*>(out)[static_cast<size_t>(we) * R + r] = make_float2(o[0], o[1]);
}

using Kernel = decltype(&retina_kernel<true>);

Kernel kernel_for(int use_cone) { return use_cone ? retina_kernel<true> : retina_kernel<false>; }

size_t shared_bytes(int G) { return sizeof(float4) * kRows * G + sizeof(uint16_t) * kWarps * G; }

// Lets kernel take smem dynamic shared bytes where that exceeds the default.
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int launch(const void* in, const void* ray, const void* tdirs, const void* tweights,
           const void* axis, const void* radius, const void* rgb, void* out, int B, int R,
           int T, int G, float ground_z, float tanh_cone, int use_cone, uint8_t* keep,
           void* stream) {
  if (bad_args(B, R, T, G)) return cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(use_cone);
  const size_t smem = shared_bytes(G);
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(2 * B * ((T + kWarps - 1) / kWarps));
  kernel<<<grid, kWarps * kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const int*>(ray),
      static_cast<const float*>(tdirs), static_cast<const float*>(tweights),
      static_cast<const float4*>(axis), static_cast<const float*>(radius),
      static_cast<const float*>(rgb), static_cast<float*>(out), R, T, G, ground_z, tanh_cone,
      keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int retina_f32(const void* in, const void* ray, const void* tdirs,
                          const void* tweights, const void* axis, const void* radius,
                          const void* rgb, void* out, int B, int R, int T, int G,
                          float ground_z, float tanh_cone, int use_cone, void* stream) {
  return launch(in, ray, tdirs, tweights, axis, radius, rgb, out, B, R, T, G, ground_z,
                tanh_cone, use_cone, nullptr, stream);
}

#ifdef RT_PROFILE
extern "C" int retina_profile_f32(const void* in, const void* ray, const void* tdirs,
                                  const void* tweights, const void* axis, const void* radius,
                                  const void* rgb, void* out, int B, int R, int T, int G,
                                  float ground_z, float tanh_cone, int use_cone, void* keep,
                                  void* stream) {
  return launch(in, ray, tdirs, tweights, axis, radius, rgb, out, B, R, T, G, ground_z,
                tanh_cone, use_cone, static_cast<uint8_t*>(keep), stream);
}
#endif

// This build's launch: shape[0] threads per block, shape[1] dynamic shared
// bytes, shape[2] blocks resident per SM.
extern "C" int retina_shape(int use_cone, int G, int* shape) {
  if (G < 0 || G > kMaxGeoms) return cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(use_cone);
  const size_t smem = shared_bytes(G);
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kWarps * kTile, smem);
  shape[0] = kWarps * kTile;
  shape[1] = static_cast<int>(smem);
  shape[2] = blocks;
  return static_cast<int>(err);
}

#else

// One (world, eye) as the kernel's blocks run it: the hoist, then per tile
// the cull (its keep flags to keep, (T, G), if given) and the tile's slots.
// row is the world's input row; the eye's T tiles hold width slots each:
// slot s shades ray ray[s] (s itself where ray is null, nothing where -1)
// along dirs[3 s] with weights[6 s] into out[2 r] (out: (R, 2)); tile t's
// cone is axis[4 t].
void render_eye(const float* row, int eye, const int* ray, const float* dirs,
                const float* weights, const float* axis, int T, int width, const float* radius,
                const float* rgb, int G, float ground_z, float tanh_cone, bool cone, float* out,
                uint8_t* keep, float4* H, uint16_t* list) {
  const float* opos = row + 7 * eye;
  const float* q = row + 7 * eye + 3;
  for (int g = 0; g < G; ++g) hoist_geom(H + g * kRows, opos, row + 14 + 6 * g, radius[g], rgb + 3 * g);
  for (int tile = 0; tile < T; ++tile) {
    const float* ax = axis + 4 * tile;
    float aw[3];
    rotate(q, ax, aw);
    const float reach = tile_reach(ax[3], cone, tanh_cone);
    int n = 0;
    for (int g = 0; g < G; ++g) {
      const bool k = keep_geom(H[g * kRows + kCull], aw, reach);
      if (keep != nullptr) keep[tile * G + g] = k;
      if (k) list[n++] = static_cast<uint16_t>(g);
    }
    for (int slot = tile * width; slot < (tile + 1) * width; ++slot) {
      const int r = ray == nullptr ? slot : ray[slot];
      if (r < 0) continue;
      if (cone) {
        shade_ray<true>(H, list, n, opos, q, dirs + 3 * slot, weights + 6 * slot, ground_z,
                        tanh_cone, out + 2 * r);
      } else {
        shade_ray<false>(H, list, n, opos, q, dirs + 3 * slot, weights + 6 * slot, ground_z,
                         tanh_cone, out + 2 * r);
      }
    }
  }
}

}  // namespace

// The kernel on the host: out (B, 2, R, 2) as retina_f32 gives it and, if
// keep is given, the cull's keep mask (B, 2, T, G) uint8 as
// retina_profile_f32 gives it.
extern "C" int retina_tiles_host_f32(const float* in, const int* ray, const float* tdirs,
                                     const float* tweights, const float* axis,
                                     const float* radius, const float* rgb, float* out,
                                     uint8_t* keep, int B, int R, int T, int G, float ground_z,
                                     float tanh_cone, int use_cone) {
  if (bad_args(B, R, T, G)) return 1;
  const size_t S = static_cast<size_t>(T) * kTile;
  std::vector<float4> H(static_cast<size_t>(kRows) * (G > 0 ? G : 1));
  std::vector<uint16_t> list(G > 0 ? G : 1);
  for (int world = 0; world < B; ++world) {
    for (int eye = 0; eye < 2; ++eye) {
      const size_t we = static_cast<size_t>(world) * 2 + eye;
      render_eye(eye_row(in, world, G), eye, ray + eye * S, tdirs + 3 * eye * S,
                 tweights + 6 * eye * S, axis + 4 * eye * T, T, kTile, radius, rgb, G, ground_z,
                 tanh_cone, use_cone != 0, out + we * R * 2,
                 keep == nullptr ? nullptr : keep + we * T * G, H.data(), list.data());
    }
  }
  return 0;
}

// The same hoist, cull and sweep over the rays in lattice order, dirs
// (2, R, 3) and weights (R, 2, 3), each ray a tile of its own: the tile's
// axis is the ray and its half-angle 0. out (B, 2, R, 2).
extern "C" int retina_host_f32(const float* in, const float* dirs, const float* weights,
                               const float* radius, const float* rgb, float* out, int B,
                               int R, int G, float ground_z, float tanh_cone, int use_cone) {
  if (bad_args(B, R, R, G)) return 1;
  std::vector<float> axis(static_cast<size_t>(8) * R, 0.0f);
  for (int i = 0; i < 2 * R; ++i) {
    for (int k = 0; k < 3; ++k) axis[4 * i + k] = dirs[3 * i + k];
  }
  std::vector<float4> H(static_cast<size_t>(kRows) * (G > 0 ? G : 1));
  std::vector<uint16_t> list(G > 0 ? G : 1);
  for (int world = 0; world < B; ++world) {
    for (int eye = 0; eye < 2; ++eye) {
      const size_t we = static_cast<size_t>(world) * 2 + eye;
      render_eye(eye_row(in, world, G), eye, nullptr, dirs + static_cast<size_t>(3) * eye * R,
                 weights, axis.data() + static_cast<size_t>(4) * eye * R, R, 1, radius, rgb, G,
                 ground_z, tanh_cone, use_cone != 0, out + we * R * 2, nullptr, H.data(),
                 list.data());
    }
  }
  return 0;
}

#endif
