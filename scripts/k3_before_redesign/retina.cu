// The retina kernel K3 as it stood before its redesign for the H100
// (flygym_tpu_torch/csrc/retina.cu now): one thread block per (world, eye),
// one thread per ray in lattice order, every ray sweeping every geom. Kept
// as the yardstick of the redesign, which must give the same outputs to the
// last bit and is timed against it. Its entry points are renamed
// retina_before_f32 (CUDA) and retina_before_host_f32 (host C++, g++);
// flygym_tpu_torch/ops/_build.py builds them (build_retina(source=...),
// build_retina_host(source)), chip_smoke.py (phase 7) holds and times the
// card build against the shipped one, and tests/test_torch_retina_cull.py the
// host build. Its text below is otherwise the old kernel's.
//
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
// Design. One thread block per (world, eye): grid 2B, one thread per ray
// (721 rays in 736 threads, 23 warps). The block first computes, for its
// eye, the per-geom quantities that do not depend on the ray (segment,
// axis, the quadratic's ray-free terms, the cone branch's inside-the-geom
// gate; retina_pallas.py:146-177) into shared memory, kHoist floats per
// geom, thread g doing geom g. Then each thread sweeps the G geoms for its
// ray; every thread of the block reads the same shared address, a
// broadcast. Ray directions and channel weights come from global memory
// through the read-only cache; radius and colour per geom are runtime
// arrays, so the kernel is model-independent and joins the library of
// flygym_tpu_torch/ops/_build.py:build. The output is written straight in
// (B, eye, ray, channel) order.
//
// What bounds it on the H100: operations. Each (world, eye, ray) sweeps G
// geoms at ~80 fp32 operations each (cone branch), ~3e10 operations at 4096
// worlds against ~7 MB read and ~47 MB written. Left for later: several
// rays per thread, geoms culled per eye, fewer registers for occupancy.
//
// Numerics. The body is the Pallas kernel's arithmetic, term for term and
// in the same order: built with -fmad=false and IEEE div and sqrt, it
// repeats retina_plain to the last bit wherever no silhouette or checker
// edge flips on an ulp. jnp.mod is a floored modulo (x - 2 floor(x / 2)
// here, exact on the integer-valued checker sums); ties keep the kernel's
// rules: a geom replaces the nearest hit only if strictly nearer (the
// ground plane is entered first), the sky is index -2 and the ground -1,
// and a geom's coverage replaces the running one only if strictly larger.
// fmaxf/fminf differ from jnp.maximum/minimum only on NaN, which finite
// inputs do not produce (a sphere's zero-length segment is carried by the
// 1e-12 guards).
//
// The same file compiles as host C++ (g++ -x c++), where the blocks become
// loops over worlds, eyes and rays (retina_host_f32), so the arithmetic is
// tested on the CPU against the plain version.
//
// Interface: plain C, bound with ctypes (flygym_tpu_torch/ops/_build.py).
// Pointers are device pointers; the kernel allocates nothing, launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().
//
// Arrays (float32, C order):
//   in       (B, 14 + 6G)  per world: eye 0 pos (3), quat wxyz (4); eye 1
//                          pos, quat; then per geom p0 (3), p1 (3) in world
//   dirs     (2, R, 3)     ray directions in each eye's body frame
//   weights  (R, 2, 3)     rgb weights of the two channels per ray
//   radius   (G,)          capsule / sphere radius
//   rgb      (G, 3)        colour
//   out      (B, 2, R, 2)  intensities

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RT_FN __host__ __device__ __forceinline__
#else
#include <math.h>

#include <vector>
#define RT_FN inline
#endif

namespace {

constexpr float kBig = 1e30f;
// Threads per block: the rays rounded up to whole warps, at most this many
// (a block loops over the rays beyond it). 768 threads leave a thread up to
// 85 registers.
constexpr int kMaxThreads = 768;
constexpr int kMaxGeoms = 512;  // kHoist * 512 * 4 bytes fits 48 KB of shared memory

// Hoisted per-geom rows, each G floats long.
enum Hoist {
  kP0x, kP0y, kP0z, kBax, kBay, kBaz, kOax, kOay, kOaz, kObx, kOby, kObz,
  kBaba, kBaoa, kCcyl, kCs0, kCs1, kOutside, kIbaba, kR, kColR, kColG, kColB,
  kHoist
};

RT_FN float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// The checker's floored modulo by 2 (jnp.mod).
RT_FN float mod2(float x) { return x - 2.0f * floorf(x / 2.0f); }

// Geom g's ray-free quantities for an eye at opos (retina_pallas.py:146-177).
RT_FN void hoist_geom(float* H, int G, int g, const float* opos, const float* seg,
                      float r, const float* col) {
  const float p0[3] = {seg[0], seg[1], seg[2]};
  const float p1[3] = {seg[3], seg[4], seg[5]};
  float ba[3], oa[3], ob[3];
  for (int k = 0; k < 3; ++k) {
    ba[k] = p1[k] - p0[k];
    oa[k] = opos[k] - p0[k];
    ob[k] = opos[k] - p1[k];
  }
  const float baba = ba[0] * ba[0] + ba[1] * ba[1] + ba[2] * ba[2];
  const float baoa = ba[0] * oa[0] + ba[1] * oa[1] + ba[2] * oa[2];
  const float oaoa = oa[0] * oa[0] + oa[1] * oa[1] + oa[2] * oa[2];
  const float obob = ob[0] * ob[0] + ob[1] * ob[1] + ob[2] * ob[2];
  const float rr = r * r;
  const float s0g = clip01(baoa / fmaxf(baba, 1e-12f));
  const float d0sq = oaoa - 2.0f * s0g * baoa + s0g * s0g * baba;
  for (int k = 0; k < 3; ++k) {
    H[(kP0x + k) * G + g] = p0[k];
    H[(kBax + k) * G + g] = ba[k];
    H[(kOax + k) * G + g] = oa[k];
    H[(kObx + k) * G + g] = ob[k];
    H[(kColR + k) * G + g] = col[k];
  }
  H[kBaba * G + g] = baba;
  H[kBaoa * G + g] = baoa;
  H[kCcyl * G + g] = baba * oaoa - baoa * baoa - rr * baba;
  H[kCs0 * G + g] = oaoa - rr;
  H[kCs1 * G + g] = obob - rr;
  H[kOutside * G + g] = d0sq > rr ? 1.0f : 0.0f;
  H[kIbaba * G + g] = 1.0f / fmaxf(baba, 1e-12f);
  H[kR * G + g] = r;
}

// One ray: nearest hit, shading, channel weights (retina_pallas.py:179-396).
// d is the ray in the eye frame, w (2, 3) its channel weights; the two
// intensities go to out[0] and out[1].
template <bool kCone>
RT_FN void shade_ray(const float* H, int G, const float* opos, const float* q,
                     const float* d, const float* w, float ground_z, float tanh_cone,
                     float* out) {
  const float dx = d[0], dy = d[1], dz = d[2];
  const float w_ = q[0], x_ = q[1], y_ = q[2], z_ = q[3];
  const float tx = 2.0f * (y_ * dz - z_ * dy);
  const float ty = 2.0f * (z_ * dx - x_ * dz);
  const float tz = 2.0f * (x_ * dy - y_ * dx);
  const float rdx = dx + w_ * tx + (y_ * tz - z_ * ty);
  const float rdy = dy + w_ * ty + (z_ * tx - x_ * tz);
  const float rdz = dz + w_ * tz + (x_ * ty - y_ * tx);

  float t_min = kBig, idx = -2.0f;
  float wp0[3] = {0.0f, 0.0f, 0.0f}, wba[3] = {0.0f, 0.0f, 0.0f}, w_ibaba = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;

  // Ground plane.
  const float oz = opos[2];
  const float tp = (ground_z - oz) / (fabsf(rdz) < 1e-12f ? 1e-12f : rdz);
  const bool hitp = (tp > 0.0f) && (fabsf(rdz) > 1e-12f);
  if (hitp) {
    t_min = tp;
    idx = -1.0f;
  }
  float t_bg = kBig, bg_r = 0.0f, bg_g = 0.0f, bg_b = 0.0f;
  float cov = 0.0f, cov_r = 0.0f, cov_g = 0.0f, cov_b = 0.0f;
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

  for (int g = 0; g < G; ++g) {
    const float bax = H[kBax * G + g], bay = H[kBay * G + g], baz = H[kBaz * G + g];
    const float oax = H[kOax * G + g], oay = H[kOay * G + g], oaz = H[kOaz * G + g];
    const float baba = H[kBaba * G + g], baoa = H[kBaoa * G + g];
    const float bard = bax * rdx + bay * rdy + baz * rdz;
    const float rdoa = oax * rdx + oay * rdy + oaz * rdz;
    const float a_ = baba - bard * bard;
    const float b_ = baba * rdoa - baoa * bard;
    const float h_ = b_ * b_ - a_ * H[kCcyl * G + g];
    const float safe_a = fabsf(a_) < 1e-12f ? 1e-12f : a_;
    const float t_cyl = (-b_ - sqrtf(fmaxf(h_, 0.0f))) / safe_a;
    const float y_c = baoa + t_cyl * bard;
    const bool cyl_ok = (h_ >= 0.0f) && (y_c > 0.0f) && (y_c < baba) && (t_cyl > 0.0f);
    // Endpoint spheres.
    const float b_s0 = rdoa;
    const float h_s0 = b_s0 * b_s0 - H[kCs0 * G + g];
    float t_s0 = -b_s0 - sqrtf(fmaxf(h_s0, 0.0f));
    t_s0 = (h_s0 >= 0.0f && t_s0 > 0.0f) ? t_s0 : kBig;
    const float b_s1 = H[kObx * G + g] * rdx + H[kOby * G + g] * rdy + H[kObz * G + g] * rdz;
    const float h_s1 = b_s1 * b_s1 - H[kCs1 * G + g];
    float t_s1 = -b_s1 - sqrtf(fmaxf(h_s1, 0.0f));
    t_s1 = (h_s1 >= 0.0f && t_s1 > 0.0f) ? t_s1 : kBig;
    const float t_g = cyl_ok ? t_cyl : fminf(t_s0, t_s1);
    if (t_g < t_min) {
      t_min = t_g;
      idx = static_cast<float>(g);
      wp0[0] = H[kP0x * G + g];
      wp0[1] = H[kP0y * G + g];
      wp0[2] = H[kP0z * G + g];
      wba[0] = bax;
      wba[1] = bay;
      wba[2] = baz;
      w_ibaba = H[kIbaba * G + g];
      cr = H[kColR * G + g];
      cg = H[kColG * G + g];
      cb = H[kColB * G + g];
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
      float c_g2 = clip01(0.5f - 0.5f * (dperp - H[kR * G + g]) / width);
      c_g2 = c_g2 * H[kOutside * G + g];
      c_g2 = tc < t_bg ? c_g2 : 0.0f;
      if (c_g2 > cov) {
        cov = c_g2;
        cov_r = H[kColR * G + g];
        cov_g = H[kColG * G + g];
        cov_b = H[kColB * G + g];
      }
    }
  }

  // The winner's normal, from its carried segment.
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
  const bool is_geom = idx >= 0.0f;
  const float nx = is_geom ? dx_ * inv_n : 0.0f;
  const float ny = is_geom ? dy_ * inv_n : 0.0f;
  const float nz = is_geom ? dz_ * inv_n : 1.0f;
  const float lam = fabsf(-(nx * rdx + ny * rdy + nz * rdz));
  if (kCone) {
    // Coverage blend: the shaded nearest geom where the ray hits, half its
    // colour for a near-miss, mixed with the background by coverage.
    const float gshade = 0.5f + 0.5f * lam;
    const float g_r = is_geom ? cr * gshade : 0.5f * cov_r;
    const float g_g = is_geom ? cg * gshade : 0.5f * cov_g;
    const float g_b = is_geom ? cb * gshade : 0.5f * cov_b;
    cr = clip01(cov * g_r + (1.0f - cov) * bg_r);
    cg = clip01(cov * g_g + (1.0f - cov) * bg_g);
    cb = clip01(cov * g_b + (1.0f - cov) * bg_b);
  } else {
    const bool is_ground = idx == -1.0f;
    const bool is_sky = idx == -2.0f;
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

RT_FN bool bad_args(int B, int R, int G) {
  return B <= 0 || R <= 0 || G < 0 || G > kMaxGeoms;
}

#ifdef __CUDACC__

template <bool kCone>
__global__ void __launch_bounds__(kMaxThreads)
retina_kernel(const float* __restrict__ in, const float* __restrict__ dirs,
              const float* __restrict__ weights, const float* __restrict__ radius,
              const float* __restrict__ rgb, float* __restrict__ out, int R, int G,
              float ground_z, float tanh_cone) {
  extern __shared__ float H[];  // (kHoist, G)
  const int world = blockIdx.x >> 1;
  const int eye = blockIdx.x & 1;
  const float* row = in + static_cast<size_t>(world) * (14 + 6 * G);
  const float opos[3] = {__ldg(row + 7 * eye), __ldg(row + 7 * eye + 1), __ldg(row + 7 * eye + 2)};
  const float q[4] = {__ldg(row + 7 * eye + 3), __ldg(row + 7 * eye + 4),
                      __ldg(row + 7 * eye + 5), __ldg(row + 7 * eye + 6)};
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float seg[6], col[3];
    for (int k = 0; k < 6; ++k) seg[k] = __ldg(row + 14 + 6 * g + k);
    for (int k = 0; k < 3; ++k) col[k] = __ldg(rgb + 3 * g + k);
    hoist_geom(H, G, g, opos, seg, __ldg(radius + g), col);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float* dp = dirs + (static_cast<size_t>(eye) * R + r) * 3;
    const float d[3] = {__ldg(dp), __ldg(dp + 1), __ldg(dp + 2)};
    float w[6];
    for (int k = 0; k < 6; ++k) w[k] = __ldg(weights + 6 * r + k);
    float o[2];
    shade_ray<kCone>(H, G, opos, q, d, w, ground_z, tanh_cone, o);
    float2* dst = reinterpret_cast<float2*>(out) + (static_cast<size_t>(blockIdx.x) * R + r);
    *dst = make_float2(o[0], o[1]);
  }
}

}  // namespace

extern "C" int retina_before_f32(const void* in, const void* dirs, const void* weights,
                                 const void* radius, const void* rgb, void* out, int B,
                                 int R, int G, float ground_z, float tanh_cone,
                                 int use_cone, void* stream) {
  if (bad_args(B, R, G)) return cudaErrorInvalidValue;
  const int threads = R < kMaxThreads ? ((R + 31) / 32) * 32 : kMaxThreads;
  const size_t smem = sizeof(float) * kHoist * (G > 0 ? G : 1);
  const dim3 grid(2 * B);
  auto launch = use_cone ? retina_kernel<true> : retina_kernel<false>;
  launch<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(dirs),
      static_cast<const float*>(weights), static_cast<const float*>(radius),
      static_cast<const float*>(rgb), static_cast<float*>(out), R, G, ground_z, tanh_cone);
  return static_cast<int>(cudaGetLastError());
}

#else

}  // namespace

extern "C" int retina_before_host_f32(const float* in, const float* dirs,
                                      const float* weights, const float* radius,
                                      const float* rgb, float* out, int B, int R, int G,
                                      float ground_z, float tanh_cone, int use_cone) {
  if (bad_args(B, R, G)) return 1;
  std::vector<float> H(static_cast<size_t>(kHoist) * (G > 0 ? G : 1));
  for (int world = 0; world < B; ++world) {
    const float* row = in + static_cast<size_t>(world) * (14 + 6 * G);
    for (int eye = 0; eye < 2; ++eye) {
      const float* opos = row + 7 * eye;
      const float* q = row + 7 * eye + 3;
      for (int g = 0; g < G; ++g) {
        hoist_geom(H.data(), G, g, opos, row + 14 + 6 * g, radius[g], rgb + 3 * g);
      }
      for (int r = 0; r < R; ++r) {
        const float* d = dirs + (static_cast<size_t>(eye) * R + r) * 3;
        float* o = out + ((static_cast<size_t>(world) * 2 + eye) * R + r) * 2;
        if (use_cone) {
          shade_ray<true>(H.data(), G, opos, q, d, weights + 6 * r, ground_z, tanh_cone, o);
        } else {
          shade_ray<false>(H.data(), G, opos, q, d, weights + 6 * r, ground_z, tanh_cone, o);
        }
      }
    }
  }
  return 0;
}

#endif
