// Tree-sparse LDL^T factor and solve of the contact Hessian, one thread per
// world, for NVIDIA Hopper (sm_90a).
//
// What each function replaces (TPU kernels of the JAX package):
//   tree_ldl_factor_f32  ->  flygym_tpu/ops/ldl_pallas.py  _factor_kernel
//                            (launched by _factor_batched_pallas)
//   tree_ldl_solve_f32   ->  flygym_tpu/ops/ldl_pallas.py  _solve_kernel
//                            (launched by _solve_batched_pallas)
// Their plain PyTorch versions, used for CPU tensors and as the oracle on the
// card, are flygym_tpu_torch/engine/linalg.py tree_ldl_factor/tree_ldl_solve.
//
// The work is a chain of dependent scalar updates per world over static
// index tables: DoFs are eliminated leaves-first (the height levels,
// concatenated), and DoF i's row downdates the ancestor block of its
// ancestor chain. There is no tile and no block-level reduction, so each
// thread owns one world and walks the tables, which every thread of a warp
// reads at the same address (a broadcast).
//
// What bounds it on the H100: memory. The working copy of H is 72*72*4 =
// 20.7 KB per world, about 85 MB at 4096 worlds, against a 50 MB L2, and the
// factor reads and writes its lower triangle several times. The working
// copy, L, d, b and x are world-minor ((rows, B), world index fastest), so a
// warp's access to one entry is one coalesced 128-byte line.
//
// What this simple design leaves for later: holding a world's H in shared
// memory (20.7 KB per world allows only ~10 worlds per SM), or one warp per
// world that eliminates the leaves of a height level in parallel.
//
// Interface: plain C, bound with ctypes (flygym_tpu_torch/ops/_build.py).
// Pointers are device pointers; the kernels allocate nothing, launch on the
// caller's stream, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChain = 64;  // longest ancestor chain a model may have

// A (nv*nv, B): working copy of H, destroyed. L (nv*maxc, B), d (nv, B).
__global__ void __launch_bounds__(kThreads)
factor_kernel(float* __restrict__ A, float* __restrict__ L,
              float* __restrict__ d, const int* __restrict__ order,
              const int* __restrict__ chain_ptr,
              const int* __restrict__ chain_idx, int nv, int maxc, int B) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  const size_t sB = static_cast<size_t>(B);
  float rows[kMaxChain];  // row i of A over i's ancestor chain

  for (int k = 0; k < nv; ++k) {
    const int i = order[k];
    const int c0 = chain_ptr[i];
    const int n = chain_ptr[i + 1] - c0;
    const float di = A[(static_cast<size_t>(i) * nv + i) * sB + w];
    d[static_cast<size_t>(i) * sB + w] = di;
    const float inv_d = 1.0f / di;
    for (int c = 0; c < n; ++c) {
      rows[c] = A[(static_cast<size_t>(i) * nv + chain_idx[c0 + c]) * sB + w];
    }
    for (int ca = 0; ca < n; ++ca) {
      const float li = rows[ca] * inv_d;
      L[(static_cast<size_t>(i) * maxc + ca) * sB + w] = li;
      // Downdate row a of the ancestor block. Only the lower triangle
      // (b ancestor-or-self of a) is read later, so only it is written.
      float* row_a = A + static_cast<size_t>(chain_idx[c0 + ca]) * nv * sB + w;
      for (int cb = 0; cb <= ca; ++cb) {
        row_a[static_cast<size_t>(chain_idx[c0 + cb]) * sB] -= li * rows[cb];
      }
    }
    for (int c = n; c < maxc; ++c) {
      L[(static_cast<size_t>(i) * maxc + c) * sB + w] = 0.0f;
    }
  }
}

// L (nv*maxc, B), d (nv, B), b (nv, B) -> x (nv, B).
__global__ void __launch_bounds__(kThreads)
solve_kernel(const float* __restrict__ L, const float* __restrict__ d,
             const float* __restrict__ b, float* __restrict__ x,
             const int* __restrict__ height_order,
             const int* __restrict__ depth_order,
             const int* __restrict__ chain_ptr,
             const int* __restrict__ chain_idx, int nv, int maxc, int B) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  const size_t sB = static_cast<size_t>(B);
  for (int i = 0; i < nv; ++i) x[i * sB + w] = b[i * sB + w];

  // Pass 1, leaves -> root: y_i is final, push it to the ancestors.
  for (int k = 0; k < nv; ++k) {
    const int i = height_order[k];
    const int c0 = chain_ptr[i];
    const int n = chain_ptr[i + 1] - c0;
    const float yi = x[i * sB + w];
    for (int c = 0; c < n; ++c) {
      x[chain_idx[c0 + c] * sB + w] -=
          L[(static_cast<size_t>(i) * maxc + c) * sB + w] * yi;
    }
  }
  // The diagonal.
  for (int i = 0; i < nv; ++i) x[i * sB + w] /= d[i * sB + w];
  // Pass 2, root -> leaves: gather from the final ancestors.
  for (int k = 0; k < nv; ++k) {
    const int i = depth_order[k];
    const int c0 = chain_ptr[i];
    const int n = chain_ptr[i + 1] - c0;
    float acc = x[i * sB + w];
    for (int c = 0; c < n; ++c) {
      acc -= L[(static_cast<size_t>(i) * maxc + c) * sB + w] *
             x[chain_idx[c0 + c] * sB + w];
    }
    x[i * sB + w] = acc;
  }
}

inline dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int tree_ldl_factor_f32(void* A, void* L, void* d,
                                   const void* order, const void* chain_ptr,
                                   const void* chain_idx, int nv, int maxc,
                                   int B, void* stream) {
  if (maxc > kMaxChain || nv <= 0 || B <= 0) return cudaErrorInvalidValue;
  factor_kernel<<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(A), static_cast<float*>(L), static_cast<float*>(d),
      static_cast<const int*>(order), static_cast<const int*>(chain_ptr),
      static_cast<const int*>(chain_idx), nv, maxc, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tree_ldl_solve_f32(const void* L, const void* d, const void* b,
                                  void* x, const void* height_order,
                                  const void* depth_order,
                                  const void* chain_ptr, const void* chain_idx,
                                  int nv, int maxc, int B, void* stream) {
  if (maxc > kMaxChain || nv <= 0 || B <= 0) return cudaErrorInvalidValue;
  solve_kernel<<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(d),
      static_cast<const float*>(b), static_cast<float*>(x),
      static_cast<const int*>(height_order), static_cast<const int*>(depth_order),
      static_cast<const int*>(chain_ptr), static_cast<const int*>(chain_idx), nv,
      maxc, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
