// Update bodies of the six stencils, shared by every kernel of this folder.
//
// Each body keeps the operation order of the stencil's plain torch `update`
// (repro_torch/kernels/<name>.py), left to right. The sources are built with
// `--fmad=false` (see _build.py): no multiply-add is contracted, so every
// operation is rounded where the plain version rounds it and, on the same
// inputs, a kernel's f32 result matches the plain version run on the card
// bit for bit. The tolerances held against the JAX reference stay those of
// its own tests (1e-5 for one f32 step, rtol 1e-4 with an absolute slack of
// rtol x field magnitude for multi-step runs, 2e-2 for bf16), since XLA on
// the CPU may round in another order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Ids passed by the Python wrappers: STENCIL_IDS and DTYPE_IDS in _build.py.
enum StencilId { JACOBI2D = 0, HEAT2D = 1, LAPLACIAN2D = 2, GRADIENT2D = 3, HEAT3D = 4, LAPLACIAN3D = 5 };
enum DtypeId { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) { p[i] = __float2bfloat16(v); }

// 2-D 5-point bodies: c centre, n/s the rows above/below, w/e the columns left/right.
template <int S>
__device__ __forceinline__ float update2d(float c, float n, float s, float w, float e) {
  if constexpr (S == JACOBI2D) {
    return 0.2f * ((((c + n) + s) + e) + w);
  } else if constexpr (S == HEAT2D) {
    return c + 0.125f * ((((n + s) + e) + w) - 4.0f * c);
  } else if constexpr (S == LAPLACIAN2D) {
    return (((n + s) + e) + w) - 4.0f * c;
  } else {
    static_assert(S == GRADIENT2D, "not a 2-D stencil");
    const float gx = 0.5f * (e - w);
    const float gy = 0.5f * (s - n);
    return sqrtf(gx * gx + gy * gy);
  }
}

// 3-D 7-point bodies: u/d along axis 0, n/s along axis 1, w/e along axis 2.
template <int S>
__device__ __forceinline__ float update3d(float c, float u, float d, float n, float s, float w, float e) {
  if constexpr (S == HEAT3D) {
    return c + 0.125f * ((((((u + d) + n) + s) + e) + w) - 6.0f * c);
  } else {
    static_assert(S == LAPLACIAN3D, "not a 3-D stencil");
    return (((((u + d) + n) + s) + e) + w) - 6.0f * c;
  }
}

// Shared by both libraries: the message of a code an entry point returned.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
