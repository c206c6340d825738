// K3 and K4: one Dirichlet step of a stencil over the whole array.
//
// Replaces src/repro/kernels/stencil_common.py: stencil2d_call/_stencil2d_kernel
// (K3) and stencil3d_call/_stencil3d_kernel (K4). A 2-D grid of blocks:
// blockIdx.x picks COLS consecutive columns (3-D: COLS consecutive positions
// of the flattened (h, w) plane), blockIdx.y a band of block_rows rows
// (3-D: planes). Each thread walks its column down the band; a border cell
// is copied through unchanged, any other cell reads its neighbours from
// device memory (through L1/L2), computes in f32 and stores in the input
// dtype.
//
// Bound: device-memory bytes. Each launch must read every input element
// once and write every output element once. Consecutive threads touch
// consecutive addresses, so every load and store coalesces; the
// neighbours above and below (3-D: in the planes before and after) were
// loaded by the same block a row earlier and come from L1/L2, not from
// device memory again. Nothing is staged in shared memory.
#include "stencil_bodies.cuh"

constexpr int COLS = 128;  // repro_torch/kernels/stencil_common.py BLOCK_COLS

template <typename T, int S>
__global__ void step2d_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int width, int h,
                              int block_rows) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  if (col >= width) return;
  const int r0 = blockIdx.y * block_rows;
  const int r1 = min(r0 + block_rows, rows);
  for (int r = r0; r < r1; ++r) {
    const long long i = (long long)r * width + col;
    if (r < h || r >= rows - h || col < h || col >= width - h) {
      out[i] = x[i];
      continue;
    }
    const long long dr = (long long)h * width;
    store_f(out, i, update2d<S>(load_f(x, i), load_f(x, i - dr), load_f(x, i + dr), load_f(x, i - h),
                                load_f(x, i + h)));
  }
}

template <typename T, int S>
__global__ void step3d_kernel(const T* __restrict__ x, T* __restrict__ out, int depth, int hgt, int wid, int h,
                              int block_rows) {
  const int plane = hgt * wid;
  const int q = blockIdx.x * COLS + threadIdx.x;
  if (q >= plane) return;
  const int row = q / wid, col = q % wid;
  const int p0 = blockIdx.y * block_rows;
  const int p1 = min(p0 + block_rows, depth);
  const bool edge = row < h || row >= hgt - h || col < h || col >= wid - h;
  for (int p = p0; p < p1; ++p) {
    const long long i = (long long)p * plane + q;
    if (edge || p < h || p >= depth - h) {
      out[i] = x[i];
      continue;
    }
    const long long dp = (long long)h * plane, dr = (long long)h * wid;
    store_f(out, i, update3d<S>(load_f(x, i), load_f(x, i - dp), load_f(x, i + dp), load_f(x, i - dr),
                                load_f(x, i + dr), load_f(x, i - h), load_f(x, i + h)));
  }
}

template <typename T, int S>
static int launch2d(const void* x, void* out, int rows, int width, int h, int block_rows, void* stream) {
  const dim3 grid((width + COLS - 1) / COLS, (rows + block_rows - 1) / block_rows);
  step2d_kernel<T, S><<<grid, COLS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, width, h, block_rows);
  return cudaGetLastError();
}

template <typename T, int S>
static int launch3d(const void* x, void* out, int d, int hgt, int wid, int h, int block_rows, void* stream) {
  const dim3 grid((hgt * wid + COLS - 1) / COLS, (d + block_rows - 1) / block_rows);
  step3d_kernel<T, S><<<grid, COLS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), d, hgt, wid, h, block_rows);
  return cudaGetLastError();
}

#define STEP2D_CASE(S)                                                                        \
  case S:                                                                                     \
    if (dtype == F32) return launch2d<float, S>(x, out, rows, width, h, block_rows, stream); \
    if (dtype == BF16) return launch2d<__nv_bfloat16, S>(x, out, rows, width, h, block_rows, stream); \
    return cudaErrorInvalidValue;

#define STEP3D_CASE(S)                                                                         \
  case S:                                                                                      \
    if (dtype == F32) return launch3d<float, S>(x, out, d, hgt, wid, h, block_rows, stream);  \
    if (dtype == BF16) return launch3d<__nv_bfloat16, S>(x, out, d, hgt, wid, h, block_rows, stream); \
    return cudaErrorInvalidValue;

extern "C" int repro_step2d(const void* x, void* out, int dtype, int stencil, int rows, int width, int h,
                            int block_rows, void* stream) {
  switch (stencil) {
    STEP2D_CASE(JACOBI2D)
    STEP2D_CASE(HEAT2D)
    STEP2D_CASE(LAPLACIAN2D)
    STEP2D_CASE(GRADIENT2D)
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int repro_step3d(const void* x, void* out, int dtype, int stencil, int d, int hgt, int wid, int h,
                            int block_rows, void* stream) {
  switch (stencil) {
    STEP3D_CASE(HEAT3D)
    STEP3D_CASE(LAPLACIAN3D)
    default: return cudaErrorInvalidValue;
  }
}
