// K1 and K2: tile-parameterized, time-tiled stencils.
//
// Replaces src/repro/kernels/pallas_stencils.py: _pass_2d/_kernel_2d (K1, the
// four 2-D stencils) and _pass_3d/_kernel_3d (K2, heat3d and laplacian3d).
// One launch advances n <= t_t steps. One block of min(t_s2, 1024) threads
// (the paper's "one threadblock of t_S2 threads per tile") runs one
// (t_s1, t_s2[, t_s3]) tile:
//   1. stage the tile's window -- the tile plus hh = h*n cells on every
//      side, clipped to the array -- in shared memory as f32;
//   2. run n steps there, between two buffers with a barrier after each;
//      a cell is updated only when its global coordinates lie inside
//      [h, s - h) on every axis (Dirichlet borders), and neighbours past the
//      window's edge repeat the edge cell (only the stale outer ring reads
//      them);
//   3. write the core tile back, only where it lies inside the array.
// Clipping to the array is exact: a window cell outside the array would be
// an edge copy of a border cell, and border cells never change.
//
// Bound: device-memory bytes. Each launch reads every input element once
// and writes every output element once (plus the re-read halo of
// neighbouring windows); the n steps in between touch only shared memory,
// so a deeper time tile moves the same bytes per launch for n times the
// work. That is this design's answer to the bound: a pass costs one round
// trip to device memory whatever n is. The loads walk the window's fastest
// axis across consecutive threads, so they coalesce.
// Shared memory: 2 * 4 * window cells bytes, at most 232,448 on sm_90; the
// Python wrapper refuses larger windows before launch.
// `k` (tiles per SM) changes no value and is not a launch parameter here.
#include "stencil_bodies.cuh"

struct Geom {
  int s1, s2, s3;  // array extents (s3 = 1 in 2-D)
  int t1, t2, t3;  // tile extents (t3 = 1 in 2-D)
  int n, h;        // steps this pass, stencil radius
};

template <typename T, int S, int DIMS>
__global__ void tiled_kernel(const T* __restrict__ x, T* __restrict__ out, Geom g) {
  extern __shared__ float smem[];
  const int g2 = (g.s2 + g.t2 - 1) / g.t2;
  const int g3 = (g.s3 + g.t3 - 1) / g.t3;
  int b = blockIdx.x;
  const int i3 = b % g3;
  b /= g3;
  const int i2 = b % g2;
  const int i1 = b / g2;
  const int hh = g.h * g.n;
  const int hh3 = DIMS == 3 ? hh : 0;
  const int o1 = i1 * g.t1, o2 = i2 * g.t2, o3 = i3 * g.t3;
  const int lo1 = max(o1 - hh, 0), lo2 = max(o2 - hh, 0), lo3 = max(o3 - hh3, 0);
  const int e1 = min(o1 + g.t1 + hh, g.s1) - lo1;
  const int e2 = min(o2 + g.t2 + hh, g.s2) - lo2;
  const int e3 = min(o3 + g.t3 + hh3, g.s3) - lo3;
  const int cells = e1 * e2 * e3;
  float* cur = smem;
  float* nxt = smem + cells;

  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int m = c % e3, r = c / e3, j = r % e2, i = r / e2;
    cur[c] = load_f(x, ((long long)(lo1 + i) * g.s2 + (lo2 + j)) * g.s3 + (lo3 + m));
  }
  __syncthreads();

  for (int step = 0; step < g.n; ++step) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const int m = c % e3, r = c / e3, j = r % e2, i = r / e2;
      const int gi = lo1 + i, gj = lo2 + j, gm = lo3 + m;
      bool active = gi >= g.h && gi < g.s1 - g.h && gj >= g.h && gj < g.s2 - g.h;
      if constexpr (DIMS == 3) active = active && gm >= g.h && gm < g.s3 - g.h;
      float v = cur[c];
      if (active) {
        const int iu = max(i - g.h, 0), id = min(i + g.h, e1 - 1);
        const int jn = max(j - g.h, 0), js = min(j + g.h, e2 - 1);
        if constexpr (DIMS == 2) {
          v = update2d<S>(v, cur[iu * e2 + j], cur[id * e2 + j], cur[i * e2 + jn], cur[i * e2 + js]);
        } else {
          const int mw = max(m - g.h, 0), me = min(m + g.h, e3 - 1);
          v = update3d<S>(v, cur[(iu * e2 + j) * e3 + m], cur[(id * e2 + j) * e3 + m],
                          cur[(i * e2 + jn) * e3 + m], cur[(i * e2 + js) * e3 + m],
                          cur[(i * e2 + j) * e3 + mw], cur[(i * e2 + j) * e3 + me]);
        }
      }
      nxt[c] = v;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  const int c1 = min(g.t1, g.s1 - o1), c2 = min(g.t2, g.s2 - o2), c3 = min(g.t3, g.s3 - o3);
  const int core = c1 * c2 * c3;
  for (int c = threadIdx.x; c < core; c += blockDim.x) {
    const int m = c % c3, r = c / c3, j = r % c2, i = r / c2;
    const int w = ((o1 - lo1 + i) * e2 + (o2 - lo2 + j)) * e3 + (o3 - lo3 + m);
    store_f(out, ((long long)(o1 + i) * g.s2 + (o2 + j)) * g.s3 + (o3 + m), cur[w]);
  }
}

template <typename T, int S, int DIMS>
static int launch(const void* x, void* out, Geom g, long long smem, void* stream) {
  auto kernel = tiled_kernel<T, S, DIMS>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (long long)((g.s1 + g.t1 - 1) / g.t1) * ((g.s2 + g.t2 - 1) / g.t2) *
                           ((g.s3 + g.t3 - 1) / g.t3);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int threads = g.t2 < 1024 ? g.t2 : 1024;
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(x), static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <int S, int DIMS>
static int dispatch_dtype(int dtype, const void* x, void* out, Geom g, long long smem, void* stream) {
  if (dtype == F32) return launch<float, S, DIMS>(x, out, g, smem, stream);
  if (dtype == BF16) return launch<__nv_bfloat16, S, DIMS>(x, out, g, smem, stream);
  return cudaErrorInvalidValue;
}

extern "C" int repro_tiled2d(const void* x, void* out, int dtype, int stencil, int s1, int s2, int t1, int t2,
                             int n, int h, long long smem, void* stream) {
  const Geom g{s1, s2, 1, t1, t2, 1, n, h};
  switch (stencil) {
    case JACOBI2D: return dispatch_dtype<JACOBI2D, 2>(dtype, x, out, g, smem, stream);
    case HEAT2D: return dispatch_dtype<HEAT2D, 2>(dtype, x, out, g, smem, stream);
    case LAPLACIAN2D: return dispatch_dtype<LAPLACIAN2D, 2>(dtype, x, out, g, smem, stream);
    case GRADIENT2D: return dispatch_dtype<GRADIENT2D, 2>(dtype, x, out, g, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int repro_tiled3d(const void* x, void* out, int dtype, int stencil, int s1, int s2, int s3, int t1,
                             int t2, int t3, int n, int h, long long smem, void* stream) {
  const Geom g{s1, s2, s3, t1, t2, t3, n, h};
  switch (stencil) {
    case HEAT3D: return dispatch_dtype<HEAT3D, 3>(dtype, x, out, g, smem, stream);
    case LAPLACIAN3D: return dispatch_dtype<LAPLACIAN3D, 3>(dtype, x, out, g, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}
