// K1 and K2: tile-parameterized, time-tiled stencils.
//
// Replaces src/repro/kernels/pallas_stencils.py: _pass_2d/_kernel_2d (K1, the
// four 2-D stencils) and _pass_3d/_kernel_3d (K2, heat3d and laplacian3d).
// One launch advances n <= t_t steps. One block of min(t_s2, 1024) threads
// (the time model's "one threadblock of t_S2 threads per tile") runs one
// (t_s1, t_s2[, t_s3]) tile from its window: the tile plus hh = h*n cells on
// every side, clipped to the array. Clipping is exact: a cell outside the
// array would be an edge copy of a border cell, and border cells never
// change. A cell is updated only when its global coordinates lie inside
// [h, s - h) on every axis (Dirichlet borders).
//
// Bound: device-memory bytes. A launch must read every input element once
// and write every output element once; the n steps in between touch only
// shared memory, so a pass costs one round trip to device memory whatever n
// is. The design, for Hopper:
//   * No division in a per-cell loop. Cells are dealt to threads in
//     row-major order over a rectangle (for_cells); the (row, column) pair
//     advances by a step fixed per rectangle, computed with the only two
//     divisions, before the loop. Every lane has work until the last round.
//   * Trapezoid steps. Step s (1-based) of an n-step pass updates only the
//     core widened by h*(n-s) on each side, clipped to the window: no other
//     cell is read by a cell the core needs. Step n writes the core from
//     registers straight to device memory (no shared-memory store, no
//     barrier). Inside the trapezoid no read leaves the window, so no
//     neighbour index is clamped.
//   * 16-byte staging. A window row is copied in 16-byte units aligned in
//     device memory: f32 by cp.async (16 bytes, through L2 only), bf16 by
//     16-byte read-only loads of 8 values converted to f32; only a row's
//     unaligned head and tail go element by element. Shared memory holds f32.
//     Its rows are laid out so that every row starts at the same element
//     offset modulo 4 as its source (a pitch equal to the array's fastest
//     extent modulo 4, the base shifted by the source's own offset), so
//     both ends of a 16-byte copy are aligned.
//   * K1 (2-D) stages the whole window at once, all copies in flight
//     together, and steps it between two buffers with one barrier per step.
//     Its windows are small (10,912 B at tiles (16, 64, t_t=2)), so the
//     whole-window copy keeps many bytes in flight per SM. Streaming rows
//     would deal rows of t_s2 + 2h(n-s) cells to t_s2 threads: two rounds
//     for little more than one round of work.
//   * K2 (3-D) streams the window along axis 0, plane by plane (planes of
//     e2 x e3 cells): wavefront temporal blocking. Time level s keeps a ring
//     of 2h+1 planes; level s computes plane t - s*h once level s-1 holds
//     planes t - s*h -+ h; level n goes to device memory. Level 0 has one
//     more plane, which the next plane's cp.async fills while the current
//     one computes. Shared memory falls from two copies of the whole window
//     to (2h+1)*n + 1 planes: 12,208 B instead of 41,472 B at tiles
//     (8, 32, t_t=2, t_s3=8), 17 blocks per SM instead of about 5.
//   * Fewer instructions per update. The radius is a constant (every stencil
//     here has radius 1), so neighbour reads take immediate offsets; a block
//     whose window reaches no Dirichlet border (98% of K1's blocks at 8192^2)
//     runs a copy of its step loop that tests no cell. K1 is held back by
//     instruction issue about as much as by bytes: these two took K1 from
//     0.342 to 0.293 ms and K2 from 0.234 to 0.193 ms (chip_smoke.py phase
//     6, H100 80GB HBM3, 700 W).
// The layout (pitch, slot or buffer size, bytes) is computed by
// smem_layout() in tiled_stencils.py and passed in; the wrapper refuses a
// pass over 232,448 B before launch. `k` (tiles per SM) changes no value and
// is not a launch parameter here.
#include <cstdint>
#include <type_traits>

#include "stencil_bodies.cuh"

// Stencil radius. Every stencil of the package has radius 1; a constant lets
// neighbour reads use immediate offsets. The entry points refuse another.
constexpr int H = 1;

struct Geom {
  int s1, s2, s3;  // array extents (s3 = 1 in 2-D)
  int t1, t2, t3;  // tile extents (t3 = 1 in 2-D)
  int n;           // steps this pass
  int pitch;       // floats per shared-memory row
  int slot;        // floats per buffer (2-D) or per plane (3-D), a multiple of 4
  int xmis;        // x's address in elements, modulo 8: its offset from the 16-byte grid
};

// One axis of a block's window, in window-local coordinates.
struct Axis {
  int lo;      // global index of window cell 0
  int e;       // window extent, clipped to the array
  int c0, c1;  // the core tile [c0, c1)
  int a0, a1;  // cells that are not Dirichlet borders [a0, a1)
  // the cells of time level s = n - w/H: the core widened by w, clipped
  __device__ int from(int w) const { return max(c0 - w, 0); }
  __device__ int to(int w) const { return min(c1 + w, e); }
};

__device__ __forceinline__ Axis make_axis(int tile, int t, int s, int hh) {
  const int o = tile * t;
  Axis a;
  a.lo = max(o - hh, 0);
  a.e = min(o + t + hh, s) - a.lo;
  a.c0 = o - a.lo;
  a.c1 = min(o + t, s) - a.lo;
  a.a0 = H - a.lo;
  a.a1 = s - H - a.lo;
  return a;
}

// Calls f(r, c) for every cell of [r0, r1) x [c0, c1); thread k takes cells
// k, k + B, k + 2B, ... in row-major order. The step (dr, dc) is fixed, so
// the loop advances (r, c) with one compare and no division.
template <typename F>
__device__ __forceinline__ void for_cells(int r0, int r1, int c0, int c1, F&& f) {
  const int w = c1 - c0;
  if (w <= 0 || r1 <= r0) return;
  const int b = blockDim.x, k = threadIdx.x;
  const int dr = b / w, dc = b - dr * w;
  int r = r0 + k / w, c = c0 + k % w;
  while (r < r1) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= c1) {
      c -= w;
      ++r;
    }
  }
}

__device__ __forceinline__ void copy_one(float* d, const float* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(d))),
               "l"(s)
               : "memory");
}
__device__ __forceinline__ void copy_vec(float* d, const float* s) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(d))),
               "l"(s)
               : "memory");
}
__device__ __forceinline__ void copy_one(float* d, const __nv_bfloat16* s) { *d = __bfloat162float(__ldg(s)); }
__device__ __forceinline__ void copy_vec(float* d, const __nv_bfloat16* s) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(s));
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(b[0]), f1 = __bfloat1622float2(b[1]);
  const float2 f2 = __bfloat1622float2(b[2]), f3 = __bfloat1622float2(b[3]);
  reinterpret_cast<float4*>(d)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
  reinterpret_cast<float4*>(d)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
}
__device__ __forceinline__ void copies_issued() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void copies_landed() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Copies `rows` rows of `len` elements, row r from x + g + r * stride to
// dst + r * pitch, as f32. dst's element offset in shared memory must equal
// the element offset of x + g in device memory modulo 4, and pitch equal
// stride modulo 4 (smem_layout and the kernels' base shift make it so).
// Each thread takes 16-byte units of the rows: a unit that lies wholly in
// the row is one 16-byte copy, a unit at a ragged end goes element by
// element.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, long long g, long long stride, int len,
                                           int rows, float* dst, int pitch, int xmis) {
  constexpr int V = 16 / sizeof(T);
  for_cells(0, rows, 0, (len + V - 1) / V + 1, [&](int r, int u) {
    const long long gr = g + r * stride;
    const int q = u * V - static_cast<int>((gr + xmis) & (V - 1));
    const T* src = x + gr;
    float* d = dst + r * pitch;
    if (q >= 0 && q + V <= len) {
      copy_vec(d + q, src + q);
    } else {
      for (int k = max(q, 0); k < min(q + V, len); ++k) copy_one(d + k, src + k);
    }
  });
}

// A window that reaches no Dirichlet border (most blocks) takes the kernels'
// BORDER = false instance of their step loop, which tests no cell.
__device__ __forceinline__ bool has_border(const Axis& a) { return a.a0 > 0 || a.a1 < a.e; }

// __launch_bounds__(1024): a block of t_s2 = 1024 threads must launch, so at
// most 64 registers a thread.
template <typename T, int S>
__global__ void __launch_bounds__(1024) tiled2d_kernel(const T* __restrict__ x, T* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) float smem[];
  const int g2 = (g.s2 + g.t2 - 1) / g.t2;
  const int b1 = blockIdx.x / g2, b2 = blockIdx.x - b1 * g2;
  const int n = g.n, p = g.pitch;
  const Axis r = make_axis(b1, g.t1, g.s1, H * n);
  const Axis c = make_axis(b2, g.t2, g.s2, H * n);
  const long long g0 = static_cast<long long>(r.lo) * g.s2 + c.lo;
  const int shift = static_cast<int>((g0 + g.xmis) & 3);
  float* cur = smem + shift;
  float* nxt = smem + g.slot + shift;

  stage_rows(x, g0, g.s2, c.e, r.e, cur, p, g.xmis);
  copies_landed();
  __syncthreads();

  auto steps = [&](auto border) {
    constexpr bool BORDER = decltype(border)::value;
    for (int s = 1; s <= n; ++s) {
      const int w = H * (n - s);
      const float* in = cur;
      auto value = [&](int i, int j) {
        const int k = i * p + j;
        float v = in[k];
        if (!BORDER || (i >= r.a0 && i < r.a1 && j >= c.a0 && j < c.a1))
          v = update2d<S>(v, in[k - H * p], in[k + H * p], in[k - H], in[k + H]);
        return v;
      };
      if (s == n) {
        for_cells(r.from(w), r.to(w), c.from(w), c.to(w),
                  [&](int i, int j) { store_f(out, g0 + static_cast<long long>(i) * g.s2 + j, value(i, j)); });
      } else {
        float* o = nxt;
        for_cells(r.from(w), r.to(w), c.from(w), c.to(w), [&](int i, int j) { o[i * p + j] = value(i, j); });
        __syncthreads();
        nxt = cur;
        cur = o;
      }
    }
  };
  if (has_border(r) || has_border(c)) {
    steps(std::true_type{});
  } else {
    steps(std::false_type{});
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(1024) tiled3d_kernel(const T* __restrict__ x, T* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) float smem[];
  const int g2 = (g.s2 + g.t2 - 1) / g.t2, g3 = (g.s3 + g.t3 - 1) / g.t3;
  int b = blockIdx.x;
  const int b3 = b % g3;
  b /= g3;
  const int b2 = b % g2, b1 = b / g2;
  const int n = g.n, p = g.pitch;
  const Axis a1 = make_axis(b1, g.t1, g.s1, H * n);
  const Axis a2 = make_axis(b2, g.t2, g.s2, H * n);
  const Axis a3 = make_axis(b3, g.t3, g.s3, H * n);
  const long long sp = static_cast<long long>(g.s2) * g.s3;
  constexpr int ring = 2 * H + 1, ring0 = ring + 1;  // planes per level; level 0 has one in flight
  // device-memory offset of window plane q; its shared-memory plane at level lv
  auto gplane = [&](int q) { return (a1.lo + q) * sp + static_cast<long long>(a2.lo) * g.s3 + a3.lo; };
  auto plane = [&](int lv, int q) -> float* {  // one modulo per plane, none per cell
    if (lv == 0) return smem + (q % ring0) * g.slot + static_cast<int>((gplane(q) + g.xmis) & 3);
    return smem + (ring0 + (lv - 1) * ring + q % ring) * g.slot;
  };
  auto stage = [&](int q) { stage_rows(x, gplane(q), g.s3, a3.e, a2.e, plane(0, q), p, g.xmis); };

  auto sweep = [&](auto border) {
    constexpr bool BORDER = decltype(border)::value;
    stage(0);
    copies_issued();
    const int t_end = a1.c1 - 1 + n * H;  // the iteration at which level n reaches the core's last plane
    for (int t = 0; t <= t_end; ++t) {
      copies_landed();
      __syncthreads();  // plane t is in; every read of iteration t - 1 is done
      if (t + 1 < a1.e) stage(t + 1);
      copies_issued();
      for (int s = 1; s <= n; ++s) {
        const int q = t - s * H, w = H * (n - s);
        if (q >= a1.from(w) && q < a1.to(w)) {
          const bool live = !BORDER || (q >= a1.a0 && q < a1.a1);
          const float* cen = plane(s - 1, q);
          const float* up = live ? plane(s - 1, q - H) : cen;
          const float* dn = live ? plane(s - 1, q + H) : cen;
          auto value = [&](int j, int m) {
            const int k = j * p + m;
            float v = cen[k];
            if (!BORDER || (live && j >= a2.a0 && j < a2.a1 && m >= a3.a0 && m < a3.a1))
              v = update3d<S>(v, up[k], dn[k], cen[k - H * p], cen[k + H * p], cen[k - H], cen[k + H]);
            return v;
          };
          if (s == n) {
            const long long gq = gplane(q);
            for_cells(a2.from(w), a2.to(w), a3.from(w), a3.to(w), [&](int j, int m) {
              store_f(out, gq + static_cast<long long>(j) * g.s3 + m, value(j, m));
            });
          } else {
            float* o = plane(s, q);
            for_cells(a2.from(w), a2.to(w), a3.from(w), a3.to(w), [&](int j, int m) { o[j * p + m] = value(j, m); });
          }
        }
        if (s < n) __syncthreads();
      }
    }
  };
  if (has_border(a1) || has_border(a2) || has_border(a3)) {
    sweep(std::true_type{});
  } else {
    sweep(std::false_type{});
  }
}

template <typename T, int S, int DIMS>
static int launch(const void* x, void* out, Geom g, long long smem, void* stream) {
  void (*kernel)(const T*, T*, Geom);
  if constexpr (DIMS == 2) {
    kernel = tiled2d_kernel<T, S>;
  } else {
    kernel = tiled3d_kernel<T, S>;
  }
  // as many blocks per SM as shared memory allows
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>((g.s1 + g.t1 - 1) / g.t1) * ((g.s2 + g.t2 - 1) / g.t2) *
                           ((g.s3 + g.t3 - 1) / g.t3);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  g.xmis = static_cast<int>((reinterpret_cast<uintptr_t>(x) / sizeof(T)) & 7);
  const int threads = g.t2 < 1024 ? g.t2 : 1024;
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <int S, int DIMS>
static int dispatch_dtype(int dtype, const void* x, void* out, Geom g, long long smem, void* stream) {
  if (dtype == F32) return launch<float, S, DIMS>(x, out, g, smem, stream);
  if (dtype == BF16) return launch<__nv_bfloat16, S, DIMS>(x, out, g, smem, stream);
  return cudaErrorInvalidValue;
}

extern "C" int repro_tiled2d(const void* x, void* out, int dtype, int stencil, int s1, int s2, int t1, int t2,
                             int n, int h, int pitch, int slot, long long smem, void* stream) {
  if (h != H) return cudaErrorInvalidValue;
  const Geom g{s1, s2, 1, t1, t2, 1, n, pitch, slot, 0};
  switch (stencil) {
    case JACOBI2D: return dispatch_dtype<JACOBI2D, 2>(dtype, x, out, g, smem, stream);
    case HEAT2D: return dispatch_dtype<HEAT2D, 2>(dtype, x, out, g, smem, stream);
    case LAPLACIAN2D: return dispatch_dtype<LAPLACIAN2D, 2>(dtype, x, out, g, smem, stream);
    case GRADIENT2D: return dispatch_dtype<GRADIENT2D, 2>(dtype, x, out, g, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int repro_tiled3d(const void* x, void* out, int dtype, int stencil, int s1, int s2, int s3, int t1,
                             int t2, int t3, int n, int h, int pitch, int slot, long long smem, void* stream) {
  if (h != H) return cudaErrorInvalidValue;
  const Geom g{s1, s2, s3, t1, t2, t3, n, pitch, slot, 0};
  switch (stencil) {
    case HEAT3D: return dispatch_dtype<HEAT3D, 3>(dtype, x, out, g, smem, stream);
    case LAPLACIAN3D: return dispatch_dtype<LAPLACIAN3D, 3>(dtype, x, out, g, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Blocks of the f32 heat kernel of `dims` dimensions that fit on one SM at
// this block size and shared memory (every stencil of a dimension has the
// same launch shape): read by chip_smoke.py beside the kernel times.
extern "C" int repro_tiled_blocks_per_sm(int dims, int threads, long long smem, int* blocks) {
  void (*kernel)(const float*, float*, Geom) = dims == 2 ? tiled2d_kernel<float, HEAT2D> : tiled3d_kernel<float, HEAT3D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, static_cast<size_t>(smem));
}
