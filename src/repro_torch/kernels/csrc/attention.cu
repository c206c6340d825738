// Fused grouped-query attention, forward and backward, for bf16 heads of
// width 64 or 128: causal, causal within a window, or bidirectional, masked
// by each token's position.
//
// Replaces no TPU kernel: the JAX package's attention
// (src/repro/models/attention.py) is plain jnp, and the port's plain core
// (_sdpa in src/repro_torch/models/attention.py) writes its S x S scores
// out, casts them to f32, adds a broadcast f32 mask and runs softmax over
// them: at 4,096 tokens that is some 15-20 GB of device-memory traffic per
// layer and microbatch of training, against 0.07 TFLOP of useful causal
// work. This file computes the same function without writing any score out.
//
// Bound at the training shape (B = 2, H = 16, KH = 8, S = 4,096, D = 128,
// causal): tensor-core operations. The forward's useful work is
// 2 x 2 x D FLOP for each of the B x H x S (S + 1) / 2 causal pairs, 0.14
// TFLOP a call (0.14 ms at 989 TFLOP/s); its bytes (q, k, v, out, 0.1 GB)
// take 0.03 ms at 3.35 TB/s. The backward's useful work is twice the
// forward's (dP, dV, dQ, dK).
//
// Design (FlashAttention-2's arrangement, on mma.sync):
//  * Every kernel cuts queries and keys into tiles of TILE = 64 rows; a
//    block has 4 warps, each owning 16 rows of its block's tile. Tiles of
//    64 x D bf16 are copied into shared memory with cp.async (16 bytes a
//    thread, zero-filled past the array's end), double-buffered, in a
//    layout whose 16-byte chunks are XOR-swizzled by row so that ldmatrix
//    reads them without bank conflicts. Products are mma.sync m16n8k16
//    (bf16 in, f32 accumulate).
//  * attn_meta_kernel summarises the positions per tile: per query tile
//    the least and greatest position and the rows with no valid key; per
//    key tile the least and greatest valid position and the number of
//    valid keys. A pair of tiles is skipped only when every pair in it is
//    masked (judged from those positions, not from indices), and is taken
//    without a per-element mask only when every pair in it is valid.
//  * Forward (attn_fwd_kernel): one block per (query tile, batch x query
//    head), the longest rows first; query head h reads kv head
//    h / (H / KH), whose K and V are never expanded. Online softmax in f32
//    registers; O is written in bf16 as (B, Sq, H, D), and the row's
//    log-sum-exp (natural log, of the scaled scores) in f32 as (B, H, Sq).
//  * Backward: attn_delta_kernel, D = rowsum(dO * O) in f32, from the
//    forward's O before its rounding to bf16 (the plain core's
//    sum(P * dP) is exact there; from the rounded O, D's error shifts
//    every dS of the row alike, doubling dQ's error); attn_dkv_kernel,
//    one block per (key tile, batch x kv head), walking the query tiles of
//    each of the kv head's G query heads and summing dK and dV over them in
//    registers; attn_dq_kernel, one block per (query tile, batch x query
//    head), walking the key tiles. S and P are recomputed from the saved
//    log-sum-exp. No atomics: two runs on the same inputs give the same
//    bits.
//
// Rounding points are the plain core's: each score is rounded to bf16 (the
// einsum's output), then scaled and soft-maxed in f32; P is rounded to bf16
// before P V; every product accumulates in f32. In the backward dP = dO V^T
// is rounded to bf16, and dS (scaled) to bf16 before dQ = dS K and
// dK = dS^T Q, as autograd rounds them through the plain core's casts.
//
// Masking is _mask_bias's: a key with position < 0 is invalid; causally a
// key is masked unless k_pos <= q_pos, and with a window unless
// q_pos - k_pos < window; bidirectionally only the first rule holds. A row
// with no valid key gets what the finite NEG_INF bias gives the plain
// core: a uniform softmax over every key of the array, that is the mean of
// V (and its gradients); the kernels give such a row a score of 0 for
// every key in range.
//
// The file is compiled as five units (repro_torch/kernels/_build.py
// ATTENTION_UNITS), in parallel, and linked into one library: without
// ATTN_HEAD_DIM, the C entry points; with ATTN_HEAD_DIM = 64 or 128 and
// ATTN_BACKWARD = 0 or 1, one head width's forward or backward launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

}  // namespace

// The launch's arguments; its layout is repro_torch/kernels/attention.py's
// _Params, field for field.
struct AttnParams {
  const bf16* q;     // (B, Sq, H, D), strides q_b, q_s, q_h; the last dim contiguous
  const bf16* k;     // (B, Lk, KH, D)
  const bf16* v;     // (B, Lk, KH, D)
  float* o32;       // the forward's output in f32 (B, Sq, H, D), written where not null
  const bf16* dout;  // its gradient (B, Sq, H, D), strides do_b, do_s, do_h
  bf16* out;         // (B, Sq, H, D) contiguous
  bf16* dq;          // (B, Sq, H, D) contiguous
  bf16* dk;          // (B, Lk, KH, D) contiguous
  bf16* dv;          // (B, Lk, KH, D) contiguous
  float* lse;        // (B, H, Sq)
  float* delta;      // (B, H, Sq)
  const int* q_pos;  // (B, Sq)
  const int* k_pos;  // (B, Lk)
  int4* qmeta;       // (B, query tiles): least, greatest position, rows with no valid key
  int4* kmeta;       // (B, key tiles): least, greatest valid position, valid keys
  int* dead;         // (B, Sq): 1 where the row has no valid key
  long long q_b, q_s, q_h;
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long do_b, do_s, do_h;
  int B, Sq, Lk, H, KH, causal, window;
  float scale;
};

// one head width's launches, each in its own unit
int attn_fwd_64(const AttnParams& p, cudaStream_t st);
int attn_fwd_128(const AttnParams& p, cudaStream_t st);
int attn_bwd_64(const AttnParams& p, cudaStream_t st);
int attn_bwd_128(const AttnParams& p, cudaStream_t st);

#ifdef ATTN_HEAD_DIM
namespace {

// ---------------------------------------------------------------------------
// Masks judged from positions
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool pair_ok(int qp, int kp, int causal, int window) {
  if (kp < 0) return false;
  if (!causal) return true;
  return kp <= qp && (window == 0 || qp - kp < window);
}

// every pair of the two tiles is masked (and no row of the query tile is
// one with no valid key, which reads every key)
__device__ __forceinline__ bool tile_skip(int4 qm, int4 km, const AttnParams& p) {
  if (qm.z > 0) return false;
  if (km.z == 0) return true;
  if (!p.causal) return false;
  if (km.x > qm.y) return true;
  return p.window && (long long)qm.x - km.y >= p.window;
}

// every pair of the two tiles is valid: no per-element mask
__device__ __forceinline__ bool tile_full(int4 qm, int4 km, const AttnParams& p) {
  if (qm.z > 0 || km.z != TILE) return false;
  if (!p.causal) return true;
  return km.y <= qm.x && (p.window == 0 || (long long)qm.y - km.x < p.window);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes, zero-filled where `in` is false (the source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) b (16 x 8, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// 2^x to about 22 bits; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Tiles in shared memory: TILE rows of D bf16, 16-byte chunk c of row r
// stored at chunk c ^ (r & 7)
// ---------------------------------------------------------------------------
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// rows [0, rows_left) of a tile from `g` (row stride `stride` elements);
// the rest zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, long long stride, int rows_left) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = r < rows_left;
    cp_async16(sm + swz<D>(r, c), g + (in ? r * stride : 0) + c * 8, in);
  }
}

// A fragment of rows [r0, r0 + 16), columns [16 kk, 16 kk + 16) of a
// row-major tile
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* sm, int r0, int kk, int lane) {
  ldsm_x4(a, smem_u32(sm + swz<D>(r0 + (lane & 15), 2 * kk + (lane >> 4))));
}

// B fragments of two 8-column n-tiles for rows [n0, n0 + 16) of a tile
// read as B[k][n] = tile[n][k] (k = columns [16 kk, 16 kk + 16)):
// b[0], b[1] for rows n0.., b[2], b[3] for rows n0 + 8..
template <int D>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* sm, int n0, int kk, int lane) {
  ldsm_x4(b, smem_u32(sm + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1))));
}

// B fragments read as B[k][n] = tile[k][n], k = rows [16 kk, 16 kk + 16),
// n = columns [16 dp, 16 dp + 16): b[0], b[1] for columns 16 dp..,
// b[2], b[3] for columns 16 dp + 8..
template <int D>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* sm, int kk, int dp, int lane) {
  ldsm_x4_t(b, smem_u32(sm + swz<D>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * dp + (lane >> 4))));
}

// the first key tile at or after j that a query tile reads
__device__ __forceinline__ int next_k(int4 qm, const int4* km, int j, int n, const AttnParams& p) {
  while (j < n && tile_skip(qm, km[j], p)) ++j;
  return j;
}

// ---------------------------------------------------------------------------
// The tiles' summary of positions
// ---------------------------------------------------------------------------
// whether query row `row` at position qp has a valid key; the scan starts
// at the key of the same index, where self-attention finds one at once
__device__ bool has_key(const AttnParams& p, int b, int row, int qp) {
  const int* kp = p.k_pos + (long long)b * p.Lk;
  const int start = min(row, p.Lk - 1);
  for (int j = start; j >= 0; --j)
    if (pair_ok(qp, kp[j], p.causal, p.window)) return true;
  for (int j = start + 1; j < p.Lk; ++j)
    if (pair_ok(qp, kp[j], p.causal, p.window)) return true;
  return false;
}

__global__ void __launch_bounds__(TILE) attn_meta_kernel(const AttnParams p) {
  __shared__ int lo, hi, count;
  const int tile = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const int n_qt = (p.Sq + TILE - 1) / TILE, n_kt = (p.Lk + TILE - 1) / TILE;
  if (tile < n_kt) {
    if (i == 0) lo = INT_MAX, hi = INT_MIN, count = 0;
    __syncthreads();
    const int key = tile * TILE + i;
    if (key < p.Lk) {
      const int kp = p.k_pos[(long long)b * p.Lk + key];
      if (kp >= 0) atomicMin(&lo, kp), atomicMax(&hi, kp), atomicAdd(&count, 1);
    }
    __syncthreads();
    if (i == 0) p.kmeta[b * n_kt + tile] = make_int4(lo, hi, count, 0);
    __syncthreads();
  }
  if (tile < n_qt) {
    if (i == 0) lo = INT_MAX, hi = INT_MIN, count = 0;
    __syncthreads();
    const int row = tile * TILE + i;
    if (row < p.Sq) {
      const int qp = p.q_pos[(long long)b * p.Sq + row];
      const int none = has_key(p, b, row, qp) ? 0 : 1;
      p.dead[(long long)b * p.Sq + row] = none;
      atomicMin(&lo, qp), atomicMax(&hi, qp);
      if (none) atomicAdd(&count, 1);
    }
    __syncthreads();
    if (i == 0) p.qmeta[b * n_qt + tile] = make_int4(lo, hi, count, 0);
  }
}

// ---------------------------------------------------------------------------
// Scores of one thread's 2 rows x 16 columns of a 16 x 64 tile: scaled
// (log2 units), masked, a row with no valid key at 0
// ---------------------------------------------------------------------------
// s[nt][e]: row lo (e < 2) or hi, column 8 nt + 2 t + (e & 1)
struct RowInfo {
  int pos[2];
  int dead[2];
  bool in[2];
};

// the scaled, masked scores of rows `rows` against columns `cols` (both
// tile-relative through the callbacks); row r's column c is valid when
// col_in(c) and (row r is dead or pair_ok)
__device__ __forceinline__ void scale_scores(float (&s)[8][4], float sl2, bool full, const RowInfo& r,
                                             const int* kp_tile, int cols_left, int t,
                                             const AttnParams& p) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = round_bf16(s[nt][e]) * sl2;
      if (!full) {
        const int i = e >> 1, c = nt * 8 + 2 * t + (e & 1);
        const bool kin = c < cols_left;
        const bool ok = kin && r.in[i] && (r.dead[i] || pair_ok(r.pos[i], kp_tile[c], p.causal, p.window));
        x = ok ? (r.dead[i] ? 0.f : x) : -INFINITY;
      }
      s[nt][e] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 2) attn_fwd_kernel(const AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE * D;      // two buffers
  bf16* sV = sK + 2 * TILE * D;  // two buffers
  int* sKp = reinterpret_cast<int*>(sV + 2 * TILE * D);  // two buffers of TILE positions

  const int n_qt = (p.Sq + TILE - 1) / TILE, n_kt = (p.Lk + TILE - 1) / TILE;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kh = h / (p.H / p.KH);
  const int qt = n_qt - 1 - blockIdx.y;  // the longest rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * TILE;

  const int4 qm = p.qmeta[b * n_qt + qt];
  const int4* km = p.kmeta + b * n_kt;
  const bf16* gk = p.k + b * p.k_b + kh * p.k_h;
  const bf16* gv = p.v + b * p.v_b + kh * p.v_h;
  const int* gkp = p.k_pos + (long long)b * p.Lk;

  auto load_kv = [&](int j, int buf) {
    const int rows = p.Lk - j * TILE;
    load_tile<D>(sK + buf * TILE * D, gk + (long long)j * TILE * p.k_s, p.k_s, rows);
    load_tile<D>(sV + buf * TILE * D, gv + (long long)j * TILE * p.v_s, p.v_s, rows);
    if (threadIdx.x < TILE) {
      const bool in = threadIdx.x < rows;
      cp_async4(sKp + buf * TILE + threadIdx.x, gkp + (in ? j * TILE + threadIdx.x : 0), in);
    }
  };

  int j = next_k(qm, km, 0, n_kt, p);
  load_tile<D>(sQ, p.q + b * p.q_b + (long long)q0 * p.q_s + h * p.q_h, p.q_s, p.Sq - q0);
  if (j < n_kt) load_kv(j, 0);
  cp_commit();

  RowInfo ri;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    ri.in[i] = row < p.Sq;
    ri.pos[i] = ri.in[i] ? p.q_pos[(long long)b * p.Sq + row] : 0;
    ri.dead[i] = ri.in[i] ? p.dead[(long long)b * p.Sq + row] : 0;
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * LOG2E;

  int buf = 0;
  while (j < n_kt) {
    const int jn = next_k(qm, km, j + 1, n_kt, p);
    cp_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with the other buffer
    if (jn < n_kt) load_kv(jn, buf ^ 1);
    cp_commit();

    const bf16* kt = sK + buf * TILE * D;
    const bf16* vt = sV + buf * TILE * D;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];  // from shared memory each tile: as fast as 32 registers holding Q
      frag_a<D>(qa, sQ, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        frag_bt<D>(bb, kt, np * 16, kk, lane);
        mma(s[2 * np], qa, bb[0], bb[1]);
        mma(s[2 * np + 1], qa, bb[2], bb[3]);
      }
    }
    scale_scores(s, sl2, tile_full(qm, km[j], p), ri, sKp + buf * TILE, p.Lk - j * TILE, t, p);

    // online softmax: rows lo (i = 0) and hi (i = 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float base = mx == -INFINITY ? 0.f : mx;
      const float corr = ex2(m[i] - base);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = ex2(s[nt][2 * i] - base), p1 = ex2(s[nt][2 * i + 1] - base);
        s[nt][2 * i] = p0, s[nt][2 * i + 1] = p1;
        sum += p0 + p1;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) o[dt][2 * i] *= corr, o[dt][2 * i + 1] *= corr;
    }

    // O += P V, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        frag_b<D>(bb, vt, kk, dp, lane);
        mma(o[2 * dp], a, bb[0], bb[1]);
        mma(o[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    j = jn;
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + warp * 16 + g + 8 * i;
    if (!ri.in[i]) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const long long off = (((long long)b * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float2 x = make_float2(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
      *reinterpret_cast<uint32_t*>(p.out + off + dt * 8 + 2 * t) = pack_bf16(x.x, x.y);
      if (p.o32) *reinterpret_cast<float2*>(p.o32 + off + dt * 8 + 2 * t) = x;
    }
    if (t == 0) {
      const float base = m[i] == -INFINITY ? 0.f : m[i];
      p.lse[((long long)b * p.H + h) * p.Sq + row] = (base + log2f(sum)) * LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in f32, one warp per (b, row, h)
template <int D>
__global__ void __launch_bounds__(THREADS) attn_delta_kernel(const AttnParams p) {
  const long long n = (long long)p.B * p.Sq * p.H;
  const long long idx = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (idx >= n) return;
  const int lane = threadIdx.x & 31;
  const int h = idx % p.H;
  const long long bs = idx / p.H;
  const int row = bs % p.Sq, b = bs / p.Sq;
  const float* orow = p.o32 + idx * D;
  const bf16* drow = p.dout + b * p.do_b + row * p.do_s + h * p.do_h;
  float sum = 0.f;
#pragma unroll
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 a = *reinterpret_cast<const float2*>(orow + d);
    const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(drow + d);
    sum += a.x * __bfloat162float(c.x) + a.y * __bfloat162float(c.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.delta[((long long)b * p.H + h) * p.Sq + row] = sum;
}

// dK and dV of one key tile of one kv head, summed over its G query heads
template <int D>
__global__ void __launch_bounds__(THREADS, 2) attn_dkv_kernel(const AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE * D;
  bf16* sQ = sV + TILE * D;       // two buffers
  bf16* sdO = sQ + 2 * TILE * D;  // two buffers
  float* sL = reinterpret_cast<float*>(sdO + 2 * TILE * D);  // two buffers of TILE: lse
  float* sDl = sL + 2 * TILE;                                 // delta
  int* sQp = reinterpret_cast<int*>(sDl + 2 * TILE);          // q_pos
  int* sDead = sQp + 2 * TILE;                                // dead rows

  const int n_qt = (p.Sq + TILE - 1) / TILE, n_kt = (p.Lk + TILE - 1) / TILE;
  const int G = p.H / p.KH;
  const int b = blockIdx.x / p.KH, kh = blockIdx.x % p.KH;
  const int kt = blockIdx.y;  // the longest columns (causally) first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = kt * TILE;

  const int4 kmj = p.kmeta[b * n_kt + kt];
  const int4* qmb = p.qmeta + b * n_qt;
  const int total = G * n_qt;
  auto next = [&](int n) {
    while (n < total && tile_skip(qmb[n % n_qt], kmj, p)) ++n;
    return n;
  };
  auto load_q = [&](int n, int buf) {
    const int gi = n / n_qt, qt = n % n_qt, h = kh * G + gi, q0 = qt * TILE;
    const int rows = p.Sq - q0;
    load_tile<D>(sQ + buf * TILE * D, p.q + b * p.q_b + (long long)q0 * p.q_s + h * p.q_h, p.q_s, rows);
    load_tile<D>(sdO + buf * TILE * D, p.dout + b * p.do_b + (long long)q0 * p.do_s + h * p.do_h, p.do_s,
                 rows);
    const int i = threadIdx.x & (TILE - 1);
    const bool in = i < rows;
    const long long bh = ((long long)b * p.H + h) * p.Sq + q0 + (in ? i : 0);
    const long long bq = (long long)b * p.Sq + q0 + (in ? i : 0);
    if (threadIdx.x < TILE) {
      cp_async4(sL + buf * TILE + i, p.lse + bh, in);
      cp_async4(sDl + buf * TILE + i, p.delta + bh, in);
    } else {
      cp_async4(sQp + buf * TILE + i, p.q_pos + bq, in);
      cp_async4(sDead + buf * TILE + i, p.dead + bq, in);
    }
  };

  load_tile<D>(sK, p.k + b * p.k_b + (long long)k0 * p.k_s + kh * p.k_h, p.k_s, p.Lk - k0);
  load_tile<D>(sV, p.v + b * p.v_b + (long long)k0 * p.v_s + kh * p.v_h, p.v_s, p.Lk - k0);
  int n = next(0);
  if (n < total) load_q(n, 0);
  cp_commit();

  // this thread's two keys: rows of S^T
  RowInfo ri;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + 8 * i;
    ri.in[i] = key < p.Lk;
    ri.pos[i] = ri.in[i] ? p.k_pos[(long long)b * p.Lk + key] : -1;
    ri.dead[i] = 0;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  const float sl2 = p.scale * LOG2E;

  int buf = 0;
  while (n < total) {
    const int nn = next(n + 1);
    cp_wait_all();
    __syncthreads();
    if (nn < total) load_q(nn, buf ^ 1);
    cp_commit();

    const int qt = n % n_qt, q0 = qt * TILE;
    const bf16* qtile = sQ + buf * TILE * D;
    const bf16* dotile = sdO + buf * TILE * D;
    const float* lt = sL + buf * TILE;
    const float* dlt = sDl + buf * TILE;
    const int* qpt = sQp + buf * TILE;
    const int* deadt = sDead + buf * TILE;
    const bool full = tile_full(qmb[qt], kmj, p);
    const int rows_left = p.Sq - q0;

    // S^T = K Q^T: this warp's 16 keys x 64 queries
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a<D>(a, sK, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        frag_bt<D>(bb, qtile, np * 16, kk, lane);
        mma(s[2 * np], a, bb[0], bb[1]);
        mma(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // P^T: key row i, query column c
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = nt * 8 + 2 * t + (e & 1);
        float x = round_bf16(s[nt][e]) * sl2;
        if (!full) {
          const bool dead = deadt[c];
          const bool ok = ri.in[i] && c < rows_left && (dead || pair_ok(qpt[c], ri.pos[i], p.causal, p.window));
          x = ok ? (dead ? 0.f : x) : -INFINITY;
        }
        s[nt][e] = ex2(x - lt[c] * LOG2E);
      }
    }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        frag_b<D>(bb, dotile, kk, dp, lane);
        mma(dv[2 * dp], a, bb[0], bb[1]);
        mma(dv[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    // dP^T = V dO^T
    float dpm[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) dpm[nt][0] = dpm[nt][1] = dpm[nt][2] = dpm[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a<D>(a, sV, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        frag_bt<D>(bb, dotile, np * 16, kk, lane);
        mma(dpm[2 * np], a, bb[0], bb[1]);
        mma(dpm[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // dS^T = P^T (dP^T - delta), scaled
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        dpm[nt][e] = s[nt][e] * (round_bf16(dpm[nt][e]) - dlt[c]) * p.scale;
      }
    }
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(dpm[2 * kk][0], dpm[2 * kk][1]), pack_bf16(dpm[2 * kk][2], dpm[2 * kk][3]),
                             pack_bf16(dpm[2 * kk + 1][0], dpm[2 * kk + 1][1]),
                             pack_bf16(dpm[2 * kk + 1][2], dpm[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        frag_b<D>(bb, qtile, kk, dp, lane);
        mma(dk[2 * dp], a, bb[0], bb[1]);
        mma(dk[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    n = nn;
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ri.in[i]) continue;
    const int key = k0 + warp * 16 + g + 8 * i;
    const long long off = (((long long)b * p.Lk + key) * p.KH + kh) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(p.dk + off + dt * 8 + 2 * t) = pack_bf16(dk[dt][2 * i], dk[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + off + dt * 8 + 2 * t) = pack_bf16(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

// dQ of one query tile of one query head
template <int D>
__global__ void __launch_bounds__(THREADS, 2) attn_dq_kernel(const AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + TILE * D;
  bf16* sK = sdO + TILE * D;     // two buffers
  bf16* sV = sK + 2 * TILE * D;  // two buffers
  int* sKp = reinterpret_cast<int*>(sV + 2 * TILE * D);  // two buffers of TILE positions

  const int n_qt = (p.Sq + TILE - 1) / TILE, n_kt = (p.Lk + TILE - 1) / TILE;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kh = h / (p.H / p.KH);
  const int qt = n_qt - 1 - blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * TILE;

  const int4 qm = p.qmeta[b * n_qt + qt];
  const int4* km = p.kmeta + b * n_kt;
  const bf16* gk = p.k + b * p.k_b + kh * p.k_h;
  const bf16* gv = p.v + b * p.v_b + kh * p.v_h;
  const int* gkp = p.k_pos + (long long)b * p.Lk;

  auto load_kv = [&](int j, int buf) {
    const int rows = p.Lk - j * TILE;
    load_tile<D>(sK + buf * TILE * D, gk + (long long)j * TILE * p.k_s, p.k_s, rows);
    load_tile<D>(sV + buf * TILE * D, gv + (long long)j * TILE * p.v_s, p.v_s, rows);
    if (threadIdx.x < TILE) {
      const bool in = threadIdx.x < rows;
      cp_async4(sKp + buf * TILE + threadIdx.x, gkp + (in ? j * TILE + threadIdx.x : 0), in);
    }
  };

  int j = next_k(qm, km, 0, n_kt, p);
  load_tile<D>(sQ, p.q + b * p.q_b + (long long)q0 * p.q_s + h * p.q_h, p.q_s, p.Sq - q0);
  load_tile<D>(sdO, p.dout + b * p.do_b + (long long)q0 * p.do_s + h * p.do_h, p.do_s, p.Sq - q0);
  if (j < n_kt) load_kv(j, 0);
  cp_commit();

  RowInfo ri;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    ri.in[i] = row < p.Sq;
    ri.pos[i] = ri.in[i] ? p.q_pos[(long long)b * p.Sq + row] : 0;
    ri.dead[i] = ri.in[i] ? p.dead[(long long)b * p.Sq + row] : 0;
    const long long bh = ((long long)b * p.H + h) * p.Sq + row;
    lse2[i] = ri.in[i] ? p.lse[bh] * LOG2E : 0.f;
    dl[i] = ri.in[i] ? p.delta[bh] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const float sl2 = p.scale * LOG2E;

  int buf = 0;
  while (j < n_kt) {
    const int jn = next_k(qm, km, j + 1, n_kt, p);
    cp_wait_all();
    __syncthreads();
    if (jn < n_kt) load_kv(jn, buf ^ 1);
    cp_commit();

    const bf16* kt = sK + buf * TILE * D;
    const bf16* vt = sV + buf * TILE * D;
    // S = Q K^T
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a<D>(a, sQ, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        frag_bt<D>(bb, kt, np * 16, kk, lane);
        mma(s[2 * np], a, bb[0], bb[1]);
        mma(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    scale_scores(s, sl2, tile_full(qm, km[j], p), ri, sKp + buf * TILE, p.Lk - j * TILE, t, p);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = ex2(s[nt][e] - lse2[e >> 1]);
    // dP = dO V^T
    float dpm[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) dpm[nt][0] = dpm[nt][1] = dpm[nt][2] = dpm[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a<D>(a, sdO, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        frag_bt<D>(bb, vt, np * 16, kk, lane);
        mma(dpm[2 * np], a, bb[0], bb[1]);
        mma(dpm[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpm[nt][e] = s[nt][e] * (round_bf16(dpm[nt][e]) - dl[e >> 1]) * p.scale;
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(dpm[2 * kk][0], dpm[2 * kk][1]), pack_bf16(dpm[2 * kk][2], dpm[2 * kk][3]),
                             pack_bf16(dpm[2 * kk + 1][0], dpm[2 * kk + 1][1]),
                             pack_bf16(dpm[2 * kk + 1][2], dpm[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        frag_b<D>(bb, kt, kk, dp, lane);
        mma(dq[2 * dp], a, bb[0], bb[1]);
        mma(dq[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    j = jn;
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ri.in[i]) continue;
    const int row = q0 + warp * 16 + g + 8 * i;
    bf16* qrow = p.dq + (((long long)b * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(qrow + dt * 8 + 2 * t) = pack_bf16(dq[dt][2 * i], dq[dt][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------
template <int D>
constexpr int fwd_smem() {
  return 5 * TILE * D * 2 + 2 * TILE * 4;
}
template <int D>
constexpr int dkv_smem() {
  return 6 * TILE * D * 2 + 8 * TILE * 4;
}
template <int D>
constexpr int dq_smem() {
  return 6 * TILE * D * 2 + 2 * TILE * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int n_tiles(int n) { return (n + TILE - 1) / TILE; }

template <int D>
int launch_fwd(const AttnParams& p, cudaStream_t st) {
  const dim3 mgrid(n_tiles(p.Sq) > n_tiles(p.Lk) ? n_tiles(p.Sq) : n_tiles(p.Lk), p.B);
  attn_meta_kernel<<<mgrid, TILE, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if ((e = allow_smem(attn_fwd_kernel<D>, fwd_smem<D>())) != cudaSuccess) return e;
  attn_fwd_kernel<D><<<dim3(p.B * p.H, n_tiles(p.Sq)), THREADS, fwd_smem<D>(), st>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const AttnParams& p, cudaStream_t st) {
  const long long rows = (long long)p.B * p.Sq * p.H;
  attn_delta_kernel<D><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if ((e = allow_smem(attn_dkv_kernel<D>, dkv_smem<D>())) != cudaSuccess) return e;
  attn_dkv_kernel<D><<<dim3(p.B * p.KH, n_tiles(p.Lk)), THREADS, dkv_smem<D>(), st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = allow_smem(attn_dq_kernel<D>, dq_smem<D>())) != cudaSuccess) return e;
  attn_dq_kernel<D><<<dim3(p.B * p.H, n_tiles(p.Sq)), THREADS, dq_smem<D>(), st>>>(p);
  return cudaGetLastError();
}

}  // namespace

#define ATTN_CAT2(a, b) a##b
#define ATTN_CAT(a, b) ATTN_CAT2(a, b)
#if ATTN_BACKWARD
int ATTN_CAT(attn_bwd_, ATTN_HEAD_DIM)(const AttnParams& p, cudaStream_t st) {
  return launch_bwd<ATTN_HEAD_DIM>(p, st);
}
#else
int ATTN_CAT(attn_fwd_, ATTN_HEAD_DIM)(const AttnParams& p, cudaStream_t st) {
  return launch_fwd<ATTN_HEAD_DIM>(p, st);
}
#endif

#else  // the C entry points

// The forward: the tiles' summary of positions, then O and the log-sum-exp
// (two launches). Returns cudaGetLastError() after the first failing one;
// cudaErrorInvalidValue for a head width other than 64 or 128.
extern "C" int repro_attn_fwd(const AttnParams* p, int head_dim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return attn_fwd_64(*p, st);
  if (head_dim == 128) return attn_fwd_128(*p, st);
  return cudaErrorInvalidValue;
}

// The backward: delta, then dK and dV, then dQ (three launches), from the
// forward's log-sum-exp and summary of positions.
extern "C" int repro_attn_bwd(const AttnParams* p, int head_dim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return attn_bwd_64(*p, st);
  if (head_dim == 128) return attn_bwd_128(*p, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
