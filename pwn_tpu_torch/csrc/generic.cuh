// What the general-width bodies of kernels 5 and 3 share
// (gated_layer_generic.cu, flow_stack_train_generic.cu): the packed weight
// layout, the tile route, the operand types, the gates in fp32 libm, the
// ring of k-slices filled by cp.async, and the two register-tile products
// that every product of both bodies runs on.
//
// The general bodies take any width within the limit below, with fp32 or
// bf16 operands, and do every product and every gate in fp32 FMAs on the
// CUDA cores.  wgmma has no fp32 operand (its tf32 mode rounds the
// mantissa to 10 bits), and the port's fp32 means fp32.
//
// What bounds a product here is the issue rate of the FMAs (128 a clock an
// SM), so the design keeps everything else off that path:
// * Register tiles of 8 x 8: a thread owns rows {4 ty + i, TM/2 + 4 ty + i}
//   and columns {4 tx + j, 64 + 4 tx + j} (i, j < 4) of a TM x 128 output
//   chunk, ty = tid / 16, tx = tid % 16, TM / 8 x 16 threads.  A k step
//   is 64 FMAs against four 16-byte shared loads (the activation tile holds
//   rows, k contiguous: a load gives four k of one row).
// * The weights are packed on the host once per stack (ops/flow_stack.py::
//   pack_generic: fp32, chunk-major, k-major within a chunk, every dimension
//   padded, each gate chunk's 64 tanh columns beside their 64 sigmoid
//   partners), so a slice of BK k-rows of a chunk is one contiguous run of
//   8 KB (4 KB for dz) that every thread copies the same 16-byte chunks of,
//   and nothing is bounds-checked.
// * Weight slices and activation rows [x(t) | x(t - d) | cond(t)] (each
//   thread's source rows taken once a tile) stream by 16-byte cp.async
//   through a ring of STAGES slots, STAGES - 1 slices in flight while one is
//   multiplied; one barrier a slice.  Row strides of 16 bytes past a
//   multiple of 32 keep the fragment loads free of bank conflicts; nothing
//   is divided per element.
// * Tiles of 64 rows (128 threads): 250 blocks at the tiny teacher's
//   1 x 16,000, and three blocks an SM at student_iaf's widths, so one
//   block's gates and stores run under the others' products.  Widths
//   whose resident tiles do not fit take 32-row tiles (`tile_rows`: the
//   route, a function of the widths alone, mirrored in Python): the wide
//   teacher's (256, 512, 256, 80) backward, one block an SM.
// * The widths a body takes are the widths its routed tile fits: only z
//   (G/2 columns) and, backward, dout / dg and dz (C + S and G columns)
//   stay resident, and the 2C + M activation columns stream, so C and M
//   set no bound of their own (`widths_ok`).
// * Registers: a slice's products unroll two k quads (the weight
//   gradients' four k): unrolled whole, the compiler hoists every fragment
//   load of the slice and spills.
// * What bounds it now (tools/torch_generic_phases.py): the issue of the
//   cp.async copies (a quarter to a third of a tile from one thread's
//   clock) and, backward, the epilogue's read-modify-writes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gen {

using bf16 = __nv_bfloat16;

constexpr int BK = 16;             // k-rows per ring slice; packed K padded to it
constexpr int NB = 128;            // columns per output chunk
constexpr int STAGES = 3;          // ring slots
constexpr int SMEM_MAX = 232448;   // a block's opt-in shared memory on H100

__host__ __device__ constexpr int up(int n, int m) { return (n + m - 1) / m * m; }

// The packed weights' dimensions, the same in ops/flow_stack.py::
// generic_pack_dims.  Per layer, fp32, chunk-major:
//   gate (Gc, Kp, 128): g = cat @ gate; chunk j's column c is the tanh
//        column h = 64 j + c (c < 64) or its sigmoid partner (c >= 64)
//   out  (Nc, GHp, 128): out = z @ out, 128 out columns a chunk
//   dz   (Gc, Np, 64): dz = dout @ dz, 64 tanh columns a chunk
//   dcat (Kc, 2 GHp, 128): dcat = dg @ dcat, dg's columns [tanh h | sigmoid
//        h], each padded to GHp; 128 columns of 2C + M a chunk
// zero past the real widths.
struct Pack {
  int K, GH, N;     // 2C + M, G / 2, C + S
  int Kp, GHp, Np;  // each padded to BK
  int Gc, Nc, Kc;   // chunks: 64 gate columns, 128 out columns, 128 dcat columns
};

__host__ __device__ inline Pack pack_dims(int C, int G, int S, int M) {
  Pack p;
  p.K = 2 * C + M;
  p.GH = G / 2;
  p.N = C + S;
  p.Kp = up(p.K, BK);
  p.GHp = up(p.GH, BK);
  p.Np = up(p.N, BK);
  p.Gc = (p.GH + 63) / 64;
  p.Nc = (p.N + NB - 1) / NB;
  p.Kc = (p.K + NB - 1) / NB;
  return p;
}

// Shared memory of a block of `tm` rows: the ring (a slot holds tm rows of
// BK activations, 16 bytes past each row, and a BK x 128 fp32 weight slice)
// and the resident fp32 tiles, each row 4 floats past its width (z forward;
// [dout, then dg] and, where G/2 > 64, dz backward).
// ops/flow_stack.py::generic_smem_bytes.
__host__ __device__ inline long long smem_at(int tm, int C, int G, int S, int M, bool backward) {
  const Pack p = pack_dims(C, G, S, M);
  const long long stage = tm * (BK * 4 + 16) + BK * NB * 4;  // stage_bytes<tm>
  // z, or dz where G/2 > 64 (at G/2 <= 64 dz sits over dout)
  long long cols = !backward || p.Gc > 1 ? p.GHp + 4 : 0;
  if (backward) cols += (p.Np > 2 * p.GHp ? p.Np : 2 * p.GHp) + 4;
  return STAGES * stage + tm * cols * 4;
}

// Bytes of one ring slot of a TM-row tile.
template <int TM>
__host__ __device__ constexpr int stage_bytes() {
  return TM * (BK * 4 + 16) + BK * NB * 4;
}

// The route of the row tile: 64 rows, or 32 where 64 do not fit.
__host__ __device__ inline int tile_rows(int C, int G, int S, int M, bool backward) {
  return smem_at(64, C, G, S, M, backward) <= SMEM_MAX ? 64 : 32;
}

// Blocks an SM kernel 3's layer pass is built for (its registers a thread
// are 65,536 over that many blocks of 2 TM threads): three where the rows
// give every SM of an H100 (FULL_SMS) three tiles, else two, so that a
// launch of few tiles (the tiny configs' 1 x 16,000) runs each with the
// registers of two.  A route of R and the tile alone, mirrored in Python.
constexpr int FULL_SMS = 132;
__host__ __device__ inline int layer_blocks(long long R, int tm) {
  return (R + tm - 1) / tm >= 3LL * FULL_SMS ? 3 : 2;
}

__host__ __device__ inline long long smem_bytes(int C, int G, int S, int M, bool backward) {
  return smem_at(tile_rows(C, G, S, M, backward), C, G, S, M, backward);
}

// The widths a general body takes: C, S, M >= 1, an even G >= 2, and a
// routed tile that fits a block's shared memory (nothing else in either
// body is sized by a width; ops/flow_stack.py::generic_limits, and
// tests/test_torch_generic.py walks the edge).
inline bool widths_ok(int C, int G, int S, int M, bool backward) {
  if (C < 1 || S < 1 || M < 1 || G < 2 || G % 2) return false;
  return smem_bytes(C, G, S, M, backward) <= SMEM_MAX;
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to T and back: the identity at fp32
template <class T>
__device__ __forceinline__ float rnd(float v) { return f32(cvt<T>(v)); }

// The gates take libm's fp32 (tanhf within 2 ulp; the sigmoid from expf
// within 2 ulp and an IEEE division), as the plain versions take them in
// fp32; not the exp2 / reciprocal approximations of hopper.cuh.
__device__ __forceinline__ float sigmoid_f(float b) { return 1.f / (1.f + expf(-b)); }

// Four consecutive values: 16 bytes of fp32 or 8 of bf16, from shared or
// global memory (aligned), to float.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float& at(float4& v, int j) { return reinterpret_cast<float*>(&v)[j]; }

// 16 bytes from global to shared memory in flight (cp.async, L2 only);
// zeros where !valid (src is then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A weight slice of `bytes` bytes, contiguous in the packed layout, into
// dst by 16-byte cp.async, every thread copying the same chunks of every
// slice.
template <int NT, int BYTES>
__device__ __forceinline__ void load_w(float* dst, const float* w) {
  static_assert(BYTES % (16 * NT) == 0, "every thread copies as many chunks");
#pragma unroll
  for (int u = 0; u < BYTES / (16 * NT); ++u) {
    const int i = 4 * (threadIdx.x + u * NT);
    cp16(dst + i, w + i, true);
  }
}

// With PWN_GENERIC_PHASES defined (tools/torch_generic_phases.py builds it
// so), thread 0 of block 0 adds the clock cycles of each phase into
// gen_phase_cycles[base + k]: 0 activations in (the backward's dout tile),
// 1 slice waits, 2 loads issued, 3 products, 4 gates, 5 epilogue; base + 7
// counts tiles.  The layer kernels use base 0, the weight-gradient product 8.
// The sums are kept in shared memory during the tile (a global
// read-modify-write at each mark would stall the thread for an L2 round
// trip and charge it to the next phase) and added to gen_phase_cycles once,
// at GEN_PHASE_TILE.
#ifdef PWN_GENERIC_PHASES
static __device__ unsigned long long gen_phase_cycles[16];
static __shared__ unsigned long long gen_phase_t, gen_phase_sum[16];
#define GEN_PHASE_START()                                                   \
  do {                                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                              \
      for (int k_ = 0; k_ < 16; ++k_) gen_phase_sum[k_] = 0;                \
      gen_phase_t = clock64();                                              \
    }                                                                       \
  } while (0)
#define GEN_PHASE(k)                                                        \
  do {                                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                              \
      const unsigned long long now = clock64();                             \
      gen_phase_sum[k] += now - gen_phase_t;                                \
      gen_phase_t = now;                                                    \
    }                                                                       \
  } while (0)
#define GEN_PHASE_TILE(base)                                                \
  do {                                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                              \
      for (int k_ = (base); k_ < (base) + 7; ++k_)                          \
        gen_phase_cycles[k_] += gen_phase_sum[k_];                          \
      gen_phase_cycles[(base) + 7] += 1;                                    \
    }                                                                       \
  } while (0)
#else
#define GEN_PHASE_START()
#define GEN_PHASE(k)
#define GEN_PHASE_TILE(base)
#endif

// The activation matrix cat = [x(t) | x(t - d) | cond(t)] over the
// flattened (batch, time) rows, zero where t < d in the tap columns.  vec:
// every 16-byte chunk of a row lies in one segment, 16-byte aligned (C and M
// multiples of 16 / sizeof(T)), so the rows stream by cp.async; otherwise
// element by element.
template <class T>
struct Cat {
  const T* x;
  const T* cond;
  long long R;
  int T_, C, M, d;
  int vec;
};

// The rows of cat a thread fills: x(t), x(t - d) (null where t < d) and
// cond(t) of one row, null where the row is past R.
template <class T>
struct CatRow {
  const T *x, *tap, *cond;
};

template <class T>
__device__ __forceinline__ CatRow<T> cat_row(const Cat<T>& c, long long row, bool tap) {
  if (row >= c.R) return {nullptr, nullptr, nullptr};
  return {c.x + row * c.C, tap ? c.x + (row - c.d) * c.C : nullptr, c.cond + row * c.M};
}

// The element k of a row of cat, or null where it is zero.
template <class T>
__device__ __forceinline__ const T* cat_src(const Cat<T>& c, const CatRow<T>& r, int k) {
  if (!r.x) return nullptr;
  if (k < c.C) return r.x + k;
  if (k < 2 * c.C) return r.tap ? r.tap + (k - c.C) : nullptr;
  if (k < 2 * c.C + c.M) return r.cond + (k - 2 * c.C);
  return nullptr;
}

// 16 bytes of a row of cat (k .. k + 16 / sizeof(T)) into dst.
template <class T>
__device__ __forceinline__ void cat_chunk(T* dst, const Cat<T>& c, const CatRow<T>& r, int k) {
  constexpr int V = 16 / sizeof(T);
  if (c.vec) {
    const T* s = cat_src(c, r, k);
    cp16(dst, s ? s : c.x, s != nullptr);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const T* s = cat_src(c, r, k + e);
      dst[e] = s ? *s : cvt<T>(0.f);
    }
  }
}

// The slice cat[r0 + r][k0 .. k0 + BK) of a TM-row tile, as the ring's
// activation slot [TM][AST] (AST = BK + 16 / sizeof(T) elements).  Each
// thread fills the same rows in every slice of a tile: their source rows
// are taken once a tile by `init`.
template <int TM, class T>
struct CatRows {
  static constexpr int V = 16 / sizeof(T), CH = BK / V, J = CH / 2, AST = BK + V;
  static_assert(J >= 1 && (2 * TM) % CH == 0, "a thread's rows are fixed");
  CatRow<T> rows[J];

  __device__ void init(const Cat<T>& c, long long r0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const long long row = r0 + threadIdx.x / CH + j * (2 * TM / CH);
      rows[j] = cat_row(c, row, row < c.R && row % c.T_ >= c.d);
    }
  }

  __device__ void load(T* dst, const Cat<T>& c, int k0) const {
    const int q = threadIdx.x % CH;
#pragma unroll
    for (int j = 0; j < J; ++j)
      cat_chunk(dst + (threadIdx.x / CH + j * (2 * TM / CH)) * AST + q * V, c, rows[j],
                k0 + q * V);
  }
};

// The ring: n slices, `load(s, slot)` issues slice s into a slot,
// `compute(slot, s)` multiplies slice s from its slot.  STAGES - 1 slices
// are in flight while one is multiplied; the barrier at each slice (after
// this thread's cp.async groups) makes it visible and frees the slot the
// next load reuses.  It
// begins with a barrier, so the caller may have written a resident tile (or
// read the ring) just before.  With `issued` the caller has already issued
// (and committed one group each) the first STAGES - 1 slices into their
// slots.  PB is the phase counters' base (GEN_PHASE).
template <int PB = 0, class Load, class Compute>
__device__ __forceinline__ void ring(int n, Load load, Compute compute, bool issued = false) {
  __syncthreads();
  if (!issued) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n) load(s, s);
      cp_commit();
    }
  }
  GEN_PHASE(PB + 2);
  for (int i = 0, slot = 0; i < n; ++i, slot = slot == STAGES - 1 ? 0 : slot + 1) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    GEN_PHASE(PB + 1);
    const int nx = i + STAGES - 1;
    if (nx < n) load(nx, slot == 0 ? STAGES - 1 : slot - 1);
    cp_commit();
    GEN_PHASE(PB + 2);
    compute(slot, i);
    GEN_PHASE(PB + 3);
  }
}

template <int NFR>
__device__ __forceinline__ void zero(float (&acc)[8][4 * NFR]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NFR; ++j) acc[i][j] = 0.f;
}

// The thread's i-th row of a TM-row tile.
template <int TM>
__device__ __forceinline__ int row_of(int i) {
  return (i < 4 ? 0 : TM / 2 - 4) + 4 * (threadIdx.x >> 4) + i;
}

// acc[i][j] += a[row_of(i)][k] * b[k][4 tx + 64 f + j'] over one slice's BK
// k: a row-major (ast elements a row), b a [BK][64 NFR] weight slice.  Sums
// in k order.
template <int TM, int NFR, class TA>
__device__ __forceinline__ void fma_rows(float (&acc)[8][4 * NFR], const TA* a, int ast,
                                         const float* b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const TA* a_lo = a + 4 * ty * ast;
  const TA* a_hi = a + (TM / 2 + 4 * ty) * ast;
  const float* bp = b + 4 * tx;
  // two k quads at a time: unrolled further, the compiler hoists the next
  // quads' fragment loads and runs out of registers; less, it exposes the
  // loads' latency
#pragma unroll 2
  for (int kq = 0; kq < BK; kq += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = ld4(a_lo + i * ast + kq);
      av[4 + i] = ld4(a_hi + i * ast + kq);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 bv[NFR];
#pragma unroll
      for (int f = 0; f < NFR; ++f) bv[f] = ld4(bp + (kq + kk) * (64 * NFR) + 64 * f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = at(av[i], kk);
#pragma unroll
        for (int f = 0; f < NFR; ++f)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][4 * f + j] = fmaf(ai, at(bv[f], j), acc[i][4 * f + j]);
      }
    }
  }
}

// acc[i][j] += a[k][m_i] * b[k][n_j] over one slice's BK k, both k-major
// (the weight-gradient product: k is the data row): m_i = 4 ty + i and
// 32 + 4 ty + i of a 64-wide a (ty < 8), n_j = 4 tx + j and 64 + 4 tx + j
// of a 128-wide b.  With BIAS, bsum[j] += b[k][n_j] too.
template <bool BIAS, class TA>
__device__ __forceinline__ void fma_cols(float (&acc)[8][8], float (&bsum)[8], const TA* a,
                                         const float* b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // four k at a time: unrolled further, the compiler hoists the fragment
  // loads of the whole slice and runs out of registers
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = ld4(a + k * 64 + 4 * ty), a1 = ld4(a + k * 64 + 32 + 4 * ty);
    const float4 b0 = ld4(b + k * NB + 4 * tx), b1 = ld4(b + k * NB + 64 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    if (BIAS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) bsum[j] += bv[j];
    }
  }
}

// Rows r0 .. r0 + tm of an R x w fp32 array into L2, 128 bytes a thread
// at a time: an epilogue reads them after the tile's products.
__device__ __forceinline__ void prefetch_rows(const float* a, long long r0, long long R, int w,
                                              int tm) {
  const int lines = (w + 31) / 32;
  const long long n = (R - r0 < tm ? R - r0 : tm) * lines;
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a + (r0 + i / lines) * w + i % lines * 32));
}

// t of row r0 + r, given t0 = r0 % T_: one wrap at most where T_ >= the
// tile, else a 32-bit remainder.
__device__ __forceinline__ int tile_t(int t0, int r, int T_) {
  const int t = t0 + r;
  return t < T_ ? t : (t - T_ < T_ ? t - T_ : t % T_);
}

}  // namespace gen
