// What the general-width bodies of kernels 5 and 3 share
// (gated_layer_generic.cu, flow_stack_train_generic.cu): the tile shape, the
// operand types, the gates in fp32 libm, and the blocked product of a
// shared-memory activation tile by weights streamed through a shared-memory
// k-slice.
//
// The general bodies take any width within one block's shared memory, with
// fp32 or bf16 operands, and do every product and every gate in fp32 FMAs
// on the CUDA cores.  wgmma has no fp32 operand (its tf32 mode rounds the
// mantissa to 10 bits), and the port's fp32 means fp32.
//
// The tile: a block of NT = 256 threads owns TM = 64 consecutive rows of
// the flattened (batch, time) axis.  Its activations sit in shared memory
// transposed, [k][row] with a row stride of AS floats, so that one 16-byte
// load gives a thread the four rows it owns.  An output chunk is TM x NB
// (64 x 64); thread (ty, tx) = (tid / 16, tid % 16) holds rows 4 ty + [0, 4)
// and columns 4 tx + [0, 4) in a 4 x 4 register tile.  The weights of the
// chunk stream through one shared-memory slice of KS k-rows by NB columns
// (stride WS), filled by all threads between two barriers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gen {

using bf16 = __nv_bfloat16;

constexpr int TM = 64;        // rows per tile
constexpr int NT = 256;       // threads per block
constexpr int NB = 64;        // columns per output chunk
constexpr int KS = 32;        // k-rows per weight slice
constexpr int AS = TM + 4;    // row stride of the [k][row] tiles, in floats
constexpr int WS = NB + 4;    // row stride of the weight slice, in floats
constexpr int SMEM_MAX = 232448;  // a block's opt-in shared memory on H100
static_assert(AS == WS, "one product routine reads both strides");

// Shared memory of a general body's block: the [k][row] tiles (the forward:
// [x | tap | cond] and z; the backward also dout, then dg over it) and the
// weight slice.  The same formula is `generic_smem_bytes` in
// pwn_tpu_torch/ops/flow_stack.py.
__host__ __device__ inline long long smem_bytes(int C, int G, int S, int M, bool backward) {
  const long long rows = 2LL * C + M + G / 2 + (backward ? (C + S > G ? C + S : G) : 0);
  return (rows + KS) * AS * 4;
}

// The widths a general body takes: C, S, M >= 1, an even G >= 2, and its
// block's shared memory within SMEM_MAX.
inline bool widths_ok(int C, int G, int S, int M, bool backward) {
  return C >= 1 && S >= 1 && M >= 1 && G >= 2 && G % 2 == 0 &&
         smem_bytes(C, G, S, M, backward) <= SMEM_MAX;
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

// The tile [x(t) | x(t - d) | cond(t)] of rows r0 + [0, TM) into a_t
// [2C + M][AS] as fp32, zero where t < d (the causal tap) and past row R.
// Rows are the flattened (batch, time) axis of T_ steps a batch row, so the
// tap x(t - d) is row - d whenever t >= d.
template <class T>
__device__ void load_cat(float* a_t, const T* __restrict__ x, const T* __restrict__ cond,
                         long long r0, long long R, int T_, int C, int M, int d) {
  const int K = 2 * C + M;
  for (int i = threadIdx.x; i < TM * K; i += NT) {
    const int k = i % K, r = i / K;
    const long long row = r0 + r;
    float v = 0.f;
    if (row < R) {
      if (k < C)
        v = f32(x[row * C + k]);
      else if (k < 2 * C) {
        if (row % T_ >= d) v = f32(x[(row - d) * C + k - C]);
      } else {
        v = f32(cond[row * M + k - 2 * C]);
      }
    }
    a_t[k * AS + r] = v;
  }
}

// acc[i][j] += a[k][4 ty + i] * b[k][4 tx + j] over k < n: this thread's
// 4 x 4 tile, a and b [k][...] tiles of row stride AS (= WS)
__device__ __forceinline__ void fma_tile(float (&acc)[4][4], const float* a, const float* b,
                                         int n) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  a += 4 * ty;
  b += 4 * tx;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * AS);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * WS);
    const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// acc = a_t[0:K][rows]^T @ W[0:K][chunk] for this thread's 4 x 4 tile, the
// weights taken as w(k, c) (c in [0, NB), zero outside the chunk) through
// the slice ws.  K_CONTIG says which index of w is contiguous in memory, so
// that consecutive threads fill the slice from consecutive addresses.  All
// threads of the block call it; it starts with a barrier, so the caller may
// have written a_t (or read ws) just before.
template <bool K_CONTIG, class F>
__device__ void chunk_product(float (&acc)[4][4], const float* a_t, int K, float* ws, F w) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KS) {
    const int n = K - k0 < KS ? K - k0 : KS;
    __syncthreads();  // the slice before is read, the tiles are written
    for (int i = threadIdx.x; i < KS * NB; i += NT) {
      const int kk = K_CONTIG ? i % KS : i / NB, c = K_CONTIG ? i / KS : i % NB;
      ws[kk * WS + c] = kk < n ? w(k0 + kk, c) : 0.f;
    }
    __syncthreads();
    fma_tile(acc, a_t + k0 * AS, ws, n);
  }
}

}  // namespace gen
