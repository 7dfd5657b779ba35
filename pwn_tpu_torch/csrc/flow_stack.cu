// Whole-stack WaveNet flow forward for Hopper (sm_90a): every gated layer of
// one student IAF flow, emitting only the summed skip output.
//
// Replaces: pwn_tpu/ops/pallas/flow_stack.py::_kernel (reached through
// _flow_stack_fwd_impl / fused_flow_stack), the TPU megakernel that keeps the
// per-layer activation histories in VMEM so inter-layer activations never
// reach device memory.  Per layer l with dilation d_l, for every time t:
//     g   = [x(t) | x(t - d_l) | cond(t)] @ W_in[l] + b_g[l]     fp32 accumulate
//     z   = tanh(g[:G/2]) * sigmoid(g[G/2:])                     fp32, rounded to bf16
//     out = z @ W_out[l] + b_rs[l]                               fp32 accumulate
//     x   = bf16(x + bf16(out[:C]));  skip += out[C:]            skip summed in fp32
// and skip is emitted as bf16.  The rounding order is the Pallas kernel's.
//
// What bounds it on this card: arithmetic.  A sample costs
// 2*(K_in*G + G/2*(C+S)) = 69,632 FLOP per layer, 696,320 per 10-layer stack,
// against 416 bytes of device-memory traffic (x0 and cond in, skip out):
// about 1,700 FLOP per byte, far above the H100's ~295 FLOP/byte ridge.  So
// the work has to run on the tensor cores, and the inter-layer activations
// must stay on chip, or the stack turns memory-bound (each layer's x, z and g
// through device memory would cost ~1 KB per sample per layer).
//
// Design, and what it does about that:
// * The TPU grid runs in order and carries each layer's previous tile in
//   scratch; CUDA blocks run in no order.  So one block owns one (batch row,
//   time segment) and walks it in order in tiles of TT rows.  It starts
//   halo = sum(d_l) samples before its segment from zero history: the top
//   layer's output at t depends on x0 only in [t - sum(d), t], and x0 (the
//   front 1x1 output) is in device memory for all T, so the recomputed halo
//   makes every emitted sample exact.  The segment length is chosen by the
//   caller so that B * segments fills the SMs; the halo is the price.
// * Shared memory holds 227 KB, not 16 MB of VMEM.  Each layer keeps a ring
//   of only its last d_l inputs (sum(d) = 1023 rows for a student flow,
//   147 KB with padding), beside the current x, z and cond tiles.  The ring
//   is read before it is written within a layer step, so d_l rows suffice.
// * The weights (0.7 MB of bf16 per stack) do not fit beside the rings; the
//   warps read their mma B fragments straight from L1/L2.  The weights come
//   stored (out, in), the layout WaveNetStack.stacked() builds once per
//   model, so that each fragment register is one 32-bit load.
// * GEMMs use mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Each warp owns
//   MT row slices and half the columns.  In the gate GEMM a warp's half is
//   the matching tanh and sigmoid columns, so the gated unit is computed
//   in registers; in the out GEMM warps 0-3 own the residual columns and
//   warps 4-7 the skip columns, whose fp32 sum stays in registers across
//   all layers.
// * Rows of x, z, ring and cond are padded by 8 bf16 so that the fragment
//   loads of the 8 rows of an m-tile fall in distinct shared-memory banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;             // residual channels
constexpr int GH = 64;            // gate channels / 2 (tanh half, sigmoid half)
constexpr int G = 2 * GH;         // gate channels
constexpr int S = 64;             // skip channels
constexpr int M = 80;             // conditioning channels (mel bands)
constexpr int K_IN = 2 * C + M;   // gate GEMM depth: [x | shift(x, d) | cond]
constexpr int N_OUT = C + S;      // out GEMM width: [residual | skip]
constexpr int MT = 2;             // 16-row m-tiles per warp
constexpr int TT = 64 * MT;       // rows per time tile
constexpr int NTHREADS = 256;     // 8 warps: 4 row slices x 2 column halves
constexpr int XS = C + 8;         // shared row stride (elements) of x, z, rings
constexpr int CS = M + 8;         // shared row stride (elements) of cond
constexpr int MAX_L = 32;

static_assert(GH == C, "the z tile reuses the x tile's row stride");
static_assert(K_IN % 16 == 0 && C % 16 == 0 && M % 16 == 0, "mma depth");

struct Dilations {
  int d[MAX_L];    // dilation of layer l
  int off[MAX_L];  // first ring row of layer l
};

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// d += a @ b for one 16x8x16 tile; a row-major, b column-major, fp32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block = one (batch row, time segment).  Grid (segments, B).
//   x0     (B, T, C)        bf16   front 1x1 output
//   cond   (B, T, M)        bf16
//   w_in_t (L, G, K_IN)     bf16   W_in stored (out, in): row n holds column n
//   b_g    (L, G)           fp32
//   w_out_t(L, N_OUT, GH)   bf16   W_out stored (out, in)
//   b_rs   (L, N_OUT)       fp32
//   skip   (B, T, S)        bf16   output
__global__ void __launch_bounds__(NTHREADS, 1)
flow_stack_kernel(const bf16* __restrict__ x0, const bf16* __restrict__ cond,
                  const bf16* __restrict__ w_in_t, const float* __restrict__ b_g,
                  const bf16* __restrict__ w_out_t, const float* __restrict__ b_rs,
                  bf16* __restrict__ skip, int T, int L, int seg, int halo,
                  Dilations dils) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // TT x XS: this layer's input
  bf16* zs = xs + TT * XS;                        // TT x XS: gated unit output
  bf16* cs = zs + TT * XS;                        // TT x CS: conditioning
  bf16* ring = cs + TT * CS;                      // halo x XS: per-layer rings

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * seg;
  const int t1 = min(T, t0 + seg);
  const int t_begin = max(0, t0 - halo);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // mma fragment row group, column pair
  const int wm = warp & 3;                // row slice within each 64 rows
  const int wh = warp >> 2;               // column half

  const bf16* x0b = x0 + (size_t)b * T * C;
  const bf16* cb = cond + (size_t)b * T * M;
  bf16* sb = skip + (size_t)b * T * S;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // zero history: exact causal padding at t_begin = 0, and for t_begin > 0
  // the halo makes the difference vanish before t0
  for (int i = tid; i < halo * (XS / 8); i += NTHREADS)
    reinterpret_cast<uint4*>(ring)[i] = zero4;

  for (int s = t_begin; s < t1; s += TT) {
    __syncthreads();  // the previous tile is done with xs, cs and the rings
    for (int i = tid; i < TT * (C / 8); i += NTHREADS) {
      const int r = i / (C / 8), c8 = i % (C / 8);
      uint4 v = zero4;
      if (s + r < T)
        v = __ldg(reinterpret_cast<const uint4*>(x0b + (size_t)(s + r) * C) + c8);
      reinterpret_cast<uint4*>(xs + r * XS)[c8] = v;
    }
    for (int i = tid; i < TT * (M / 8); i += NTHREADS) {
      const int r = i / (M / 8), c8 = i % (M / 8);
      uint4 v = zero4;
      if (s + r < T)
        v = __ldg(reinterpret_cast<const uint4*>(cb + (size_t)(s + r) * M) + c8);
      reinterpret_cast<uint4*>(cs + r * CS)[c8] = v;
    }

    float sacc[MT][8][4];  // skip sum (warps with wh == 1)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[mi][j][e] = 0.f;

    __syncthreads();

    for (int l = 0; l < L; ++l) {
      const int d = dils.d[l];
      bf16* rl = ring + dils.off[l] * XS;

      // ---- gate GEMM: (TT x K_IN) @ (K_IN x G), this warp's 8 n-tiles:
      // tanh columns wh*32 + [0, 32) and the matching sigmoid columns
      const bf16* rows_x[MT][2];
      const bf16* rows_sh[MT][2];
      const bf16* rows_c[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = mi * 64 + wm * 16 + g + 8 * hh;
          rows_x[mi][hh] = xs + r * XS;
          rows_c[mi][hh] = cs + r * CS;
          // x(t - d): inside this tile, or in the ring at slot (t - d) mod d
          rows_sh[mi][hh] = (r >= d) ? xs + (r - d) * XS : rl + ((s + r) % d) * XS;
        }

      float acc[MT][8][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

      const bf16* wl = w_in_t + (size_t)l * G * K_IN;
#pragma unroll
      for (int ks = 0; ks < K_IN / 16; ++ks) {
        uint32_t bfr[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = (j < 4 ? 0 : GH) + wh * 32 + (j & 3) * 8 + g;
          const bf16* wp = wl + (size_t)n * K_IN + ks * 16 + 2 * q;
          bfr[j][0] = ldg32(wp);
          bfr[j][1] = ldg32(wp + 8);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const bf16 *p0, *p1;
          int col;
          if (ks < C / 16) {
            p0 = rows_x[mi][0]; p1 = rows_x[mi][1]; col = ks * 16;
          } else if (ks < 2 * C / 16) {
            p0 = rows_sh[mi][0]; p1 = rows_sh[mi][1]; col = ks * 16 - C;
          } else {
            p0 = rows_c[mi][0]; p1 = rows_c[mi][1]; col = ks * 16 - 2 * C;
          }
          uint32_t a[4];
          a[0] = lds32(p0 + col + 2 * q);
          a[1] = lds32(p1 + col + 2 * q);
          a[2] = lds32(p0 + col + 8 + 2 * q);
          a[3] = lds32(p1 + col + 8 + 2 * q);
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_bf16(acc[mi][j], a, bfr[j][0], bfr[j][1]);
        }
      }

      // ---- gated unit in fp32, rounded to bf16 into zs
      const float* bgl = b_g + (size_t)l * G;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wh * 32 + j * 8 + 2 * q;
          const float ba0 = bgl[col], ba1 = bgl[col + 1];
          const float bb0 = bgl[GH + col], bb1 = bgl[GH + col + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = mi * 64 + wm * 16 + g + 8 * hh;
            const float z0 = tanhf(acc[mi][j][2 * hh] + ba0) /
                             (1.f + expf(-(acc[mi][j + 4][2 * hh] + bb0)));
            const float z1 = tanhf(acc[mi][j][2 * hh + 1] + ba1) /
                             (1.f + expf(-(acc[mi][j + 4][2 * hh + 1] + bb1)));
            *reinterpret_cast<__nv_bfloat162*>(zs + r * XS + col) =
                __floats2bfloat162_rn(z0, z1);
          }
        }

      __syncthreads();  // zs complete; every read of xs and this ring is done

      // ---- ring update: keep this layer's last d inputs for the next tile
      {
        const int r0 = d >= TT ? 0 : TT - d;
        for (int i = tid; i < (TT - r0) * (C / 8); i += NTHREADS) {
          const int r = r0 + i / (C / 8), c8 = i % (C / 8);
          reinterpret_cast<uint4*>(rl + ((s + r) % d) * XS)[c8] =
              reinterpret_cast<const uint4*>(xs + r * XS)[c8];
        }
      }

      // ---- out GEMM: (TT x GH) @ (GH x N_OUT), columns wh*64 + [0, 64)
      float oacc[MT][8][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[mi][j][e] = 0.f;

      const bf16* wo = w_out_t + (size_t)l * N_OUT * GH;
#pragma unroll
      for (int ks = 0; ks < GH / 16; ++ks) {
        uint32_t bfr[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* wp = wo + (size_t)(wh * 64 + j * 8 + g) * GH + ks * 16 + 2 * q;
          bfr[j][0] = ldg32(wp);
          bfr[j][1] = ldg32(wp + 8);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const bf16* p0 = zs + (mi * 64 + wm * 16 + g) * XS + ks * 16 + 2 * q;
          const bf16* p1 = p0 + 8 * XS;
          uint32_t a[4];
          a[0] = lds32(p0);
          a[1] = lds32(p1);
          a[2] = lds32(p0 + 8);
          a[3] = lds32(p1 + 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_bf16(oacc[mi][j], a, bfr[j][0], bfr[j][1]);
        }
      }

      __syncthreads();  // the ring update has read xs

      // ---- epilogue: residual into xs (bf16 each layer), skip in fp32
      const float* brl = b_rs + (size_t)l * N_OUT;
      if (wh == 0) {
        if (l + 1 < L) {  // the last layer's residual output is not needed
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = j * 8 + 2 * q;
              const float bias0 = brl[col], bias1 = brl[col + 1];
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = mi * 64 + wm * 16 + g + 8 * hh;
                __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(xs + r * XS + col);
                const float2 xo = __bfloat1622float2(*xp);
                const float o0 = __bfloat162float(__float2bfloat16_rn(oacc[mi][j][2 * hh] + bias0));
                const float o1 = __bfloat162float(__float2bfloat16_rn(oacc[mi][j][2 * hh + 1] + bias1));
                *xp = __floats2bfloat162_rn(xo.x + o0, xo.y + o1);
              }
            }
        }
      } else {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = C + j * 8 + 2 * q;
            const float bias0 = brl[col], bias1 = brl[col + 1];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              sacc[mi][j][2 * hh] += oacc[mi][j][2 * hh] + bias0;
              sacc[mi][j][2 * hh + 1] += oacc[mi][j][2 * hh + 1] + bias1;
            }
          }
      }
      __syncthreads();  // xs holds the next layer's input
    }

    // ---- emit the skip sum for the rows of this block's own segment
    if (wh == 1) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = s + mi * 64 + wm * 16 + g + 8 * hh;
          if (t >= t0 && t < t1) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<__nv_bfloat162*>(sb + (size_t)t * S + j * 8 + 2 * q) =
                  __floats2bfloat162_rn(sacc[mi][j][2 * hh], sacc[mi][j][2 * hh + 1]);
          }
        }
    }
  }
}

}  // namespace

extern "C" {

// Rows per time tile; the caller rounds its segment length to a multiple.
int pwn_flow_stack_tile_rows() { return TT; }

// Dynamic shared memory of one block for a stack with sum(dilations) = ring_rows.
long long pwn_flow_stack_smem_bytes(int ring_rows) {
  return (long long)(2 * TT + ring_rows) * XS * 2 + (long long)TT * CS * 2;
}

const char* pwn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the stack on `stream`; returns a cudaError_t (0 on success).
int pwn_flow_stack_bf16(const void* x0, const void* cond, const void* w_in_t,
                        const void* b_g, const void* w_out_t, const void* b_rs,
                        void* skip, int B, int T, int L, int c, int g, int s,
                        int m, const int* dilations, int seg, void* stream) {
  if (c != C || g != G || s != S || m != M) return cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || T < 1 || L < 1 || L > MAX_L || seg < 1)
    return cudaErrorInvalidValue;
  Dilations dl;
  int ring_rows = 0;
  for (int l = 0; l < MAX_L; ++l) {
    dl.d[l] = 1;
    dl.off[l] = 0;
  }
  for (int l = 0; l < L; ++l) {
    if (dilations[l] < 1) return cudaErrorInvalidValue;
    dl.d[l] = dilations[l];
    dl.off[l] = ring_rows;
    ring_rows += dilations[l];
  }
  const long long smem = pwn_flow_stack_smem_bytes(ring_rows);
  cudaError_t err = cudaFuncSetAttribute(
      flow_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + seg - 1) / seg, B);
  flow_stack_kernel<<<grid, NTHREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x0), static_cast<const bf16*>(cond),
      static_cast<const bf16*>(w_in_t), static_cast<const float*>(b_g),
      static_cast<const bf16*>(w_out_t), static_cast<const float*>(b_rs),
      static_cast<bf16*>(skip), T, L, seg, ring_rows, dl);
  return cudaGetLastError();
}

}  // extern "C"
