// One WaveNet gated residual layer for Hopper (sm_90a): its residual and skip
// outputs, for the stacks the whole-stack kernel (flow_stack.cu) cannot take.
//
// Replaces: pwn_tpu/ops/pallas/gated_layer.py::_kernel (reached through
// _fused_forward / fused_gated_residual), the per-layer kernel the reference
// runs when its whole-stack kernel is ineligible.  For every batch row b and
// time t, with dilation d:
//     g    = [x(t) | x(t - d) | cond(t)] @ W_in + b_g     fp32 accumulate, b_g fp32
//     z    = bf16(tanh(g[:G/2]) * sigmoid(g[G/2:]))
//     out  = bf16(z @ W_out + b_out)                      fp32 accumulate, b_out fp32
//     res  = bf16(x + out[:C]),   skip = out[C:]
// with x(t - d) = 0 for t < d.  These are the Pallas kernel's rounding points;
// the biases arrive unrounded in fp32, as `_fused_forward` passes them.
//
// What bounds it on this card.  At C=128, G=256, S=128, M=80 a sample costs
// 2*(336*256 + 128*256) = 237,568 FLOP against 928 bytes of device memory
// (x and cond read, res and skip written): 256 FLOP per byte, just under the
// H100's ~295 FLOP/byte ridge, so the bytes bound it (0.106 ms at batch
// 8 x 47,872), with the operations close behind (0.092 ms).  At C=64 it is
// 69,632 FLOP against 544 bytes, 128 FLOP per byte: bytes again.  So every
// intermediate (g, z, out) stays on chip, x and cond are read once per block
// and the tap x(t - d) comes from L2, and the GEMMs must run on the tensor
// cores to keep up with the memory.
//
// Design, and what it does about the TPU kernel's assumptions:
// * The Pallas grid reads two BlockSpec views of x (time tile i and tile
//   i - 1) to form the tap, so it needs d <= its 512-row tile, and it pads T
//   to a tile multiple.  Here each layer is its own launch and x lies whole
//   in device memory, so a block over (64-row time tile, batch row) loads the
//   rows x(t - d) straight from it: no second view, no padding (rows before
//   t = 0 and past T are masked), any dilation, and no order between blocks.
// * The weights are 172 KB (W_in) + 64 KB (W_out) of bf16 per layer at C=128,
//   more than a block's 227 KB of shared memory beside its tiles.  The warps
//   read their mma B fragments from L1/L2, as flow_stack.cu and
//   flow_stack_train.cu do; the weights come stored (out, in), so each
//   fragment register is one 32-bit load, and every block of the launch reads
//   the same 236 KB, which stays in L2.
// * GEMMs use mma.sync m16n8k16 (bf16 in, fp32 accumulate).  8 warps: 4 row
//   slices x 2 column halves.  In the gate GEMM a warp's half is the matching
//   tanh and sigmoid columns, so z is formed in registers; in the out GEMM
//   warps 0-3 own the residual columns and warps 4-7 the skip columns.
// * Rows of the shared tiles are padded by 8 bf16 so that the fragment loads
//   of the 8 rows of an m-tile fall in distinct banks.
// * Built at two widths: (C, G, S, M) = (64, 128, 64, 80) (student_iaf) and
//   (128, 256, 128, 80) (large_student_sharded, teacher_lj).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TT = 64;         // rows per block: 4 row slices of 16
constexpr int NTHREADS = 256;  // 8 warps: 4 row slices x 2 column halves

template <int C_, int G_, int S_, int M_>
struct Dims {
  static constexpr int C = C_, G = G_, S = S_, M = M_;
  static constexpr int GH = G / 2;        // tanh half, sigmoid half
  static constexpr int K_IN = 2 * C + M;  // gate GEMM depth [x | shift | cond]
  static constexpr int N_OUT = C + S;     // out GEMM width [residual | skip]
  static constexpr int XS = C + 8;        // shared row strides (bf16), padded
  static constexpr int CS = M + 8;
  static constexpr int ZS = GH + 8;
  static constexpr int NT_G = GH / 16;    // tanh n-tiles per warp (+ sigmoid)
  static constexpr int NT_O = N_OUT / 16; // out n-tiles per warp
  static_assert(C == S, "warp halves of the out GEMM are [residual | skip]");
  static_assert(C % 16 == 0 && M % 16 == 0 && GH % 16 == 0, "mma depth");
  static constexpr size_t SMEM = (size_t)TT * (2 * XS + CS + ZS) * 2;
};

using Narrow = Dims<64, 128, 64, 80>;
using Wide = Dims<128, 256, 128, 80>;

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// d += a @ b for one 16x8x16 tile; a row-major, b column-major, fp32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0, r0 + 8 and columns col + [0, 16) of a shared tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int stride, int r0, int col, int q) {
  const bf16* p0 = tile + r0 * stride + col + 2 * q;
  const bf16* p1 = p0 + 8 * stride;
  a[0] = lds32(p0);
  a[1] = lds32(p1);
  a[2] = lds32(p0 + 8);
  a[3] = lds32(p1 + 8);
}

// Rows t0 + [0, TT) of one batch row's (T, W) matrix, each shifted back by
// `shift` samples, into a shared tile; zero before t = 0 and past T.
template <int W, int STRIDE>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int t0,
                                          int shift, int T) {
  for (int i = threadIdx.x; i < TT * (W / 8); i += NTHREADS) {
    const int r = i / (W / 8), c8 = i % (W / 8);
    const long long t = (long long)t0 + r - shift;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T && t >= 0)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)t * W) + c8);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + c8 * 8) = v;
  }
}

// One layer.  Block = (time tile, batch row), grid (tiles, B).
//   x     (B, T, C)   bf16   the layer's input
//   cond  (B, T, M)   bf16
//   w_in  (G, K_IN)   bf16   W_in stored (out, in): input columns [x | shift | cond]
//   b_g   (G)         fp32
//   w_out (N_OUT, GH) bf16   W_out stored (out, in): output rows [residual | skip]
//   b_out (N_OUT)     fp32
//   res   (B, T, C), skip (B, T, S)  bf16 outputs
template <class D>
__global__ void __launch_bounds__(NTHREADS, 2)
gated_layer_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cond,
                   const bf16* __restrict__ w_in, const float* __restrict__ b_g,
                   const bf16* __restrict__ w_out, const float* __restrict__ b_out,
                   bf16* __restrict__ res, bf16* __restrict__ skip, int T, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // TT x XS: x(t)
  bf16* sh = xs + TT * D::XS;                     // TT x XS: x(t - d)
  bf16* cs = sh + TT * D::XS;                     // TT x CS: cond(t)
  bf16* zs = cs + TT * D::CS;                     // TT x ZS: z

  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row group, column pair
  const int wm = warp & 3, wh = warp >> 2;
  const size_t rb = (size_t)b * T;        // first row of this batch row

  load_rows<D::C, D::XS>(xs, x + rb * D::C, t0, 0, T);
  load_rows<D::C, D::XS>(sh, x + rb * D::C, t0, d, T);
  load_rows<D::M, D::CS>(cs, cond + rb * D::M, t0, 0, T);
  __syncthreads();

  {
    // gate GEMM: rows wm*16 + [0, 16) of [xs | sh | cs] times this warp's
    // tanh columns wh*GH/2 + [0, GH/2) (acc[0, NT_G)) and the matching sigmoid
    // columns (acc[NT_G, 2 NT_G))
    float acc[2 * D::NT_G][4];
#pragma unroll
    for (int j = 0; j < 2 * D::NT_G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D::K_IN / 16; ++ks) {
      uint32_t a[4];
      if (ks < D::C / 16)
        load_a(a, xs, D::XS, wm * 16 + g, ks * 16, q);
      else if (ks < 2 * D::C / 16)
        load_a(a, sh, D::XS, wm * 16 + g, ks * 16 - D::C, q);
      else
        load_a(a, cs, D::CS, wm * 16 + g, ks * 16 - 2 * D::C, q);
#pragma unroll
      for (int j = 0; j < 2 * D::NT_G; ++j) {
        const int n = (j < D::NT_G ? 0 : D::GH) + wh * (D::GH / 2) +
                      (j % D::NT_G) * 8 + g;
        const bf16* wp = w_in + (size_t)n * D::K_IN + ks * 16 + 2 * q;
        mma_bf16(acc[j], a, ldg32(wp), ldg32(wp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < D::NT_G; ++j) {
      const int col = wh * (D::GH / 2) + j * 8 + 2 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 16 + g + 8 * hh;
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          z[e] = tanhf(acc[j][2 * hh + e] + b_g[col + e]) *
                 sigmoidf(acc[D::NT_G + j][2 * hh + e] + b_g[D::GH + col + e]);
        *reinterpret_cast<uint32_t*>(zs + r * D::ZS + col) = pack(z[0], z[1]);
      }
    }
  }
  __syncthreads();

  // out GEMM: warps with wh == 0 own the residual columns, wh == 1 the skip
  float acc[D::NT_O][4];
#pragma unroll
  for (int j = 0; j < D::NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D::GH / 16; ++ks) {
    uint32_t a[4];
    load_a(a, zs, D::ZS, wm * 16 + g, ks * 16, q);
#pragma unroll
    for (int j = 0; j < D::NT_O; ++j) {
      const bf16* wp = w_out + (size_t)(wh * (D::N_OUT / 2) + j * 8 + g) * D::GH +
                       ks * 16 + 2 * q;
      mma_bf16(acc[j], a, ldg32(wp), ldg32(wp + 8));
    }
  }

  const float* bias = b_out + wh * D::C;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wm * 16 + g + 8 * hh;
    const int t = t0 + r;
    if (t >= T) continue;
    const size_t row = rb + t;
#pragma unroll
    for (int j = 0; j < D::NT_O; ++j) {
      const int col = j * 8 + 2 * q;  // within the warp half's C (or S) columns
      const float o0 = round_bf16(acc[j][2 * hh] + bias[col]);
      const float o1 = round_bf16(acc[j][2 * hh + 1] + bias[col + 1]);
      if (wh == 0) {
        const float2 xo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * D::XS + col));
        *reinterpret_cast<uint32_t*>(res + row * D::C + col) = pack(xo.x + o0, xo.y + o1);
      } else {
        *reinterpret_cast<uint32_t*>(skip + row * D::S + col) = pack(o0, o1);
      }
    }
  }
}

template <class D>
int launch(const void* x, const void* cond, const void* w_in, const void* b_g,
           const void* w_out, const void* b_out, void* res, void* skip, int B,
           int T, int d, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gated_layer_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((T + TT - 1) / TT), (unsigned)B);
  gated_layer_kernel<D><<<grid, NTHREADS, D::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(cond),
      static_cast<const bf16*>(w_in), static_cast<const float*>(b_g),
      static_cast<const bf16*>(w_out), static_cast<const float*>(b_out),
      static_cast<bf16*>(res), static_cast<bf16*>(skip), T, d);
  return cudaGetLastError();
}

template <class D>
bool is(int c, int g, int s, int m) {
  return c == D::C && g == D::G && s == D::S && m == D::M;
}

}  // namespace

extern "C" {

// Kernel 5: one gated residual layer on `stream`.  Returns a cudaError_t (0 on
// success); cudaErrorInvalidValue for widths it is not built for.
int pwn_gated_layer_bf16(const void* x, const void* cond, const void* w_in,
                         const void* b_g, const void* w_out, const void* b_out,
                         void* res, void* skip, int B, int T, int c, int g, int s,
                         int m, int dilation, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || dilation < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is<Narrow>(c, g, s, m))
    return launch<Narrow>(x, cond, w_in, b_g, w_out, b_out, res, skip, B, T, dilation, st);
  if (is<Wide>(c, g, s, m))
    return launch<Wide>(x, cond, w_in, b_g, w_out, b_out, res, skip, B, T, dilation, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
