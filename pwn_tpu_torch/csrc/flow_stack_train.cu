// Whole-stack WaveNet training pass for Hopper (sm_90a): the forward that
// saves every layer's input, and its fused backward with weight gradients.
//
// Replaces:
//   kernel 2  pwn_tpu/ops/pallas/flow_stack.py::_fwd_save_kernel
//             (via _flow_stack_train_fwd_impl / fused_flow_stack_train)
//   kernel 3  pwn_tpu/ops/pallas/flow_stack.py::_bwd_chunk_kernel
//             (via _flow_stack_train_bwd_impl), both want_wgrads modes.
//
// Forward, per layer l with dilation d, for every time t (as flow_stack.cu):
//     acts[l] = x
//     g   = [x(t) | x(t - d) | cond(t)] @ W_in[l] + b_g[l]      fp32 accumulate
//     z   = bf16(tanh(g[:G/2]) * sigmoid(g[G/2:]))
//     out = z @ W_out[l] + b_rs[l]                              fp32 accumulate
//     x   = bf16(x + bf16(out[:C]));  skip += out[C:]           skip in fp32
// Backward, layers in reverse, dx the cotangent of layer l's output (0 above
// the top layer, whose residual output is not used):
//     dout = bf16([dx | dskip]);  dz = dout @ W_out[l]^T
//     dg   = bf16([dz*sb*(1-ta^2) | dz*ta*sb*(1-sb)])  (ta, sb recomputed)
//     dcat = dg @ W_in[l]^T = [dcx | dcs | dcc]
//     dx  <- (dx + dcx)(t) + dcs(t + d);  dcond += dcc          all fp32
//     dW_in[l] = cat^T dg, db_g[l] = sum dg, dW_out[l] = z^T dout,
//     db_rs[l] = sum dout                                         fp32
// The rounding points are the Pallas kernels' (dout, dg and z to bf16; the
// gates, dz and every sum in fp32).  Two of its roundings come from the TPU's
// tile and chunk layout and are not kept: the tap cotangent crossing a tile
// and dx crossing a layer chunk stay fp32 here.
//
// What bounds it on this card.  At teacher_lj widths (C=128, G=256, S=128,
// M=80) a sample costs 237,568 FLOP per layer forward and about 3x that
// backward with weight gradients, against 256 bytes of acts written (read
// back in the backward) per layer: ~930 FLOP per byte forward, above the
// H100's ~295 FLOP/byte ridge, so the GEMMs run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate).
//
// Design, and what it does about the TPU kernels' assumptions:
// * Grid order.  The TPU grid runs its time tiles in order and carries each
//   layer's previous tile (forward) or the tap cotangent of the earlier tile
//   (backward) in VMEM scratch.  CUDA blocks run in no order, so there is no
//   carry: every layer is one launch over (time tile, batch row) blocks.  The
//   forward writes acts[l+1] anyway (the backward needs it), so the dilated
//   tap x_l(t - d) is read back from acts[l] in device memory: no halo and no
//   ring.  (flow_stack.cu's per-layer rings would need sum(d)*(C+8)*2 =
//   208 KB at these widths, more than a block has beside its tiles.)  The
//   skip sum lives in an fp32 (B, T, S) buffer across the launches.
// * The tap cotangent crosses blocks: dx_l(t) needs dcs(t + d) from rows of
//   the next tile.  Each backward launch writes dpart = dx + dcx and dcs to
//   device memory; the next (lower) layer's launch reads dpart(t) +
//   dcs(t + d) as its dx.  dcs alternates between two buffers, since a block
//   reads other blocks' rows of it.  A last pass folds layer 0's dcs into dx.
// * Weight gradients.  The TPU kernel keeps fp32 accumulators resident
//   across the whole grid.  Here each backward launch stores dg, dout and z
//   (bf16, as the reference rounds them), and a split-K kernel forms
//   cat^T dg and z^T dout over row ranges into fp32 partials, which a second
//   pass sums in a fixed order: the result is the same on every run.  The
//   bias gradients ride along as a column of ones appended to cat and z.
// * Weights (5.7 MB bf16 per stack) do not fit in shared memory; the warps
//   read their mma B fragments from L1/L2.  The forward reads W_in (G, K) and
//   W_out (C+S, G/2) stored (out, in), as WaveNetStack.stacked() builds them;
//   the backward also takes them transposed, so that every fragment register
//   is one 32-bit load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TT = 64;          // rows per time tile: 4 row slices of 16
constexpr int NTHREADS = 256;   // 8 warps: 4 row slices x 2 column halves
constexpr int WG_ROWS = 32;     // rows per stage of the weight-gradient GEMM
constexpr int WG_K = 64;        // weight-gradient output tile: 64 x 128
constexpr int WG_N = 128;
constexpr int WG_RS = WG_ROWS + 8;  // shared row stride of its transposed tiles

template <int C_, int G_, int S_, int M_>
struct Dims {
  static constexpr int C = C_, G = G_, S = S_, M = M_;
  static constexpr int GH = G / 2;        // tanh half, sigmoid half
  static constexpr int K_IN = 2 * C + M;  // gate GEMM depth [x | shift | cond]
  static constexpr int N_OUT = C + S;     // out GEMM width [residual | skip]
  static constexpr int XS = C + 8;        // shared row strides (bf16), padded
  static constexpr int CS = M + 8;        //   by 8 so the 8 rows of a fragment
  static constexpr int ZS = GH + 8;       //   load fall in distinct banks
  static constexpr int DS = N_OUT + 8;
  static constexpr int GS = G + 8;
  static constexpr int NT_G = GH / 16;    // tanh n-tiles per warp (+ sigmoid)
  static constexpr int NT_O = N_OUT / 16; // out n-tiles per warp
  static constexpr int NT_D = K_IN / 16;  // dcat n-tiles per warp
  static constexpr int K1_IN = ((K_IN + 1 + WG_K - 1) / WG_K) * WG_K;
  static constexpr int K1_OUT = ((GH + 1 + WG_K - 1) / WG_K) * WG_K;
  static_assert(C == S, "warp halves of the out GEMM are [residual | skip]");
  static_assert(C % 16 == 0 && M % 16 == 0 && GH % 16 == 0, "mma depth");
  static_assert(K_IN % 16 == 0 && N_OUT % 16 == 0, "two column halves");
  static_assert(G % WG_N == 0 && N_OUT % WG_N == 0, "weight-gradient tiles");
  static constexpr size_t FWD_SMEM = (size_t)TT * (2 * XS + CS + ZS) * 2;
  static constexpr size_t BWD_SMEM =
      (size_t)TT * (2 * XS + CS + DS + GS + ZS) * 2 + (size_t)TT * C * 4;
};

using Teacher = Dims<128, 256, 128, 80>;

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
    const int t = t0 + r - shift;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T && t >= 0)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)t * W) + c8);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + c8 * 8) = v;
  }
}

// The gate GEMM of one warp: rows wm*16 + [0, 16) of [xs | sh | cs] times the
// tanh columns wh*GH/2 + [0, GH/2) (acc[0, NT_G)) and the matching sigmoid
// columns (acc[NT_G, 2 NT_G)) of W_in, stored (G, K_IN).
template <class D>
__device__ __forceinline__ void gate_gemm(float (&acc)[2 * D::NT_G][4],
                                          const bf16* xs, const bf16* sh,
                                          const bf16* cs, const bf16* w,
                                          int wm, int wh, int g, int q) {
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
      const bf16* wp = w + (size_t)n * D::K_IN + ks * 16 + 2 * q;
      mma_bf16(acc[j], a, ldg32(wp), ldg32(wp + 8));
    }
  }
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// ---------------------------------------------------------------- kernel 2
// One layer of the forward.  Block = (time tile, batch row), grid (tiles, B).
//   x_in   (B, T, C)  bf16   acts[l]
//   x_out  (B, T, C)  bf16   acts[l + 1], or null for the last layer
//   cond   (B, T, M)  bf16
//   w_in   (G, K_IN)  bf16   this layer's W_in stored (out, in)
//   w_out  (N_OUT, GH) bf16  this layer's W_out stored (out, in)
//   b_g (G), b_rs (N_OUT) fp32
//   skip32 (B, T, S)  fp32   running skip sum (written at the first layer)
//   skip   (B, T, S)  bf16   output, written by the last layer only
template <class D>
__global__ void __launch_bounds__(NTHREADS, 2)
train_fwd_layer(const bf16* __restrict__ x_in, bf16* __restrict__ x_out,
                const bf16* __restrict__ cond, const bf16* __restrict__ w_in,
                const float* __restrict__ b_g, const bf16* __restrict__ w_out,
                const float* __restrict__ b_rs, float* __restrict__ skip32,
                bf16* __restrict__ skip, int T, int d, int first, int last) {
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

  load_rows<D::C, D::XS>(xs, x_in + rb * D::C, t0, 0, T);
  load_rows<D::C, D::XS>(sh, x_in + rb * D::C, t0, d, T);
  load_rows<D::M, D::CS>(cs, cond + rb * D::M, t0, 0, T);
  __syncthreads();

  {
    float acc[2 * D::NT_G][4];
    gate_gemm<D>(acc, xs, sh, cs, w_in, wm, wh, g, q);
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

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wm * 16 + g + 8 * hh;
    const int t = t0 + r;
    if (t >= T) continue;
    const size_t row = rb + t;
#pragma unroll
    for (int j = 0; j < D::NT_O; ++j) {
      const int col = j * 8 + 2 * q;  // within the warp half's C (or S) columns
      if (wh == 0) {
        if (x_out == nullptr) continue;
        const float o0 = __bfloat162float(__float2bfloat16_rn(acc[j][2 * hh] + b_rs[col]));
        const float o1 = __bfloat162float(__float2bfloat16_rn(acc[j][2 * hh + 1] + b_rs[col + 1]));
        const float2 xo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * D::XS + col));
        *reinterpret_cast<uint32_t*>(x_out + row * D::C + col) = pack(xo.x + o0, xo.y + o1);
      } else {
        float s0 = acc[j][2 * hh] + b_rs[D::C + col];
        float s1 = acc[j][2 * hh + 1] + b_rs[D::C + col + 1];
        float2* sp = reinterpret_cast<float2*>(skip32 + row * D::S + col);
        if (!first) {
          const float2 prev = *sp;
          s0 = prev.x + s0;
          s1 = prev.y + s1;
        }
        if (last)
          *reinterpret_cast<uint32_t*>(skip + row * D::S + col) = pack(s0, s1);
        else
          *sp = make_float2(s0, s1);
      }
    }
  }
}

// ---------------------------------------------------------------- kernel 3
// One layer of the backward.  Block = (time tile, batch row).
//   acts_l  (B, T, C) bf16     this layer's saved input
//   dskip   (B, T, S) bf16
//   w_in (G, K_IN), w_in_kg (K_IN, G), w_out_kn (GH, N_OUT) bf16
//   dpart   (B, T, C) fp32     in: dx + dcx of the layer above; out: this one's
//   dcs_prev(B, T, C) fp32     tap cotangent of the layer above (d_prev)
//   dcs_cur (B, T, C) fp32     this layer's tap cotangent
//   dcond32 (B, T, M) fp32     running dcond (written by the top layer)
//   dout_g, dg_g, z_g          bf16 (B, T, N_OUT / G / GH) for the weight
//                              gradients, or null in the dx-only mode
template <class D>
__global__ void __launch_bounds__(NTHREADS, 1)
train_bwd_layer(const bf16* __restrict__ acts_l, const bf16* __restrict__ cond,
                const bf16* __restrict__ dskip, const bf16* __restrict__ w_in,
                const bf16* __restrict__ w_in_kg, const float* __restrict__ b_g,
                const bf16* __restrict__ w_out_kn, float* __restrict__ dpart,
                const float* __restrict__ dcs_prev, float* __restrict__ dcs_cur,
                float* __restrict__ dcond32, bf16* __restrict__ dout_g,
                bf16* __restrict__ dg_g, bf16* __restrict__ z_g, int T, int d,
                int d_prev, int top) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dxs = reinterpret_cast<float*>(smem_raw);              // TT x C fp32
  bf16* xs = reinterpret_cast<bf16*>(dxs + TT * D::C);          // TT x XS
  bf16* sh = xs + TT * D::XS;                                    // TT x XS
  bf16* cs = sh + TT * D::XS;                                    // TT x CS
  bf16* douts = cs + TT * D::CS;                                 // TT x DS
  bf16* dgs = douts + TT * D::DS;                                // TT x GS
  bf16* zs = dgs + TT * D::GS;                                   // TT x ZS

  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 3, wh = warp >> 2;
  const size_t rb = (size_t)b * T;

  load_rows<D::C, D::XS>(xs, acts_l + rb * D::C, t0, 0, T);
  load_rows<D::C, D::XS>(sh, acts_l + rb * D::C, t0, d, T);
  load_rows<D::M, D::CS>(cs, cond + rb * D::M, t0, 0, T);
  // dx of this layer's output = dpart(t) + dcs_prev(t + d_prev); 0 at the top
  for (int i = tid; i < TT * (D::C / 4); i += NTHREADS) {
    const int r = i / (D::C / 4), c = (i % (D::C / 4)) * 4;
    const int t = t0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!top && t < T) {
      v = *reinterpret_cast<const float4*>(dpart + (rb + t) * D::C + c);
      if (t + d_prev < T) {
        const float4 u =
            *reinterpret_cast<const float4*>(dcs_prev + (rb + t + d_prev) * D::C + c);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
    }
    *reinterpret_cast<float4*>(dxs + r * D::C + c) = v;
    *reinterpret_cast<uint2*>(douts + r * D::DS + c) =
        make_uint2(pack(v.x, v.y), pack(v.z, v.w));
  }
  load_rows<D::S, D::DS>(douts + D::C, dskip + rb * D::S, t0, 0, T);
  __syncthreads();

  {
    // recompute the gates: acc[j] -> tanh, acc[NT_G + j] -> sigmoid
    float acc[2 * D::NT_G][4];
    gate_gemm<D>(acc, xs, sh, cs, w_in, wm, wh, g, q);
#pragma unroll
    for (int j = 0; j < D::NT_G; ++j) {
      const int col = wh * (D::GH / 2) + j * 8 + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = tanhf(acc[j][e] + b_g[col + (e & 1)]);
        acc[D::NT_G + j][e] = sigmoidf(acc[D::NT_G + j][e] + b_g[D::GH + col + (e & 1)]);
      }
    }
    // dz = dout @ W_out^T, for this warp's gate columns
    float dz[D::NT_G][4];
#pragma unroll
    for (int j = 0; j < D::NT_G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dz[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D::N_OUT / 16; ++ks) {
      uint32_t a[4];
      load_a(a, douts, D::DS, wm * 16 + g, ks * 16, q);
#pragma unroll
      for (int j = 0; j < D::NT_G; ++j) {
        const bf16* wp = w_out_kn +
                         (size_t)(wh * (D::GH / 2) + j * 8 + g) * D::N_OUT +
                         ks * 16 + 2 * q;
        mma_bf16(dz[j], a, ldg32(wp), ldg32(wp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < D::NT_G; ++j) {
      const int col = wh * (D::GH / 2) + j * 8 + 2 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 16 + g + 8 * hh;
        float da[2], db[2], z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ta = acc[j][2 * hh + e], sb = acc[D::NT_G + j][2 * hh + e];
          const float dzv = dz[j][2 * hh + e];
          da[e] = dzv * sb * (1.f - ta * ta);
          db[e] = dzv * ta * sb * (1.f - sb);
          z[e] = ta * sb;
        }
        *reinterpret_cast<uint32_t*>(dgs + r * D::GS + col) = pack(da[0], da[1]);
        *reinterpret_cast<uint32_t*>(dgs + r * D::GS + D::GH + col) = pack(db[0], db[1]);
        *reinterpret_cast<uint32_t*>(zs + r * D::ZS + col) = pack(z[0], z[1]);
      }
    }
  }
  __syncthreads();

  // dcat = dg @ W_in^T: warp half wh owns n-tiles wh*NT_D + [0, NT_D)
  {
    float acc[D::NT_D][4];
#pragma unroll
    for (int j = 0; j < D::NT_D; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D::G / 16; ++ks) {
      uint32_t a[4];
      load_a(a, dgs, D::GS, wm * 16 + g, ks * 16, q);
#pragma unroll
      for (int j = 0; j < D::NT_D; ++j) {
        const bf16* wp = w_in_kg + (size_t)((wh * D::NT_D + j) * 8 + g) * D::G +
                         ks * 16 + 2 * q;
        mma_bf16(acc[j], a, ldg32(wp), ldg32(wp + 8));
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 16 + g + 8 * hh;
      const int t = t0 + r;
      if (t >= T) continue;
      const size_t row = rb + t;
#pragma unroll
      for (int j = 0; j < D::NT_D; ++j) {
        const int col = (wh * D::NT_D + j) * 8 + 2 * q;
        const float v0 = acc[j][2 * hh], v1 = acc[j][2 * hh + 1];
        if (col < D::C) {
          *reinterpret_cast<float2*>(dpart + row * D::C + col) =
              make_float2(dxs[r * D::C + col] + v0, dxs[r * D::C + col + 1] + v1);
        } else if (col < 2 * D::C) {
          *reinterpret_cast<float2*>(dcs_cur + row * D::C + col - D::C) =
              make_float2(v0, v1);
        } else {
          float2* p = reinterpret_cast<float2*>(dcond32 + row * D::M + col - 2 * D::C);
          if (top) {
            *p = make_float2(v0, v1);
          } else {
            const float2 prev = *p;
            *p = make_float2(prev.x + v0, prev.y + v1);
          }
        }
      }
    }
  }

  if (dout_g != nullptr) {  // the weight-gradient pass reads dout, dg and z
    const int rows = min(TT, T - t0);
    for (int i = tid; i < rows * (D::N_OUT / 8); i += NTHREADS) {
      const int r = i / (D::N_OUT / 8), c8 = i % (D::N_OUT / 8);
      reinterpret_cast<uint4*>(dout_g + (rb + t0 + r) * D::N_OUT)[c8] =
          *reinterpret_cast<const uint4*>(douts + r * D::DS + c8 * 8);
    }
    for (int i = tid; i < rows * (D::G / 8); i += NTHREADS) {
      const int r = i / (D::G / 8), c8 = i % (D::G / 8);
      reinterpret_cast<uint4*>(dg_g + (rb + t0 + r) * D::G)[c8] =
          *reinterpret_cast<const uint4*>(dgs + r * D::GS + c8 * 8);
    }
    for (int i = tid; i < rows * (D::GH / 8); i += NTHREADS) {
      const int r = i / (D::GH / 8), c8 = i % (D::GH / 8);
      reinterpret_cast<uint4*>(z_g + (rb + t0 + r) * D::GH)[c8] =
          *reinterpret_cast<const uint4*>(zs + r * D::ZS + c8 * 8);
    }
  }
}

// Eight columns kk + [0, 8) of row `row` (= b*T + t) of the weight-gradient
// GEMM's left operand.  CAT: [x(t) | x(t - d) | cond(t) | 1 | 0...] over
// K_IN + 1 columns; otherwise [z(t) | 1 | 0...] over GH + 1 columns.
template <class D, bool CAT>
__device__ __forceinline__ uint4 wg_a_chunk(const bf16* a0, const bf16* cond,
                                            size_t row, int t, int kk, int d) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 ones = make_uint4(0x3F80u, 0u, 0u, 0u);  // bf16 1.0 first
  if (CAT) {
    if (kk < D::C) return __ldg(reinterpret_cast<const uint4*>(a0 + row * D::C + kk));
    if (kk < 2 * D::C)
      return t >= d ? __ldg(reinterpret_cast<const uint4*>(a0 + (row - d) * D::C + kk - D::C))
                    : zero;
    if (kk < D::K_IN)
      return __ldg(reinterpret_cast<const uint4*>(cond + row * D::M + kk - 2 * D::C));
    return kk == D::K_IN ? ones : zero;
  }
  if (kk < D::GH) return __ldg(reinterpret_cast<const uint4*>(a0 + row * D::GH + kk));
  return kk == D::GH ? ones : zero;
}

// Split-K weight gradient: part[split][k][n] = sum over this split's rows r
// of A[r][k] * Bm[r][n], with A from wg_a_chunk and Bm (R, N) bf16.  Grid
// (K1 / 64, N / 128, splits); rows never cross a split.
template <class D, bool CAT>
__global__ void __launch_bounds__(NTHREADS, 2)
wgrad_partial(const bf16* __restrict__ a0, const bf16* __restrict__ cond,
              const bf16* __restrict__ bm, int N, float* __restrict__ part,
              int K1, int B, int T, int d, int rows_per_split) {
  __shared__ __align__(16) bf16 sat[WG_K * WG_RS];  // A tile stored (k, r)
  __shared__ __align__(16) bf16 sbt[WG_N * WG_RS];  // Bm tile stored (n, r)
  const int k0 = blockIdx.x * WG_K, n0 = blockIdx.y * WG_N;
  const long long R = (long long)B * T;
  const long long r_begin = (long long)blockIdx.z * rows_per_split;
  const long long r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 3, wh = warp >> 2;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += WG_ROWS) {
    __syncthreads();  // the previous stage's fragments are read
    for (int i = tid; i < WG_ROWS * (WG_K / 8); i += NTHREADS) {
      const int r = i / (WG_K / 8), c8 = i % (WG_K / 8);
      const long long row = r0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < r_end)
        v = wg_a_chunk<D, CAT>(a0, cond, (size_t)row, (int)(row % T), k0 + c8 * 8, d);
      const bf16* e8 = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) sat[(c8 * 8 + e) * WG_RS + r] = e8[e];
    }
    for (int i = tid; i < WG_ROWS * (WG_N / 8); i += NTHREADS) {
      const int r = i / (WG_N / 8), c8 = i % (WG_N / 8);
      const long long row = r0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < r_end)
        v = __ldg(reinterpret_cast<const uint4*>(bm + (size_t)row * N + n0) + c8);
      const bf16* e8 = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) sbt[(c8 * 8 + e) * WG_RS + r] = e8[e];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < WG_ROWS / 16; ++ks) {
      uint32_t a[4];
      load_a(a, sat, WG_RS, wm * 16 + g, ks * 16, q);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* bp = sbt + (wh * 64 + j * 8 + g) * WG_RS + ks * 16 + 2 * q;
        mma_bf16(acc[j], a, lds32(bp), lds32(bp + 8));
      }
    }
  }

  float* pp = part + (size_t)blockIdx.z * K1 * N;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int k = k0 + wm * 16 + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + wh * 64 + j * 8 + 2 * q;
      *reinterpret_cast<float2*>(pp + (size_t)k * N + n) =
          make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
}

// Sums the partials in split order: w (N, KW) stored (out, in) from rows
// k < KW, bias (N) from row KW (the column of ones).
__global__ void wgrad_reduce(const float* __restrict__ part, int splits, int K1,
                             int N, int KW, float* __restrict__ w,
                             float* __restrict__ bias) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (KW + 1) * N) return;
  const int k = i / N, n = i % N;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[((size_t)sp * K1 + k) * N + n];
  if (k < KW)
    w[(size_t)n * KW + k] = s;
  else
    bias[n] = s;
}

// dx = bf16(dpart(t) + dcs0(t + d0)), dcond = bf16(dcond32).
template <class D>
__global__ void train_bwd_finalize(const float* __restrict__ dpart,
                                   const float* __restrict__ dcs0, int d0,
                                   const float* __restrict__ dcond32,
                                   bf16* __restrict__ dx, bf16* __restrict__ dcond,
                                   int B, int T) {
  const size_t n_dx = (size_t)B * T * (D::C / 2);
  const size_t n_dc = (size_t)B * T * (D::M / 2);
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_dx + n_dc;
       i += stride) {
    if (i < n_dx) {
      const size_t row = i / (D::C / 2);
      const int c = (int)(i % (D::C / 2)) * 2;
      float2 v = *reinterpret_cast<const float2*>(dpart + row * D::C + c);
      if ((int)(row % T) + d0 < T) {
        const float2 u = *reinterpret_cast<const float2*>(dcs0 + (row + d0) * D::C + c);
        v.x += u.x;
        v.y += u.y;
      }
      *reinterpret_cast<uint32_t*>(dx + row * D::C + c) = pack(v.x, v.y);
    } else {
      const size_t j = i - n_dx;
      const float2 v = reinterpret_cast<const float2*>(dcond32)[j];
      reinterpret_cast<uint32_t*>(dcond)[j] = pack(v.x, v.y);
    }
  }
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// Row splits of a weight-gradient GEMM with `tiles` output tiles: about two
// blocks per SM, each over a whole number of 32-row stages.
void wgrad_splits(long long R, int tiles, int n_sm, int* splits, int* rows) {
  long long s = (2LL * n_sm + tiles - 1) / tiles;
  const long long max_s = (R + WG_ROWS - 1) / WG_ROWS;
  if (s > max_s) s = max_s;
  if (s < 1) s = 1;
  if (s > 65535) s = 65535;
  long long per = (R + s - 1) / s;
  per = (per + WG_ROWS - 1) / WG_ROWS * WG_ROWS;
  *splits = (int)s;
  *rows = (int)per;
}

struct BwdWorkspace {
  size_t dpart, dcs0, dcs1, dcond32, dout, dg, z, part_in, part_out, total;
  int splits_in, rows_in, splits_out, rows_out;
};

template <class D>
BwdWorkspace bwd_workspace(int B, int T, int want_wgrads, int n_sm) {
  BwdWorkspace w{};
  const size_t R = (size_t)B * T;
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  w.dpart = take(R * D::C * 4);
  w.dcs0 = take(R * D::C * 4);
  w.dcs1 = take(R * D::C * 4);
  w.dcond32 = take(R * D::M * 4);
  wgrad_splits((long long)R, (D::K1_IN / WG_K) * (D::G / WG_N), n_sm, &w.splits_in, &w.rows_in);
  wgrad_splits((long long)R, (D::K1_OUT / WG_K) * (D::N_OUT / WG_N), n_sm, &w.splits_out,
               &w.rows_out);
  if (want_wgrads) {
    w.dout = take(R * D::N_OUT * 2);
    w.dg = take(R * D::G * 2);
    w.z = take(R * D::GH * 2);
    w.part_in = take((size_t)w.splits_in * D::K1_IN * D::G * 4);
    w.part_out = take((size_t)w.splits_out * D::K1_OUT * D::N_OUT * 4);
  }
  w.total = off;
  return w;
}

bool teacher_dims(int c, int g, int s, int m) {
  return c == Teacher::C && g == Teacher::G && s == Teacher::S && m == Teacher::M;
}

template <class D>
int train_fwd(const bf16* cond, const bf16* w_in, const float* b_g,
              const bf16* w_out, const float* b_rs, bf16* acts, float* skip32,
              bf16* skip, int B, int T, int L, const int* dil, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      train_fwd_layer<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::FWD_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TT - 1) / TT, B);
  const size_t act = (size_t)B * T * D::C;
  for (int l = 0; l < L; ++l) {
    train_fwd_layer<D><<<grid, NTHREADS, D::FWD_SMEM, st>>>(
        acts + l * act, l + 1 < L ? acts + (l + 1) * act : nullptr, cond,
        w_in + (size_t)l * D::G * D::K_IN, b_g + (size_t)l * D::G,
        w_out + (size_t)l * D::N_OUT * D::GH, b_rs + (size_t)l * D::N_OUT, skip32,
        skip, T, dil[l], l == 0, l + 1 == L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <class D>
int train_bwd(const bf16* acts, const bf16* cond, const bf16* dskip,
              const bf16* w_in, const bf16* w_in_kg, const float* b_g,
              const bf16* w_out_kn, bf16* dx, bf16* dcond, float* dw_in,
              float* db_g, float* dw_out, float* db_rs, unsigned char* ws,
              int B, int T, int L, const int* dil, int want_wgrads, int n_sm,
              cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      train_bwd_layer<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::BWD_SMEM);
  if (err != cudaSuccess) return err;
  const BwdWorkspace w = bwd_workspace<D>(B, T, want_wgrads, n_sm);
  float* dpart = reinterpret_cast<float*>(ws + w.dpart);
  float* dcs[2] = {reinterpret_cast<float*>(ws + w.dcs0), reinterpret_cast<float*>(ws + w.dcs1)};
  float* dcond32 = reinterpret_cast<float*>(ws + w.dcond32);
  bf16* dout_g = want_wgrads ? reinterpret_cast<bf16*>(ws + w.dout) : nullptr;
  bf16* dg_g = want_wgrads ? reinterpret_cast<bf16*>(ws + w.dg) : nullptr;
  bf16* z_g = want_wgrads ? reinterpret_cast<bf16*>(ws + w.z) : nullptr;
  float* part_in = want_wgrads ? reinterpret_cast<float*>(ws + w.part_in) : nullptr;
  float* part_out = want_wgrads ? reinterpret_cast<float*>(ws + w.part_out) : nullptr;

  const dim3 grid((T + TT - 1) / TT, B);
  const size_t act = (size_t)B * T * D::C;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    cur = (L - 1 - l) & 1;
    const bf16* acts_l = acts + l * act;
    train_bwd_layer<D><<<grid, NTHREADS, D::BWD_SMEM, st>>>(
        acts_l, cond, dskip, w_in + (size_t)l * D::G * D::K_IN,
        w_in_kg + (size_t)l * D::K_IN * D::G, b_g + (size_t)l * D::G,
        w_out_kn + (size_t)l * D::GH * D::N_OUT, dpart, dcs[cur ^ 1], dcs[cur],
        dcond32, dout_g, dg_g, z_g, T, dil[l], l + 1 < L ? dil[l + 1] : 0, l == L - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (!want_wgrads) continue;
    wgrad_partial<D, true><<<dim3(D::K1_IN / WG_K, D::G / WG_N, w.splits_in), NTHREADS, 0, st>>>(
        acts_l, cond, dg_g, D::G, part_in, D::K1_IN, B, T, dil[l], w.rows_in);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wgrad_reduce<<<((D::K_IN + 1) * D::G + 255) / 256, 256, 0, st>>>(
        part_in, w.splits_in, D::K1_IN, D::G, D::K_IN,
        dw_in + (size_t)l * D::G * D::K_IN, db_g + (size_t)l * D::G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wgrad_partial<D, false><<<dim3(D::K1_OUT / WG_K, D::N_OUT / WG_N, w.splits_out), NTHREADS, 0, st>>>(
        z_g, nullptr, dout_g, D::N_OUT, part_out, D::K1_OUT, B, T, 0, w.rows_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wgrad_reduce<<<((D::GH + 1) * D::N_OUT + 255) / 256, 256, 0, st>>>(
        part_out, w.splits_out, D::K1_OUT, D::N_OUT, D::GH,
        dw_out + (size_t)l * D::N_OUT * D::GH, db_rs + (size_t)l * D::N_OUT);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t n = (size_t)B * T * (D::C + D::M) / 2;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  train_bwd_finalize<D><<<blocks, 256, 0, st>>>(dpart, dcs[cur], dil[0], dcond32, dx,
                                                dcond, B, T);
  return cudaGetLastError();
}

bool valid_shape(int B, int T, int L, const int* dil) {
  if (B < 1 || B > 65535 || T < 1 || L < 1) return false;
  for (int l = 0; l < L; ++l)
    if (dil[l] < 1) return false;
  return true;
}

}  // namespace

extern "C" {

// Bytes of device workspace the backward needs (dx and dcond chains, the
// tap-cotangent buffers, and with weight gradients the bf16 dout/dg/z and
// the split-K partials); -1 for widths the kernels are not built for.
long long pwn_flow_stack_train_bwd_workspace_bytes(int B, int T, int c, int g,
                                                   int s, int m, int want_wgrads,
                                                   int n_sm) {
  if (!teacher_dims(c, g, s, m)) return -1;
  return (long long)bwd_workspace<Teacher>(B, T, want_wgrads, n_sm).total;
}

// Kernel 2: acts (L, B, T, C) holds x0 in acts[0] on entry; every layer's
// input is written to it, the skip sum to `skip`.  skip32 is (B, T, S) fp32
// scratch.  Returns a cudaError_t (0 on success).
int pwn_flow_stack_train_fwd_bf16(void* acts, const void* cond, const void* w_in,
                                  const void* b_g, const void* w_out,
                                  const void* b_rs, void* skip32, void* skip,
                                  int B, int T, int L, int c, int g, int s, int m,
                                  const int* dilations, void* stream) {
  if (!teacher_dims(c, g, s, m) || !valid_shape(B, T, L, dilations))
    return cudaErrorInvalidValue;
  return train_fwd<Teacher>(
      static_cast<const bf16*>(cond), static_cast<const bf16*>(w_in),
      static_cast<const float*>(b_g), static_cast<const bf16*>(w_out),
      static_cast<const float*>(b_rs), static_cast<bf16*>(acts),
      static_cast<float*>(skip32), static_cast<bf16*>(skip), B, T, L, dilations,
      static_cast<cudaStream_t>(stream));
}

// Kernel 3: dx (B, T, C) and dcond (B, T, M) in bf16; with want_wgrads the
// fp32 weight gradients dw_in (L, G, K_IN), db_g (L, G), dw_out (L, C+S, G/2),
// db_rs (L, C+S), stored (out, in) like the weights.  w_in_kg and w_out_kn
// are the weights transposed (L, K_IN, G) and (L, G/2, C+S).  `workspace`
// holds pwn_flow_stack_train_bwd_workspace_bytes(...) bytes.
int pwn_flow_stack_train_bwd_bf16(const void* acts, const void* cond,
                                  const void* dskip, const void* w_in,
                                  const void* w_in_kg, const void* b_g,
                                  const void* w_out_kn, void* dx, void* dcond,
                                  void* dw_in, void* db_g, void* dw_out,
                                  void* db_rs, void* workspace, int B, int T,
                                  int L, int c, int g, int s, int m,
                                  const int* dilations, int want_wgrads,
                                  int n_sm, void* stream) {
  if (!teacher_dims(c, g, s, m) || !valid_shape(B, T, L, dilations) || n_sm < 1)
    return cudaErrorInvalidValue;
  if (want_wgrads && (!dw_in || !db_g || !dw_out || !db_rs))
    return cudaErrorInvalidValue;
  return train_bwd<Teacher>(
      static_cast<const bf16*>(acts), static_cast<const bf16*>(cond),
      static_cast<const bf16*>(dskip), static_cast<const bf16*>(w_in),
      static_cast<const bf16*>(w_in_kg), static_cast<const float*>(b_g),
      static_cast<const bf16*>(w_out_kn), static_cast<bf16*>(dx),
      static_cast<bf16*>(dcond), static_cast<float*>(dw_in),
      static_cast<float*>(db_g), static_cast<float*>(dw_out),
      static_cast<float*>(db_rs), static_cast<unsigned char*>(workspace), B, T,
      L, dilations, want_wgrads, n_sm, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
