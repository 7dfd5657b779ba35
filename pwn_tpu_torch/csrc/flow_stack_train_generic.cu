// Whole-stack WaveNet training backward at any width, with fp32 or bf16
// operands: the general-width body of kernel 3, in both want_wgrads modes.
// (The forward that saves every layer's input runs kernel 5's accumulate
// epilogue once per layer, gated_layer_generic.cu at these widths.)
//
// Replaces: pwn_tpu/ops/pallas/flow_stack.py::_bwd_chunk_kernel (via
// _flow_stack_train_bwd_impl) where flow_stack_train.cu is not built: fp32
// operands at any width, bf16 at widths other than (C, G, S, M) =
// (64, 128, 64, 80) and (128, 256, 128, 80); the 40-mel tiny
// configurations and any preset trained with compute_dtype float32.  It
// returns what ops/flow_stack.py::flow_stack_backward_reference returns,
// with T the operand type: per layer l in reverse, dx the cotangent of
// layer l's output (0 above the top layer),
//     dout = T([dx | dskip]);  dz = dout @ W_out[l]^T
//     dg   = T([dz*sb*(1-ta^2) | dz*ta*sb*(1-sb)])  (ta, sb recomputed)
//     dcat = dg @ W_in[l]^T = [dcx | dcs | dcc]
//     dx  <- (dx + dcx)(t) + dcs(t + d);  dcond += dcc          all fp32
//     dW_in[l] = dg^T cat, db_g[l] = sum dg, dW_out[l] = dout^T z,
//     db_rs[l] = sum dout, z = T(ta sb)                            fp32
// dx and dcond are returned in T, the weight gradients in fp32.
//
// What bounds it on this card.  Per sample a layer does (2C + M) G (the
// gates recomputed) + (C + S) G/2 (dz) + G (2C + M) (dcat) multiply-adds,
// and with weight gradients G (2C + M + 1) + (C + S)(G/2 + 1) more: at the
// tiny configs' (64, 128, 64, 40) 51,200 (dx-only) and 81,152, which in
// fp32 at 67 TFLOP/s is 1.53 and 2.42 ns a sample, against 2,016 bytes in
// fp32 at 3.35 TB/s (acts, cond and dskip read, the dx and tap chains
// written and read back, dcond32 read and written: 0.60 ns) and with
// weight gradients 4,992 (dout, dg and z stored and read again, acts and
// cond read again: 1.49 ns).  The operations bound it.
//
// Design (a first, simple body), with the host orchestration of
// flow_stack_train.cu:
// * One launch per layer in reverse order (`layer_pass`).  CUDA blocks run
//   in no order, so the tap cotangent dx_l(t) needs dcs(t + d) from rows
//   of other blocks: each layer writes dpart = dx + dcx and dcs to device
//   memory in fp32, and the layer below reads dpart(t) + dcs(t + d) as its
//   dx.  dcs alternates between two buffers.  A last pass (`finalize`)
//   folds layer 0's dcs into dx and rounds dx and dcond.
// * The layer pass is the tile of gated_layer_generic.cu: one block of 256
//   threads per 64 rows of the flattened (b, t) axis, the activations in
//   shared memory as fp32 [k][row] tiles, the weights streamed through a
//   32-row k-slice, every product a 4 x 4 register tile of fp32 FMAs
//   (generic.cuh).  Its order: dout into a tile; dz = dout @ W_out^T into
//   a tile; the gate product per 32 tanh columns and their sigmoid
//   partners, with dg formed in registers and stored over dout; dcat =
//   dg @ W_in in 64-column chunks, whose epilogue writes dpart, dcs and
//   dcond32.
// * Weight gradients: the layer pass stores dout, dg and z in T, and a
//   split-K product (`wgrad_product`) forms dg^T [cat | 1] and
//   dout^T [z | 1] (the column of ones gives the bias sums) over row
//   ranges into fp32 partials, which `wgrad_reduce` sums in split order.
// * Deterministic: no atomics, every sum in a fixed order, so two runs are
//   bit-identical and dx, dcond are the same bits in both modes (the
//   weight-gradient stores change no arithmetic).
// * Widths are runtime arguments: C, S, M >= 1, G even, and
//   2C + M + G/2 + max(C + S, G) + 32 rows of 272 bytes within the block's
//   232,448 bytes of shared memory (gen::smem_bytes).

#include "generic.cuh"

namespace {

using namespace gen;

// dx(t) = dpart(t) + dcs(t + d_prev), the cotangent of this layer's output
// from the layer above (0 at the top)
__device__ __forceinline__ float dx_at(const float* dpart, const float* dcs_in, long long row,
                                       int k, int C, int T_, int d_prev) {
  if (!dcs_in) return 0.f;
  float v = dpart[row * C + k];
  if (row % T_ + d_prev < T_) v += dcs_in[(row + d_prev) * C + k];
  return v;
}

// One layer of the backward over all tiles.  dcs_in is the layer above's
// dcs (null at the top, where dx = 0 and dcond32 is set, not added to);
// dout_g, dg_g, z_g (B, T, C+S | G | G/2) in T are stored for the
// weight-gradient product when not null.
template <class T>
__global__ void __launch_bounds__(NT)
layer_pass(const T* __restrict__ x, const T* __restrict__ cond, const T* __restrict__ dskip,
           const T* __restrict__ w_in, const float* __restrict__ b_g,
           const T* __restrict__ w_out, float* dpart, const float* __restrict__ dcs_in,
           float* __restrict__ dcs_out, float* __restrict__ dcond32, T* __restrict__ dout_g,
           T* __restrict__ dg_g, T* __restrict__ z_g, long long R, int T_, int C, int G, int S,
           int M, int d, int d_prev) {
  extern __shared__ __align__(16) float smem[];
  const int K_IN = 2 * C + M, GH = G / 2, N_OUT = C + S;
  float* a_t = smem;                                   // [K_IN][AS]: x, tap, cond
  float* u_t = a_t + K_IN * AS;                        // [max(N_OUT, G)][AS]: dout, then dg
  float* dz_t = u_t + (N_OUT > G ? N_OUT : G) * AS;    // [GH][AS]
  float* ws = dz_t + GH * AS;                          // [KS][WS]
  const long long r0 = static_cast<long long>(blockIdx.x) * TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool top = dcs_in == nullptr;
  load_cat(a_t, x, cond, r0, R, T_, C, M, d);
  // dout = T([dx | dskip])
  for (int i = threadIdx.x; i < TM * N_OUT; i += NT) {
    const int k = i % N_OUT, r = i / N_OUT;
    const long long row = r0 + r;
    float v = 0.f;
    if (row < R) {
      v = k < C ? rnd<T>(dx_at(dpart, dcs_in, row, k, C, T_, d_prev))
                : f32(dskip[row * S + k - C]);
      if (dout_g) dout_g[row * N_OUT + k] = cvt<T>(v);
    }
    u_t[k * AS + r] = v;
  }

  float acc[4][4];
  // dz = dout @ W_out[l] (W_out stored (N_OUT, GH): its rows are the K)
  for (int j0 = 0; j0 < GH; j0 += NB) {
    chunk_product<false>(acc, u_t, N_OUT, ws, [&](int n, int c) {
      return j0 + c < GH ? f32(w_out[static_cast<size_t>(n) * GH + j0 + c]) : 0.f;
    });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j0 + 4 * tx + j;
      if (h >= GH) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) dz_t[h * AS + 4 * ty + i] = acc[i][j];
    }
  }

  // the gates recomputed, dg over dout (whose products are done: the next
  // chunk_product starts with a barrier)
  for (int j0 = 0; j0 < GH; j0 += NB / 2) {
    chunk_product<true>(acc, a_t, K_IN, ws, [&](int k, int c) {
      const int h = j0 + 2 * (c / 4) + (c & 1);
      return h < GH ? f32(w_in[static_cast<size_t>((c & 2) ? GH + h : h) * K_IN + k]) : 0.f;
    });
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int h = j0 + 2 * tx + e;
      if (h >= GH) continue;
      const float bt = b_g[h], bs = b_g[GH + h];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        const float ta = tanhf(acc[i][e] + bt), sb = sigmoid_f(acc[i][2 + e] + bs);
        const float dz = dz_t[h * AS + r];
        u_t[h * AS + r] = rnd<T>(dz * sb * (1.f - ta * ta));
        u_t[(GH + h) * AS + r] = rnd<T>(dz * ta * sb * (1.f - sb));
        if (z_g && r0 + r < R) z_g[(r0 + r) * GH + h] = cvt<T>(ta * sb);
      }
    }
  }

  // dcat = dg @ W_in[l] (W_in stored (G, K_IN): its rows are the K)
  for (int k0 = 0; k0 < K_IN; k0 += NB) {
    chunk_product<false>(acc, u_t, G, ws, [&](int g, int c) {
      return k0 + c < K_IN ? f32(w_in[static_cast<size_t>(g) * K_IN + k0 + c]) : 0.f;
    });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = r0 + 4 * ty + i;
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * tx + j;
        if (k >= K_IN) continue;
        const float v = acc[i][j];
        if (k < C) {
          dpart[row * C + k] = dx_at(dpart, dcs_in, row, k, C, T_, d_prev) + v;
        } else if (k < 2 * C) {
          dcs_out[row * C + k - C] = v;
        } else {
          const long long at = row * M + k - 2 * C;
          dcond32[at] = top ? v : dcond32[at] + v;
        }
      }
    }
  }
  if (dg_g)  // dg, read back from its tile (no thread writes it any more)
    for (int i = threadIdx.x; i < TM * G; i += NT) {
      const int g = i % G, r = i / G;
      if (r0 + r < R) dg_g[(r0 + r) * G + g] = cvt<T>(u_t[g * AS + r]);
    }
}

// part[split][m][n] = sum over the split's rows of p[row][m] q[row][n], for
// m < MP and n <= NQ, with q[row][NQ] = 1 (the bias sums).  q is the tile
// [x | x(t - d) | cond] of width NQ = 2C + M when CAT, else z (NQ = G/2).
// One block per 64 x 64 output tile and split: blockIdx = (m tile, n tile,
// split); its rows stream in KS-row slices of both operands.
template <class T, bool CAT>
__global__ void __launch_bounds__(NT)
wgrad_product(const T* __restrict__ p, int MP, const T* __restrict__ q,
              const T* __restrict__ cond, int NQ, long long R, int T_, int C, int M, int d,
              long long per, float* __restrict__ part) {
  __shared__ __align__(16) float ps[KS * WS], qs[KS * WS];
  const int m0 = blockIdx.x * NB, n0 = blockIdx.y * NB, split = blockIdx.z;
  const long long q0 = split * per, q1 = q0 + per < R ? q0 + per : R;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (long long rb = q0; rb < q1; rb += KS) {
    __syncthreads();  // the slices before are read
    for (int i = threadIdx.x; i < KS * NB; i += NT) {
      const int kk = i / NB, c = i % NB;
      const long long row = rb + kk;
      float pv = 0.f, qv = 0.f;
      if (row < q1) {
        const int m = m0 + c, n = n0 + c;
        if (m < MP) pv = f32(p[row * MP + m]);
        if (n == NQ) {
          qv = 1.f;
        } else if (n < NQ) {
          if (!CAT)
            qv = f32(q[row * NQ + n]);
          else if (n < C)
            qv = f32(q[row * C + n]);
          else if (n < 2 * C)
            qv = row % T_ >= d ? f32(q[(row - d) * C + n - C]) : 0.f;
          else
            qv = f32(cond[row * M + n - 2 * C]);
        }
      }
      ps[kk * WS + c] = pv;
      qs[kk * WS + c] = qv;
    }
    __syncthreads();
    fma_tile(acc, ps, qs, KS);
  }
  float* out = part + static_cast<size_t>(split) * MP * (NQ + 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= MP) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n <= NQ) out[static_cast<size_t>(m) * (NQ + 1) + n] = acc[i][j];
    }
  }
}

// Sums the partials in split order: dw (MP, NQ) and db (MP).
__global__ void wgrad_reduce(const float* __restrict__ part, int splits, int MP, int NQ,
                             float* __restrict__ dw, float* __restrict__ db) {
  const long long n = static_cast<long long>(MP) * (NQ + 1);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * n + i];
  const long long m = i / (NQ + 1), c = i % (NQ + 1);
  if (c < NQ)
    dw[m * NQ + c] = s;
  else
    db[m] = s;
}

// dx = T(dpart(t) + dcs(t + d0)), dcond = T(dcond32).
template <class T>
__global__ void finalize(const float* __restrict__ dpart, const float* __restrict__ dcs,
                         int d0, const float* __restrict__ dcond32, T* __restrict__ dx,
                         T* __restrict__ dcond, long long R, int T_, int C, int M) {
  const long long n_dx = R * C, n = n_dx + R * M;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (i < n_dx) {
      const long long row = i / C;
      const int k = static_cast<int>(i % C);
      dx[i] = cvt<T>(dx_at(dpart, dcs, row, k, C, T_, d0));
    } else {
      dcond[i - n_dx] = cvt<T>(dcond32[i - n_dx]);
    }
  }
}

// The split of R rows into row ranges for a product of MP x (NQ + 1)
// outputs: about two blocks per SM, each range a multiple of KS rows.
struct Splits {
  long long per;
  int splits;
};

Splits wgrad_splits(long long R, int MP, int NQ, int n_sm) {
  const long long tiles =
      static_cast<long long>((MP + NB - 1) / NB) * ((NQ + 1 + NB - 1) / NB);
  long long s = (2LL * n_sm + tiles - 1) / tiles;
  const long long max_s = (R + KS - 1) / KS;
  s = s < 1 ? 1 : s > max_s ? max_s : s;
  Splits w;
  w.per = ((R + s - 1) / s + KS - 1) / KS * KS;
  w.splits = static_cast<int>((R + w.per - 1) / w.per);
  return w;
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

struct Workspace {
  size_t dpart, dcs0, dcs1, dcond32, dout, dg, z, part_in, part_out, total;
};

Workspace workspace(long long R, int C, int G, int S, int M, int want_wgrads, int n_sm,
                    size_t elem) {
  Workspace w{};
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  const int K_IN = 2 * C + M, GH = G / 2, N_OUT = C + S;
  w.dpart = take(R * C * 4);
  w.dcs0 = take(R * C * 4);
  w.dcs1 = take(R * C * 4);
  w.dcond32 = take(R * M * 4);
  if (want_wgrads) {
    w.dout = take(R * N_OUT * elem);
    w.dg = take(R * G * elem);
    w.z = take(R * GH * elem);
    w.part_in = take(static_cast<size_t>(wgrad_splits(R, G, K_IN, n_sm).splits) * G *
                     (K_IN + 1) * 4);
    w.part_out = take(static_cast<size_t>(wgrad_splits(R, N_OUT, GH, n_sm).splits) * N_OUT *
                      (GH + 1) * 4);
  }
  w.total = off;
  return w;
}

// dw (MP, NQ) and db (MP) of one product.
template <class T, bool CAT>
cudaError_t wgrad(const T* p, int MP, const T* q, const T* cond, int NQ, long long R, int T_,
                  int C, int M, int d, int n_sm, float* part, float* dw, float* db,
                  cudaStream_t st) {
  const Splits w = wgrad_splits(R, MP, NQ, n_sm);
  const dim3 grid((MP + NB - 1) / NB, (NQ + 1 + NB - 1) / NB, w.splits);
  wgrad_product<T, CAT><<<grid, NT, 0, st>>>(p, MP, q, cond, NQ, R, T_, C, M, d, w.per, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(MP) * (NQ + 1);
  wgrad_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(part, w.splits, MP, NQ,
                                                                       dw, db);
  return cudaGetLastError();
}

template <class T>
int train_bwd(const T* acts, const T* cond, const T* dskip, const T* w_in, const float* b_g,
              const T* w_out, T* dx, T* dcond, float* dw_in, float* db_g, float* dw_out,
              float* db_rs, unsigned char* ws, int B, int T_, int L, int C, int G, int S,
              int M, const int* dil, int want_wgrads, int n_sm, cudaStream_t st) {
  const int smem = static_cast<int>(smem_bytes(C, G, S, M, true));
  cudaError_t err = cudaFuncSetAttribute(layer_pass<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long R = static_cast<long long>(B) * T_;
  const int K_IN = 2 * C + M, GH = G / 2, N_OUT = C + S;
  const Workspace w = workspace(R, C, G, S, M, want_wgrads, n_sm, sizeof(T));
  float* dpart = reinterpret_cast<float*>(ws + w.dpart);
  float* dcs[2] = {reinterpret_cast<float*>(ws + w.dcs0), reinterpret_cast<float*>(ws + w.dcs1)};
  float* dcond32 = reinterpret_cast<float*>(ws + w.dcond32);
  T* dout_g = want_wgrads ? reinterpret_cast<T*>(ws + w.dout) : nullptr;
  T* dg_g = want_wgrads ? reinterpret_cast<T*>(ws + w.dg) : nullptr;
  T* z_g = want_wgrads ? reinterpret_cast<T*>(ws + w.z) : nullptr;
  const unsigned grid = static_cast<unsigned>((R + TM - 1) / TM);
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    cur = (L - 1 - l) & 1;
    const T* x = acts + static_cast<size_t>(l) * R * C;
    const T* w_in_l = w_in + static_cast<size_t>(l) * G * K_IN;
    const T* w_out_l = w_out + static_cast<size_t>(l) * N_OUT * GH;
    layer_pass<T><<<grid, NT, smem, st>>>(
        x, cond, dskip, w_in_l, b_g + static_cast<size_t>(l) * G, w_out_l, dpart,
        l == L - 1 ? nullptr : dcs[cur ^ 1], dcs[cur], dcond32, dout_g, dg_g, z_g, R, T_, C, G,
        S, M, dil[l], l == L - 1 ? 0 : dil[l + 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (!want_wgrads) continue;
    err = wgrad<T, true>(dg_g, G, x, cond, K_IN, R, T_, C, M, dil[l], n_sm,
                         reinterpret_cast<float*>(ws + w.part_in),
                         dw_in + static_cast<size_t>(l) * G * K_IN,
                         db_g + static_cast<size_t>(l) * G, st);
    if (err != cudaSuccess) return err;
    err = wgrad<T, false>(dout_g, N_OUT, z_g, nullptr, GH, R, T_, C, M, dil[l], n_sm,
                          reinterpret_cast<float*>(ws + w.part_out),
                          dw_out + static_cast<size_t>(l) * N_OUT * GH,
                          db_rs + static_cast<size_t>(l) * N_OUT, st);
    if (err != cudaSuccess) return err;
  }
  const long long n = R * (C + M);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  finalize<T><<<blocks, 256, 0, st>>>(dpart, dcs[cur], dil[0], dcond32, dx, dcond, R, T_, C, M);
  return cudaGetLastError();
}

bool valid(int B, int T_, int L, const int* dil, int c, int g, int s, int m) {
  if (B < 1 || B > 65535 || T_ < 1 || L < 1 || !widths_ok(c, g, s, m, true)) return false;
  for (int l = 0; l < L; ++l)
    if (dil[l] < 1) return false;
  return true;
}

}  // namespace

extern "C" {

// Bytes of device workspace the general backward needs (the fp32 dx, tap
// and dcond chains, and with weight gradients dout, dg and z in the operand
// type and the split partials); -1 for widths it does not take.
long long pwn_flow_stack_train_bwd_generic_workspace_bytes(int B, int T, int c, int g, int s,
                                                           int m, int want_wgrads, int n_sm,
                                                           int is_bf16) {
  if (B < 1 || T < 1 || n_sm < 1 || !widths_ok(c, g, s, m, true)) return -1;
  return static_cast<long long>(workspace(static_cast<long long>(B) * T, c, g, s, m,
                                          want_wgrads, n_sm, is_bf16 ? 2 : 4)
                                    .total);
}

// Kernel 3's general body: dx (B, T, C) and dcond (B, T, M) in the operand
// type (fp32, or bf16 with is_bf16); with want_wgrads the fp32 dw_in (L, G,
// 2C+M), db_g (L, G), dw_out (L, C+S, G/2), db_rs (L, C+S), stored (out, in)
// like w_in and w_out.  `workspace` holds
// pwn_flow_stack_train_bwd_generic_workspace_bytes(...) bytes.  Returns a
// cudaError_t (0 on success).
int pwn_flow_stack_train_bwd_generic(const void* acts, const void* cond, const void* dskip,
                                     const void* w_in, const void* b_g, const void* w_out,
                                     void* dx, void* dcond, void* dw_in, void* db_g,
                                     void* dw_out, void* db_rs, void* workspace, int B, int T,
                                     int L, int c, int g, int s, int m, const int* dilations,
                                     int want_wgrads, int n_sm, int is_bf16, void* stream) {
  if (!valid(B, T, L, dilations, c, g, s, m) || n_sm < 1) return cudaErrorInvalidValue;
  if (want_wgrads && (!dw_in || !db_g || !dw_out || !db_rs)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  const float* bg = static_cast<const float*>(b_g);
  float *dwi = static_cast<float*>(dw_in), *dbg = static_cast<float*>(db_g);
  float *dwo = static_cast<float*>(dw_out), *dbr = static_cast<float*>(db_rs);
  if (is_bf16)
    return train_bwd<bf16>(static_cast<const bf16*>(acts), static_cast<const bf16*>(cond),
                           static_cast<const bf16*>(dskip), static_cast<const bf16*>(w_in), bg,
                           static_cast<const bf16*>(w_out), static_cast<bf16*>(dx),
                           static_cast<bf16*>(dcond), dwi, dbg, dwo, dbr, ws, B, T, L, c, g, s,
                           m, dilations, want_wgrads, n_sm, st);
  return train_bwd<float>(static_cast<const float*>(acts), static_cast<const float*>(cond),
                          static_cast<const float*>(dskip), static_cast<const float*>(w_in), bg,
                          static_cast<const float*>(w_out), static_cast<float*>(dx),
                          static_cast<float*>(dcond), dwi, dbg, dwo, dbr, ws, B, T, L, c, g, s,
                          m, dilations, want_wgrads, n_sm, st);
}

}  // extern "C"
