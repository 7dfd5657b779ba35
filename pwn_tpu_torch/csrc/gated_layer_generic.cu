// One WaveNet gated residual layer at any width, with fp32 or bf16
// operands: the general-width body of kernel 5, in its two epilogues,
// "layer" and "accumulate", with gated_layer.cu's semantics.
//
// Replaces: pwn_tpu/ops/pallas/gated_layer.py::_kernel (reached through
// _fused_forward / fused_gated_residual) where gated_layer.cu is not built:
// fp32 operands at any width, bf16 at widths other than (C, G, S, M) =
// (64, 128, 64, 80) and (128, 256, 128, 80).  Through the accumulate
// epilogue run once per layer it also stands for
// pwn_tpu/ops/pallas/flow_stack.py::_kernel (the whole-stack forward) and
// ::_fwd_save_kernel (the training forward that saves each layer's input)
// at those widths: the 40-mel tiny configurations and any preset run with
// compute_dtype float32.  For every batch row b and time t, with dilation d
// and T the operand type (float or bf16):
//     g    = [x(t) | x(t - d) | cond(t)] @ W_in + b_g     fp32 sums
//     z    = T(tanh(g[:G/2]) * sigmoid(g[G/2:]))
//     out  = z @ W_out + b_out                            fp32 sums
//     res  = T(x + T(out[:C]))
// with x(t - d) = 0 for t < d.  Then
//   layer:       skip = T(out[C:])
//   accumulate:  skip_acc = out[C:] (first layer) or skip_acc + out[C:] in
//                fp32; the last layer writes T(skip_acc + out[C:]) and no
//                res.
// These are the rounding points of ops/flow_stack.py::layer_out; at fp32
// every rounding is the identity.
//
// What bounds it on this card.  Per sample a layer does (2C + M) G + (G/2)
// (C + S) multiply-adds: 29,696 at the tiny configs' (64, 128, 64, 40),
// 34,816 at student_iaf's (64, 128, 64, 80), 118,784 at (128, 256, 128,
// 80).  In fp32 on the CUDA cores (67 TFLOP/s) that is 0.89 ns a sample at
// (64, 128, 64, 40) against 3.35 TB/s for its bytes (x, cond, res and skip
// in fp32: 928 bytes, 0.28 ns; a middle accumulate layer reads and writes
// the fp32 skip_acc instead of skip: 1,184 bytes, 0.35 ns): the operations
// bound it.  In bf16 the wgmma bodies, where built, are the
// fast route; this body serves the other widths.
//
// Design (a first, simple body):
// * One block of 256 threads per 64-row tile of the flattened (b, t) axis;
//   no tile bound on the dilation: the tap x(t - d) is read per row from
//   device memory, zero where t < d, so a row never crosses a batch row.
// * The tile [x | tap | cond] is loaded once, converted to fp32, into
//   shared memory transposed ([k][row], generic.cuh).
// * The gate product runs in chunks of 32 tanh columns and their 32 sigmoid
//   partners, so a thread holds both halves of its z columns; the weights
//   stream in 32-row k-slices of W_in through shared memory (at C=128 in
//   fp32 W_in alone is 344 KB, more than a block's 227 KB).  z goes to
//   shared memory rounded to T, as the out product's A.
// * The out product runs in 64-column chunks over z with W_out streamed
//   the same way, and the epilogue stores from the register tile.
// * Widths are runtime arguments: C, S, M >= 1, G even, and
//   2C + M + G/2 + 32 rows of 272 bytes within the block's 232,448 bytes
//   of shared memory (gen::smem_bytes).

#include "generic.cuh"

namespace {

using namespace gen;

template <class T, bool ACC>
__global__ void __launch_bounds__(NT)
gated_layer_generic(const T* __restrict__ x, const T* __restrict__ cond,
                    const T* __restrict__ w_in, const float* __restrict__ b_g,
                    const T* __restrict__ w_out, const float* __restrict__ b_out,
                    T* __restrict__ res, T* __restrict__ skip, float* __restrict__ skip_acc,
                    long long R, int T_, int C, int G, int S, int M, int d, int first,
                    int last) {
  extern __shared__ __align__(16) float smem[];
  const int K_IN = 2 * C + M, GH = G / 2, N_OUT = C + S;
  float* a_t = smem;              // [K_IN][AS]: x, tap, cond
  float* z_t = a_t + K_IN * AS;   // [GH][AS]
  float* ws = z_t + GH * AS;      // [KS][WS]: the weight slice
  const long long r0 = static_cast<long long>(blockIdx.x) * TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_cat(a_t, x, cond, r0, R, T_, C, M, d);

  float acc[4][4];
  // gate product: chunk columns 4 tx + {0, 1} are tanh columns h0 + {0, 1},
  // 4 tx + {2, 3} their sigmoid partners GH + h0 + {0, 1}, h0 = j0 + 2 tx
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
      for (int i = 0; i < 4; ++i)
        z_t[h * AS + 4 * ty + i] =
            rnd<T>(tanhf(acc[i][e] + bt) * sigmoid_f(acc[i][2 + e] + bs));
    }
  }

  // out product and epilogue: chunk columns n0 + 4 tx + [0, 4)
  for (int n0 = 0; n0 < N_OUT; n0 += NB) {
    chunk_product<true>(acc, z_t, GH, ws, [&](int k, int c) {
      return n0 + c < N_OUT ? f32(w_out[static_cast<size_t>(n0 + c) * GH + k]) : 0.f;
    });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const long long row = r0 + r;
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n >= N_OUT) continue;
        const float o = acc[i][j] + b_out[n];
        if (n < C) {
          if (!(ACC && last)) res[row * C + n] = cvt<T>(a_t[n * AS + r] + rnd<T>(o));
        } else {
          const long long at = row * S + n - C;
          if (!ACC) {
            skip[at] = cvt<T>(o);
          } else {
            const float v = first ? o : skip_acc[at] + o;
            if (last)
              skip[at] = cvt<T>(v);
            else
              skip_acc[at] = v;
          }
        }
      }
    }
  }
}

template <class T, bool ACC>
int launch(const void* x, const void* cond, const void* w_in, const void* b_g,
           const void* w_out, const void* b_out, void* res, void* skip, void* skip_acc,
           int B, int T_, int c, int g, int s, int m, int d, int first, int last,
           cudaStream_t st) {
  const int smem = static_cast<int>(smem_bytes(c, g, s, m, false));
  cudaError_t err = cudaFuncSetAttribute(gated_layer_generic<T, ACC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long R = static_cast<long long>(B) * T_;
  gated_layer_generic<T, ACC><<<static_cast<unsigned>((R + TM - 1) / TM), NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(cond), static_cast<const T*>(w_in),
      static_cast<const float*>(b_g), static_cast<const T*>(w_out),
      static_cast<const float*>(b_out), static_cast<T*>(res), static_cast<T*>(skip),
      static_cast<float*>(skip_acc), R, T_, c, g, s, m, d, first, last);
  return cudaGetLastError();
}

template <bool ACC>
int dispatch(const void* x, const void* cond, const void* w_in, const void* b_g,
             const void* w_out, const void* b_out, void* res, void* skip, void* skip_acc,
             int B, int T_, int c, int g, int s, int m, int d, int first, int last,
             int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || T_ < 1 || d < 1 || !widths_ok(c, g, s, m, false))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16, ACC>(x, cond, w_in, b_g, w_out, b_out, res, skip, skip_acc, B, T_, c,
                             g, s, m, d, first, last, st);
  return launch<float, ACC>(x, cond, w_in, b_g, w_out, b_out, res, skip, skip_acc, B, T_, c, g,
                            s, m, d, first, last, st);
}

}  // namespace

extern "C" {

// Shared memory a general body's block takes at these widths (backward:
// flow_stack_train_generic.cu's layer pass), and so whether it takes them.
long long pwn_generic_smem_bytes(int c, int g, int s, int m, int backward) {
  return smem_bytes(c, g, s, m, backward != 0);
}

// Kernel 5's general body, "layer" epilogue: res and skip out, operands
// fp32 (is_bf16 = 0) or bf16.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for widths it does not take.
int pwn_gated_layer_generic(const void* x, const void* cond, const void* w_in,
                            const void* b_g, const void* w_out, const void* b_out, void* res,
                            void* skip, int B, int T, int c, int g, int s, int m, int dilation,
                            int is_bf16, void* stream) {
  return dispatch<false>(x, cond, w_in, b_g, w_out, b_out, res, skip, nullptr, B, T, c, g, s, m,
                         dilation, 0, 0, is_bf16, stream);
}

// Kernel 5's general body, "accumulate" epilogue: layer `first` / `last` of
// a stack, as pwn_gated_layer_acc_bf16.
int pwn_gated_layer_acc_generic(const void* x, const void* cond, const void* w_in,
                                const void* b_g, const void* w_out, const void* b_rs,
                                void* res, void* skip_acc, void* skip, int B, int T, int c,
                                int g, int s, int m, int dilation, int first, int last,
                                int is_bf16, void* stream) {
  return dispatch<true>(x, cond, w_in, b_g, w_out, b_rs, res, skip, skip_acc, B, T, c, g, s, m,
                        dilation, first, last, is_bf16, stream);
}

}  // extern "C"
