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
// the fp32 skip_acc instead of skip: 1,184 bytes, 0.35 ns): the FMA issue
// rate bounds it.  In bf16 the wgmma bodies, where built, are the fast
// route; this body serves the other widths.
//
// Design (generic.cuh has the shared core):
// * One block of 2 TM threads per TM-row tile of the flattened (b, t) axis
//   (TM = 64, or 32 at widths whose z tile leaves no room: `tile_rows`); no
//   tile bound on the dilation: the tap rows x(t - d) stream from device
//   memory, zero where t < d, so a row never crosses a batch row.
// * The gate product runs one chunk of 64 tanh columns and their 64 sigmoid
//   partners at a time (all of G at G <= 128), so a thread holds both
//   halves of its 4 z columns.  Each ring slot brings the tile's next 16
//   activation columns [x | tap | cond] (cp.async, rows k-contiguous) and the
//   packed 16 x 128 weight slice; STAGES - 1 slots are in flight while one
//   is multiplied.  z goes to a resident fp32 tile, rounded to T.
// * The out product runs 128-column chunks over z with the packed W_out
//   slices streamed the same way, its first two slices issued before the
//   last gate chunk's gates run; the epilogue reads x and the fp32 skip_acc
//   and stores res, skip and skip_acc 4 columns (16 bytes in fp32) at a
//   time where C and S are multiples of 4.
// * At student_iaf's widths in fp32 a block takes 57,344 bytes of shared
//   memory and at most 168 registers a thread: three blocks (12 warps) an
//   SM, so one block's gates, epilogue and ring refills run under the other
//   blocks' FMAs.  The fp32 skip_acc rows the epilogue reads are brought
//   into L2 when the tile starts.

#include "generic.cuh"

namespace {

using namespace gen;

template <int TM, class T, bool ACC>
__global__ void __launch_bounds__(2 * TM, TM == 64 ? 3 : 6)
gated_layer_generic(Cat<T> cat, const float* __restrict__ w_gate, const float* __restrict__ b_g,
                    const float* __restrict__ w_out, const float* __restrict__ b_out,
                    T* __restrict__ res, T* __restrict__ skip, float* __restrict__ skip_acc,
                    int G, int S, int first, int last) {
  constexpr int NT = 2 * TM, A_BYTES = TM * (BK * 4 + 16), SB = stage_bytes<TM>();
  using Rows = CatRows<TM, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  GEN_PHASE_START();
  const int C = cat.C;
  const Pack q = pack_dims(C, G, S, cat.M);
  const int GH = q.GH, N = q.N, ZS = q.GHp + 4;
  const long long R = cat.R, r0 = static_cast<long long>(blockIdx.x) * TM;
  const int tx = threadIdx.x & 15;
  auto slot_a = [&](int s) { return reinterpret_cast<T*>(smem + s * SB); };
  auto slot_b = [&](int s) { return reinterpret_cast<float*>(smem + s * SB + A_BYTES); };
  float* z_t = reinterpret_cast<float*>(smem + STAGES * SB);  // [TM][ZS]
  Rows rows;
  rows.init(cat, r0);
  if (ACC && !first) prefetch_rows(skip_acc, r0, R, S, TM);  // read in the epilogue
  GEN_PHASE(0);

  float acc[8][8];
  // gate product: chunk ch's columns 4 tx + j are tanh columns h = 64 ch +
  // 4 tx + j, columns 64 + 4 tx + j their sigmoid partners
  for (int ch = 0; ch < q.Gc; ++ch) {
    zero<2>(acc);
    ring(
        q.Kp / BK,
        [&](int s, int slot) {
          rows.load(slot_a(slot), cat, s * BK);
          load_w<NT, BK * NB * 4>(slot_b(slot),
                                    w_gate + (static_cast<size_t>(ch) * q.Kp + s * BK) * NB);
        },
        [&](int slot, int) { fma_rows<TM, 2>(acc, slot_a(slot), Rows::AST, slot_b(slot)); });
    if (ch == q.Gc - 1) {  // the out product's first slices, in flight under the gates
      __syncthreads();     // (every thread's last reads of the ring are done)
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < q.GHp / BK)
          load_w<NT, BK * NB * 4>(slot_b(s), w_out + static_cast<size_t>(s) * BK * NB);
        cp_commit();
      }
    }
    const int h0 = ch * 64 + 4 * tx;
    if (h0 < q.GHp) {
      float bt[4], bs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = h0 + j;
        bt[j] = h < GH ? b_g[h] : 0.f;
        bs[j] = h < GH ? b_g[GH + h] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float4 z;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          at(z, j) = rnd<T>(tanhf(acc[i][j] + bt[j]) * sigmoid_f(acc[i][4 + j] + bs[j]));
        st4(z_t + row_of<TM>(i) * ZS + h0, z);
      }
    }
    GEN_PHASE(4);
  }

  // out product and epilogue: chunk columns nc * 128 + 64 f + 4 tx + j;
  // where C and S are multiples of 4 each group of 4 is all res or all skip
  const bool vec = C % 4 == 0 && S % 4 == 0;
  for (int nc = 0; nc < q.Nc; ++nc) {
    zero<2>(acc);
    ring(
        q.GHp / BK,
        [&](int s, int slot) {
          load_w<NT, BK * NB * 4>(slot_b(slot),
                                    w_out + (static_cast<size_t>(nc) * q.GHp + s * BK) * NB);
        },
        [&](int slot, int s) { fma_rows<TM, 2>(acc, z_t + s * BK, ZS, slot_b(slot)); },
        nc == 0);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int n0 = nc * NB + 64 * f + 4 * tx;
      if (n0 >= N) continue;
      float bo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bo[j] = n0 + j < N ? b_out[n0 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long row = r0 + row_of<TM>(i);
        if (row >= R) continue;
        float4 o;
#pragma unroll
        for (int j = 0; j < 4; ++j) at(o, j) = acc[i][4 * f + j] + bo[j];
        if (vec) {
          if (n0 < C) {
            if (ACC && last) continue;
            float4 xv = ld4(cat.x + row * C + n0);
#pragma unroll
            for (int j = 0; j < 4; ++j) at(xv, j) = at(xv, j) + rnd<T>(at(o, j));
            st4(res + row * C + n0, xv);
          } else {
            const long long a = row * S + n0 - C;
            if (!ACC) {
              st4(skip + a, o);
            } else {
              if (!first) {
                float4 s = ld4(skip_acc + a);
#pragma unroll
                for (int j = 0; j < 4; ++j) at(o, j) = at(s, j) + at(o, j);
              }
              if (last)
                st4(skip + a, o);
              else
                st4(skip_acc + a, o);
            }
          }
          continue;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + j;
          if (n >= N) continue;
          const float v = at(o, j);
          if (n < C) {
            if (!(ACC && last))
              res[row * C + n] = cvt<T>(f32(cat.x[row * C + n]) + rnd<T>(v));
          } else {
            const long long a = row * S + n - C;
            if (!ACC) {
              skip[a] = cvt<T>(v);
            } else {
              const float w = first ? v : skip_acc[a] + v;
              if (last)
                skip[a] = cvt<T>(w);
              else
                skip_acc[a] = w;
            }
          }
        }
      }
    }
    GEN_PHASE(5);
  }
  GEN_PHASE_TILE(0);
}

template <int TM, class T, bool ACC>
int launch(const void* x, const void* cond, const void* w_gate, const void* b_g,
           const void* w_out, const void* b_out, void* res, void* skip, void* skip_acc,
           int B, int T_, int c, int g, int s, int m, int d, int first, int last,
           cudaStream_t st) {
  const int smem = static_cast<int>(smem_at(TM, c, g, s, m, false));
  cudaError_t err = cudaFuncSetAttribute(gated_layer_generic<TM, T, ACC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long R = static_cast<long long>(B) * T_;
  constexpr int V = 16 / sizeof(T);
  const Cat<T> cat{static_cast<const T*>(x), static_cast<const T*>(cond), R, T_, c, m, d,
                   c % V == 0 && m % V == 0};
  gated_layer_generic<TM, T, ACC><<<static_cast<unsigned>((R + TM - 1) / TM), 2 * TM, smem, st>>>(
      cat, static_cast<const float*>(w_gate), static_cast<const float*>(b_g),
      static_cast<const float*>(w_out), static_cast<const float*>(b_out), static_cast<T*>(res),
      static_cast<T*>(skip), static_cast<float*>(skip_acc), g, s, first, last);
  return cudaGetLastError();
}

template <bool ACC>
int dispatch(const void* x, const void* cond, const void* w_gate, const void* b_g,
             const void* w_out, const void* b_out, void* res, void* skip, void* skip_acc,
             int B, int T_, int c, int g, int s, int m, int d, int first, int last,
             int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || T_ < 1 || d < 1 || !widths_ok(c, g, s, m, false))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = tile_rows(c, g, s, m, false) == 32;
#define PWN_LAUNCH(TM, T)                                                                  \
  launch<TM, T, ACC>(x, cond, w_gate, b_g, w_out, b_out, res, skip, skip_acc, B, T_, c, g, s, \
                     m, d, first, last, st)
  if (is_bf16) return wide ? PWN_LAUNCH(32, bf16) : PWN_LAUNCH(64, bf16);
  return wide ? PWN_LAUNCH(32, float) : PWN_LAUNCH(64, float);
#undef PWN_LAUNCH
}

}  // namespace

extern "C" {

// Shared memory a general body's block takes at these widths (backward:
// flow_stack_train_generic.cu's layer pass), at the tile `tile_rows` routes
// to, and that tile's rows.
long long pwn_generic_smem_bytes(int c, int g, int s, int m, int backward) {
  return smem_bytes(c, g, s, m, backward != 0);
}
int pwn_generic_tile_rows(int c, int g, int s, int m, int backward) {
  return tile_rows(c, g, s, m, backward != 0);
}

#ifdef PWN_GENERIC_PHASES
// Copies the phase cycles since the last call into out[16] and clears them.
int pwn_gated_layer_generic_phases(unsigned long long* out) {
  const unsigned long long zero[16] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, gen_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gen_phase_cycles, zero, sizeof(zero));
  return err;
}
#endif

// Kernel 5's general body, "layer" epilogue: res and skip out, operands
// fp32 (is_bf16 = 0) or bf16; the weights packed (w_gate, w_out: one layer
// of ops/flow_stack.py::pack_generic), the biases as gated_layer.cu takes
// them.  Returns a cudaError_t (0 on success); cudaErrorInvalidValue for
// widths it does not take.
int pwn_gated_layer_generic(const void* x, const void* cond, const void* w_gate,
                            const void* b_g, const void* w_out, const void* b_out, void* res,
                            void* skip, int B, int T, int c, int g, int s, int m, int dilation,
                            int is_bf16, void* stream) {
  return dispatch<false>(x, cond, w_gate, b_g, w_out, b_out, res, skip, nullptr, B, T, c, g, s,
                         m, dilation, 0, 0, is_bf16, stream);
}

// Kernel 5's general body, "accumulate" epilogue: layer `first` / `last` of
// a stack, as pwn_gated_layer_acc_bf16, on packed weights.
int pwn_gated_layer_acc_generic(const void* x, const void* cond, const void* w_gate,
                                const void* b_g, const void* w_out, const void* b_rs,
                                void* res, void* skip_acc, void* skip, int B, int T, int c,
                                int g, int s, int m, int dilation, int first, int last,
                                int is_bf16, void* stream) {
  return dispatch<true>(x, cond, w_gate, b_g, w_out, b_rs, res, skip, skip_acc, B, T, c, g, s,
                        m, dilation, first, last, is_bf16, stream);
}

}  // extern "C"
