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
// Design, with the host orchestration of flow_stack_train.cu (generic.cuh
// has the shared core: packed fp32 weights, a cp.async ring of 16-row
// slices, 8 x 8 register tiles of fp32 FMAs):
// * One launch per layer in reverse order (`layer_pass`).  CUDA blocks run
//   in no order, so the tap cotangent dx_l(t) needs dcs(t + d) from rows
//   of other blocks: each layer writes dpart = dx + dcx and dcs to device
//   memory in fp32, and the layer below reads dpart(t) + dcs(t + d) as its
//   dx.  dcs alternates between two buffers.  A last pass (`finalize`)
//   folds layer 0's dcs into dx and rounds dx and dcond.
// * The layer pass: one block of 2 TM threads per TM-row tile (64, or 32
//   at the widest widths: `tile_rows`).  dout = T([dx | dskip]) goes to a
//   resident fp32 tile (16-byte loads of dpart, dcs and dskip); dz = dout
//   @ W_out into a second tile, in 64-column chunks whose columns are the
//   gate chunks' own, so no product is half empty at G/2 = 64; the gates
//   are recomputed per chunk of 64 tanh columns and their sigmoid partners
//   from [x | tap | cond] streamed through the ring as in the forward, dg
//   formed in registers and stored over dout; dcat = dg @ W_in in
//   128-column chunks, whose epilogue writes dpart, dcs and dcond32 16 bytes
//   at a time.  Only z (or dz) and dout / dg stay resident, never the 2C + M
//   activation columns; at G/2 <= 64 dz sits over dout (dead by then), and
//   each thread turns its own dz into dg's tanh half in place.  At
//   student_iaf's widths in fp32 a block takes 73,728 bytes: three blocks
//   an SM where R gives every SM three tiles (168 registers a thread),
//   else two (255), `layer_blocks`.
// * Weight gradients: the layer pass stores dout, dg and z in fp32 (values
//   of T), and one launch of `wgrad_product` forms, over row ranges, the
//   partial sums cat^T dg and z^T dout (k-major operands on both sides,
//   so both stream by cp.async) with the bias sums dg^T 1 and dout^T 1 as
//   column sums of the same slices; `wgrad_reduce` sums the partials in
//   split order into dW_in, db_g, dW_out, db_rs.
// * Deterministic: no atomics, every sum in a fixed order, so two runs are
//   bit-identical and dx, dcond are the same bits in both modes (the
//   weight-gradient stores change no arithmetic).
// * Widths are runtime arguments: C, S, M >= 1, G even, and a routed tile
//   whose resident dout / dg and dz fit a block (gen::widths_ok): at the
//   wide teacher's (256, 512, 256, 80) 32-row tiles of 131,584 bytes.

#include "generic.cuh"

namespace {

using namespace gen;

// One layer of the backward over all tiles.  dcs_in is the layer above's
// dcs (null at the top, where dx = 0 and dcond32 is set, not added to);
// dout_g, dg_g, z_g (R x Np | 2 GHp | GHp, fp32) are stored for the
// weight-gradient product when not null.
template <int TM, int BLOCKS, class T>
__global__ void __launch_bounds__(2 * TM, TM == 64 ? BLOCKS : 2 * BLOCKS)
layer_pass(Cat<T> cat, const T* __restrict__ dskip, const float* __restrict__ w_gate,
           const float* __restrict__ b_g, const float* __restrict__ w_dz,
           const float* __restrict__ w_dcat, float* dpart, const float* __restrict__ dcs_in,
           float* __restrict__ dcs_out, float* __restrict__ dcond32, float* __restrict__ dout_g,
           float* __restrict__ dg_g, float* __restrict__ z_g, int G, int S, int d_prev) {
  constexpr int NT = 2 * TM, A_BYTES = TM * (BK * 4 + 16), SB = stage_bytes<TM>();
  using Rows = CatRows<TM, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  GEN_PHASE_START();
  const int C = cat.C, M = cat.M, T_ = cat.T_;
  const Pack q = pack_dims(C, G, S, M);
  const int GH = q.GH, N = q.N, K = q.K, ZS = q.GHp + 4;
  const int US = (q.Np > 2 * q.GHp ? q.Np : 2 * q.GHp) + 4;
  const long long R = cat.R, r0 = static_cast<long long>(blockIdx.x) * TM;
  const int t0 = static_cast<int>(r0 % T_);
  const int tx = threadIdx.x & 15;
  const bool top = dcs_in == nullptr;
  auto slot_a = [&](int s) { return reinterpret_cast<T*>(smem + s * SB); };
  auto slot_b = [&](int s) { return reinterpret_cast<float*>(smem + s * SB + A_BYTES); };
  // u_t [TM][US]: dout, then dg; dz_t [TM][ZS]: dz, in its own tile where
  // G/2 > 64, else in u_t's first GHp columns over dout (dead by then), so
  // that each thread turns its own dz columns into dg's tanh half in place
  const bool own_dz = q.Gc > 1;
  float* u_t = reinterpret_cast<float*>(smem + STAGES * SB);
  float* dz_t = own_dz ? u_t + TM * US : u_t;
  const int DS = own_dz ? ZS : US;
  Rows rows;
  rows.init(cat, r0);
  if (!top) prefetch_rows(dcond32, r0, R, M, TM);  // read in the dcat epilogue
  // where C, S, M are multiples of 4, each group of 4 columns lies in one
  // of dx, dskip, tap, cond
  const bool vec = C % 4 == 0 && S % 4 == 0 && M % 4 == 0;

  // dout = T([dx | dskip]), dx(t) = dpart(t) + dcs_in(t + d_prev) (0 at the
  // top), zero past N and past R
  for (int r = threadIdx.x >> 4; r < TM; r += NT / 16) {
    const long long row = r0 + r;
    const bool ok = row < R;
    const bool tap = ok && !top && tile_t(t0, r, T_) + d_prev < T_;
    for (int k = 4 * tx; k < q.Np; k += 64) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        if (vec && k < C) {
          if (!top) {
            v = ld4(dpart + row * C + k);
            if (tap) {
              const float4 s = ld4(dcs_in + (row + d_prev) * C + k);
              v = make_float4(v.x + s.x, v.y + s.y, v.z + s.z, v.w + s.w);
            }
            v = make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
          }
        } else if (vec && k < N) {
          v = ld4(dskip + row * S + k - C);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = k + j;
            if (kk < C) {
              if (!top)
                at(v, j) = rnd<T>(dpart[row * C + kk] +
                                  (tap ? dcs_in[(row + d_prev) * C + kk] : 0.f));
            } else if (kk < N) {
              at(v, j) = f32(dskip[row * S + kk - C]);
            }
          }
        }
        if (dout_g) st4(dout_g + row * q.Np + k, v);
      }
      st4(u_t + r * US + k, v);
    }
  }
  GEN_PHASE(0);

  // dz = dout @ W_out (packed (Gc, Np, 64)) into dz_t: chunk zc's columns
  // are gate chunk zc's tanh columns, 4 tx + j
  for (int zc = 0; zc < q.Gc; ++zc) {
    float a4[8][4];
    zero<1>(a4);
    ring(
        q.Np / BK,
        [&](int s, int slot) {
          load_w<NT, BK * 64 * 4>(slot_b(slot),
                                    w_dz + (static_cast<size_t>(zc) * q.Np + s * BK) * 64);
        },
        [&](int slot, int s) { fma_rows<TM, 1>(a4, u_t + s * BK, US, slot_b(slot)); });
    const int h0 = zc * 64 + 4 * tx;
    if (!own_dz) __syncthreads();  // every thread's last reads of dout are done
    if (h0 < q.GHp)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st4(dz_t + row_of<TM>(i) * DS + h0, make_float4(a4[i][0], a4[i][1], a4[i][2], a4[i][3]));
    GEN_PHASE(5);
  }

  // the gates recomputed, dg formed in registers and stored over dout (the
  // dz product is done: the ring starts with a barrier); the thread reads
  // back only the dz it stored itself, before it writes dg there
  float acc[8][8];
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
        const int r = row_of<TM>(i);
        float4 dz = ld4(dz_t + r * DS + h0), gt, gs, z;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float ta = tanhf(acc[i][j] + bt[j]), sb = sigmoid_f(acc[i][4 + j] + bs[j]);
          at(gt, j) = rnd<T>(at(dz, j) * sb * (1.f - ta * ta));
          at(gs, j) = rnd<T>(at(dz, j) * ta * sb * (1.f - sb));
          at(z, j) = rnd<T>(ta * sb);
        }
        st4(u_t + r * US + h0, gt);
        st4(u_t + r * US + q.GHp + h0, gs);
        const long long row = r0 + r;
        if (dg_g && row < R) {
          st4(dg_g + row * 2 * q.GHp + h0, gt);
          st4(dg_g + row * 2 * q.GHp + q.GHp + h0, gs);
          st4(z_g + row * q.GHp + h0, z);
        }
      }
    }
    GEN_PHASE(4);
  }

  // dcat = dg @ W_in (packed (2 GHp, Kc * 128)); the epilogue writes dpart,
  // dcs and dcond32
  unsigned taps = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (!top && tile_t(t0, row_of<TM>(i), T_) + d_prev < T_) taps |= 1u << i;
  const bool vecd = C % 4 == 0 && M % 4 == 0;
  for (int kc = 0; kc < q.Kc; ++kc) {
    zero<2>(acc);
    ring(
        2 * q.GHp / BK,
        [&](int s, int slot) {
          load_w<NT, BK * NB * 4>(slot_b(slot),
                                    w_dcat + (static_cast<size_t>(kc) * 2 * q.GHp + s * BK) * NB);
        },
        [&](int slot, int s) { fma_rows<TM, 2>(acc, u_t + s * BK, US, slot_b(slot)); });
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int k0 = kc * NB + 64 * f + 4 * tx;
      if (k0 >= K) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long row = r0 + row_of<TM>(i);
        if (row >= R) continue;
        const bool tap = (taps >> i) & 1;
        float4 v = make_float4(acc[i][4 * f], acc[i][4 * f + 1], acc[i][4 * f + 2],
                               acc[i][4 * f + 3]);
        if (vecd) {
          if (k0 < C) {
            float4 dx = make_float4(0.f, 0.f, 0.f, 0.f);
            if (!top) {
              dx = ld4(dpart + row * C + k0);
              if (tap) {
                const float4 s = ld4(dcs_in + (row + d_prev) * C + k0);
                dx = make_float4(dx.x + s.x, dx.y + s.y, dx.z + s.z, dx.w + s.w);
              }
            }
            st4(dpart + row * C + k0, make_float4(dx.x + v.x, dx.y + v.y, dx.z + v.z, dx.w + v.w));
          } else if (k0 < 2 * C) {
            st4(dcs_out + row * C + k0 - C, v);
          } else {
            const long long a = row * M + k0 - 2 * C;
            if (!top) {
              const float4 o = ld4(dcond32 + a);
              v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
            }
            st4(dcond32 + a, v);
          }
          continue;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + j;
          if (k >= K) continue;
          const float w = at(v, j);
          if (k < C) {
            const float dx = top ? 0.f
                                 : dpart[row * C + k] +
                                       (tap ? dcs_in[(row + d_prev) * C + k] : 0.f);
            dpart[row * C + k] = dx + w;
          } else if (k < 2 * C) {
            dcs_out[row * C + k - C] = w;
          } else {
            const long long a = row * M + k - 2 * C;
            dcond32[a] = top ? w : dcond32[a] + w;
          }
        }
      }
    }
    GEN_PHASE(5);
  }
  GEN_PHASE_TILE(0);
}

// One weight-gradient product: part[split][m][n] = sum over the split's
// rows of a[row][m] b[row][n] for m < mq, n < nw, and part[split][mq][n] =
// sum of b[row][n] (the bias sums).  b (dg or dout, fp32) is R x nw.
struct WProd {
  const float* b;
  int nw, mq, tiles_m, tiles_n;
  float* part;
};

// Both weight-gradient products of one layer in one launch: the first
// (a = cat [x | tap | cond], m < 2C + M; b = dg) gives dW_in and db_g, the
// second (a = z, m < G/2; b = dout) dW_out and db_rs.  One block per 64 x
// 128 output tile and row range: blockIdx.x runs over the first product's
// (m tile, n tile, split), then the second's.  The rows of a range stream
// through the ring in BK-row slices of both operands.
template <class T>
__global__ void __launch_bounds__(128, 3)
wgrad_product(Cat<T> cat, const float* __restrict__ z_g, int GHp, WProd p0, WProd p1,
              int splits, long long per) {
  constexpr int NT = 128;
  __shared__ __align__(16) float sa[STAGES][BK * 64], sb[STAGES][BK * NB];
  GEN_PHASE_START();
  const int first_blocks = p0.tiles_m * p0.tiles_n * splits;
  const bool second = static_cast<int>(blockIdx.x) >= first_blocks;
  const WProd w = second ? p1 : p0;
  const int b = second ? blockIdx.x - first_blocks : blockIdx.x;
  const int mt = b % w.tiles_m, nt = (b / w.tiles_m) % w.tiles_n,
            split = b / (w.tiles_m * w.tiles_n);
  const int m0 = 64 * mt, n0 = NB * nt;
  const long long q0 = split * per, q1 = q0 + per < cat.R ? q0 + per : cat.R;
  const int n = static_cast<int>((q1 - q0 + BK - 1) / BK);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // Each thread copies the same column chunk of its rows in every slice:
  // where that column comes from (for cat: x, the tap, cond or nothing) is
  // taken once, and the row offsets advance by BK rows a slice.
  constexpr int V = 16 / sizeof(T), CPR = 64 / V, JA = BK * CPR / NT;
  const int ka = threadIdx.x / CPR, qa = threadIdx.x % CPR, ca = m0 + qa * V;
  int seg = 3;  // cat's column ca: 0 x, 1 the tap, 2 cond, 3 zero
  const T* abase = cat.x;
  int ald = 0;
  if (ca < cat.C) {
    seg = 0, abase = cat.x + ca, ald = cat.C;
  } else if (ca < 2 * cat.C) {
    seg = 1, abase = cat.x + (ca - cat.C), ald = cat.C;
  } else if (ca < 2 * cat.C + cat.M) {
    seg = 2, abase = cat.cond + (ca - 2 * cat.C), ald = cat.M;
  }
  long long aoff = (q0 + ka - (seg == 1 ? cat.d : 0)) * ald;  // row q0 + ka's chunk
  int ta[JA];  // the t of this thread's cat rows (the tap's t >= d)
#pragma unroll
  for (int u = 0; u < JA; ++u) ta[u] = static_cast<int>((q0 + ka + u * (NT / CPR)) % cat.T_);
  const int cz = m0 + 4 * (threadIdx.x % 16), cb = n0 + 4 * (threadIdx.x % 32);
  long long zoff = (q0 + threadIdx.x / 16) * GHp + cz, boff = (q0 + threadIdx.x / 32) * w.nw + cb;
  float acc[8][8], bsum[8];
  zero<2>(acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) bsum[j] = 0.f;
  auto load = [&](int s, int slot) {
    const long long rb = q0 + static_cast<long long>(s) * BK;
    if (!second) {
      T* dst = reinterpret_cast<T*>(sa[slot]);
#pragma unroll
      for (int u = 0; u < JA; ++u) {
        const int kk = ka + u * (NT / CPR);
        const long long row = rb + kk;
        if (cat.vec) {
          const bool ok = seg < 3 && row < q1 && (seg != 1 || ta[u] >= cat.d);
          cp16(dst + kk * 64 + qa * V, ok ? abase + aoff + u * (NT / CPR) * ald : cat.x, ok);
        } else {
          cat_chunk(dst + kk * 64 + qa * V, cat,
                    row < q1 ? cat_row(cat, row, ta[u] >= cat.d) : CatRow<T>{nullptr, nullptr,
                                                                            nullptr},
                    ca);
        }
        ta[u] += BK;  // the next slice's t
        while (ta[u] >= cat.T_) ta[u] -= cat.T_;
      }
      aoff += BK * ald;
    } else {
#pragma unroll
      for (int u = 0; u < BK * 16 / NT; ++u) {
        const int kk = threadIdx.x / 16 + u * (NT / 16);
        const bool ok = rb + kk < q1 && cz < GHp;
        cp16(sa[slot] + kk * 64 + 4 * (threadIdx.x % 16),
             ok ? z_g + zoff + u * (NT / 16) * GHp : z_g, ok);
      }
      zoff += BK * GHp;
    }
#pragma unroll
    for (int u = 0; u < BK * 32 / NT; ++u) {
      const int kk = threadIdx.x / 32 + u * (NT / 32);
      const bool ok = rb + kk < q1 && cb < w.nw;
      cp16(sb[slot] + kk * NB + 4 * (threadIdx.x % 32),
           ok ? w.b + boff + u * (NT / 32) * w.nw : w.b, ok);
    }
    boff += BK * w.nw;
  };
  GEN_PHASE(8 + 0);
  if (!second) {
    if (mt == 0)
      ring<8>(n, load, [&](int slot, int) {
        fma_cols<true>(acc, bsum, reinterpret_cast<const T*>(sa[slot]), sb[slot]);
      });
    else
      ring<8>(n, load, [&](int slot, int) {
        fma_cols<false>(acc, bsum, reinterpret_cast<const T*>(sa[slot]), sb[slot]);
      });
  } else {
    if (mt == 0)
      ring<8>(n, load, [&](int slot, int) { fma_cols<true>(acc, bsum, sa[slot], sb[slot]); });
    else
      ring<8>(n, load, [&](int slot, int) { fma_cols<false>(acc, bsum, sa[slot], sb[slot]); });
  }
  float* out = w.part + static_cast<size_t>(split) * (w.mq + 1) * w.nw;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int nn = n0 + 64 * f + 4 * tx;
    if (nn >= w.nw) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? 4 * ty + i : 28 + 4 * ty + i);
      if (m < w.mq)
        st4(out + static_cast<size_t>(m) * w.nw + nn,
            make_float4(acc[i][4 * f], acc[i][4 * f + 1], acc[i][4 * f + 2], acc[i][4 * f + 3]));
    }
    if (mt == 0 && ty == 0)
      st4(out + static_cast<size_t>(w.mq) * w.nw + nn,
          make_float4(bsum[4 * f], bsum[4 * f + 1], bsum[4 * f + 2], bsum[4 * f + 3]));
  }
  GEN_PHASE(8 + 5);
  GEN_PHASE_TILE(8);
}

// The sum of part[sp * n] over sp < splits, in split order; eight loads in
// flight at a time (one after another, each an L2 round trip, they would
// take longer than the products).
__device__ __forceinline__ float split_sum(const float* part, int splits, long long n) {
  float s = 0.f;
  int sp = 0;
  for (; sp + 8 <= splits; sp += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = part[(sp + u) * n];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; sp < splits; ++sp) s += part[sp * n];
  return s;
}

// Sums both products' partials in split order, for layer blockIdx.y of
// every layer's partials (one launch after the last layer pass): dW_in[g][k],
// db_g[g] from the first (its n is dg's column: tanh h, or GHp + h for the
// sigmoid partner), dW_out[n][h], db_rs[n] from the second.
__global__ void wgrad_reduce(const float* __restrict__ part0, const float* __restrict__ part1,
                             int splits, Pack q, float* __restrict__ dw_in,
                             float* __restrict__ db_g, float* __restrict__ dw_out,
                             float* __restrict__ db_rs) {
  const long long n0 = static_cast<long long>(q.K + 1) * 2 * q.GHp;
  const long long n1 = static_cast<long long>(q.GH + 1) * q.Np;
  const int l = blockIdx.y, G = 2 * q.GH;
  part0 += l * splits * n0;
  part1 += l * splits * n1;
  dw_in += static_cast<size_t>(l) * G * q.K;
  db_g += static_cast<size_t>(l) * G;
  dw_out += static_cast<size_t>(l) * q.N * q.GH;
  db_rs += static_cast<size_t>(l) * q.N;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n0) {
    const int m = static_cast<int>(i / (2 * q.GHp)), c = static_cast<int>(i % (2 * q.GHp));
    const int h = c < q.GHp ? c : c - q.GHp;
    if (h >= q.GH) return;
    const int g = c < q.GHp ? h : q.GH + h;
    const float s = split_sum(part0 + i, splits, n0);
    if (m < q.K)
      dw_in[static_cast<size_t>(g) * q.K + m] = s;
    else
      db_g[g] = s;
    return;
  }
  i -= n0;
  if (i >= n1) return;
  const int m = static_cast<int>(i / q.Np), c = static_cast<int>(i % q.Np);
  if (c >= q.N) return;
  const float s = split_sum(part1 + i, splits, n1);
  if (m < q.GH)
    dw_out[static_cast<size_t>(c) * q.GH + m] = s;
  else
    db_rs[c] = s;
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
      float v = dpart[i];
      if (row % T_ + d0 < T_) v += dcs[(row + d0) * C + k];
      dx[i] = cvt<T>(v);
    } else {
      dcond[i - n_dx] = cvt<T>(dcond32[i - n_dx]);
    }
  }
}

// The split of R rows into row ranges shared by both weight-gradient
// products: one wave of blocks at three an SM (all blocks do the same work,
// so they end together), each range a multiple of BK rows.
struct Splits {
  long long per;
  int splits, tiles0, tiles1;
};

Splits wgrad_splits(long long R, const Pack& q, int n_sm) {
  Splits w;
  w.tiles0 = ((q.K + 63) / 64) * ((2 * q.GHp + NB - 1) / NB);
  w.tiles1 = ((q.GH + 63) / 64) * ((q.Np + NB - 1) / NB);
  long long s = 3LL * n_sm / (w.tiles0 + w.tiles1);
  const long long max_s = (R + BK - 1) / BK;
  s = s < 1 ? 1 : s > max_s ? max_s : s;
  w.per = ((R + s - 1) / s + BK - 1) / BK * BK;
  w.splits = static_cast<int>((R + w.per - 1) / w.per);
  return w;
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

struct Workspace {
  size_t dpart, dcs0, dcs1, dcond32, dout, dg, z, part0, part1, total;
};

// The backward's device workspace; the weight-gradient partials of all L
// layers are kept, and summed by one launch at the end.
Workspace workspace(long long R, int L, int C, int G, int S, int M, int want_wgrads, int n_sm) {
  Workspace w{};
  size_t off = 0;
  auto take = [&](size_t bytes) { const size_t at = off; off += align256(bytes); return at; };
  const Pack q = pack_dims(C, G, S, M);
  w.dpart = take(R * C * 4);
  w.dcs0 = take(R * C * 4);
  w.dcs1 = take(R * C * 4);
  w.dcond32 = take(R * M * 4);
  if (want_wgrads) {
    const Splits sp = wgrad_splits(R, q, n_sm);
    w.dout = take(R * q.Np * 4);
    w.dg = take(R * 2 * q.GHp * 4);
    w.z = take(R * q.GHp * 4);
    w.part0 = take(static_cast<size_t>(L) * sp.splits * (q.K + 1) * 2 * q.GHp * 4);
    w.part1 = take(static_cast<size_t>(L) * sp.splits * (q.GH + 1) * q.Np * 4);
  }
  w.total = off;
  return w;
}

// One layer's weight-gradient partials from the layer pass's stored dout
// (R, Np), dg (R, 2 GHp) and z (R, GHp), fp32, and its input cat, into
// layer l's part0 / part1.
template <class T>
cudaError_t wgrad_products(const Cat<T>& cat, const float* dg_g, const float* dout_g,
                           const float* z_g, const Pack& q, int n_sm, int l, float* part0,
                           float* part1, cudaStream_t st) {
  const Splits sp = wgrad_splits(cat.R, q, n_sm);
  const size_t n0 = static_cast<size_t>(q.K + 1) * 2 * q.GHp,
               n1 = static_cast<size_t>(q.GH + 1) * q.Np;
  const WProd p0{dg_g, 2 * q.GHp, q.K, (q.K + 63) / 64, (2 * q.GHp + NB - 1) / NB,
                 part0 + l * sp.splits * n0};
  const WProd p1{dout_g, q.Np, q.GH, (q.GH + 63) / 64, (q.Np + NB - 1) / NB,
                 part1 + l * sp.splits * n1};
  wgrad_product<T><<<(sp.tiles0 + sp.tiles1) * sp.splits, 128, 0, st>>>(cat, z_g, q.GHp, p0, p1,
                                                                       sp.splits, sp.per);
  return cudaGetLastError();
}

// The L layers' weight gradients from their partials, summed in split order.
cudaError_t wgrad_sums(long long R, const Pack& q, int n_sm, int L, const float* part0,
                       const float* part1, float* dw_in, float* db_g, float* dw_out,
                       float* db_rs, cudaStream_t st) {
  const long long n =
      static_cast<long long>(q.K + 1) * 2 * q.GHp + static_cast<long long>(q.GH + 1) * q.Np;
  const dim3 grid(static_cast<unsigned>((n + 255) / 256), L);
  wgrad_reduce<<<grid, 256, 0, st>>>(part0, part1, wgrad_splits(R, q, n_sm).splits, q, dw_in,
                                     db_g, dw_out, db_rs);
  return cudaGetLastError();
}

template <int TM, int BLOCKS, class T>
int train_bwd(const T* acts, const T* cond, const T* dskip, const float* w_gate,
              const float* b_g, const float* w_dz, const float* w_dcat, T* dx, T* dcond,
              float* dw_in, float* db_g, float* dw_out, float* db_rs, unsigned char* ws, int B,
              int T_, int L, int C, int G, int S, int M, const int* dil, int want_wgrads,
              int n_sm, cudaStream_t st) {
  const int smem = static_cast<int>(smem_at(TM, C, G, S, M, true));
  cudaError_t err = cudaFuncSetAttribute(layer_pass<TM, BLOCKS, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long R = static_cast<long long>(B) * T_;
  const Pack q = pack_dims(C, G, S, M);
  const Workspace w = workspace(R, L, C, G, S, M, want_wgrads, n_sm);
  float* dpart = reinterpret_cast<float*>(ws + w.dpart);
  float* dcs[2] = {reinterpret_cast<float*>(ws + w.dcs0), reinterpret_cast<float*>(ws + w.dcs1)};
  float* dcond32 = reinterpret_cast<float*>(ws + w.dcond32);
  float* dout_g = want_wgrads ? reinterpret_cast<float*>(ws + w.dout) : nullptr;
  float* dg_g = want_wgrads ? reinterpret_cast<float*>(ws + w.dg) : nullptr;
  float* z_g = want_wgrads ? reinterpret_cast<float*>(ws + w.z) : nullptr;
  float* part0 = reinterpret_cast<float*>(ws + w.part0);
  float* part1 = reinterpret_cast<float*>(ws + w.part1);
  constexpr int V = 16 / sizeof(T);
  const unsigned grid = static_cast<unsigned>((R + TM - 1) / TM);
  const size_t gate_l = static_cast<size_t>(q.Kp) * q.Gc * NB,
               dz_l = static_cast<size_t>(q.Np) * q.Gc * 64,
               dcat_l = static_cast<size_t>(2 * q.GHp) * q.Kc * NB;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    cur = (L - 1 - l) & 1;
    const Cat<T> cat{acts + static_cast<size_t>(l) * R * C, cond, R, T_, C, M, dil[l],
                     C % V == 0 && M % V == 0};
    layer_pass<TM, BLOCKS, T><<<grid, 2 * TM, smem, st>>>(
        cat, dskip, w_gate + l * gate_l, b_g + static_cast<size_t>(l) * G, w_dz + l * dz_l,
        w_dcat + l * dcat_l, dpart, l == L - 1 ? nullptr : dcs[cur ^ 1], dcs[cur], dcond32,
        dout_g, dg_g, z_g, G, S, l == L - 1 ? 0 : dil[l + 1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (!want_wgrads) continue;
    err = wgrad_products(cat, dg_g, dout_g, z_g, q, n_sm, l, part0, part1, st);
    if (err != cudaSuccess) return err;
  }
  if (want_wgrads) {
    err = wgrad_sums(R, q, n_sm, L, part0, part1, dw_in, db_g, dw_out, db_rs, st);
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

template <class T>
int run(const void* acts, const void* cond, const void* dskip, const float* w_gate,
        const float* b_g, const float* w_dz, const float* w_dcat, void* dx, void* dcond,
        float* dw_in, float* db_g, float* dw_out, float* db_rs, unsigned char* ws, int B, int T_,
        int L, int c, int g, int s, int m, const int* dil, int want_wgrads, int n_sm,
        cudaStream_t st) {
#define PWN_RUN(TM, BLOCKS)                                                                \
  train_bwd<TM, BLOCKS, T>(static_cast<const T*>(acts), static_cast<const T*>(cond),         \
                           static_cast<const T*>(dskip), w_gate, b_g, w_dz, w_dcat,           \
                           static_cast<T*>(dx), static_cast<T*>(dcond), dw_in, db_g, dw_out,  \
                           db_rs, ws, B, T_, L, c, g, s, m, dil, want_wgrads, n_sm, st)
  const int tm = tile_rows(c, g, s, m, true);
  const bool three = layer_blocks(static_cast<long long>(B) * T_, tm) == 3;
  if (tm == 32) return three ? PWN_RUN(32, 3) : PWN_RUN(32, 2);
  return three ? PWN_RUN(64, 3) : PWN_RUN(64, 2);
#undef PWN_RUN
}

}  // namespace

extern "C" {

#ifdef PWN_GENERIC_PHASES
// Copies the phase cycles since the last call into out[16] (layer pass
// [0, 8), weight-gradient product [8, 16)) and clears them.
int pwn_flow_stack_train_generic_phases(unsigned long long* out) {
  const unsigned long long zero[16] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, gen_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gen_phase_cycles, zero, sizeof(zero));
  return err;
}
#endif

// Bytes of device workspace the general backward of L layers needs (the
// fp32 dx, tap and dcond chains, and with weight gradients dout, dg and z in
// fp32 and every layer's split partials); -1 for widths it does not take.
long long pwn_flow_stack_train_bwd_generic_workspace_bytes(int B, int T, int L, int c, int g,
                                                           int s, int m, int want_wgrads,
                                                           int n_sm) {
  if (B < 1 || T < 1 || L < 1 || n_sm < 1 || !widths_ok(c, g, s, m, true)) return -1;
  return static_cast<long long>(
      workspace(static_cast<long long>(B) * T, L, c, g, s, m, want_wgrads, n_sm).total);
}

// Bytes of device workspace `pwn_flow_stack_train_wgrad_generic` needs (the
// split partials); -1 for widths it does not take.
long long pwn_flow_stack_train_wgrad_generic_workspace_bytes(int B, int T, int c, int g, int s,
                                                             int m, int n_sm) {
  if (B < 1 || T < 1 || n_sm < 1 || !widths_ok(c, g, s, m, true)) return -1;
  const Workspace w = workspace(static_cast<long long>(B) * T, 1, c, g, s, m, 1, n_sm);
  return static_cast<long long>(w.total - w.part0);
}

// Kernel 3's general weight-gradient product alone, for one layer: from its
// input x (B, T, C) and cond (B, T, M) in the operand type and the layer
// pass's stored fp32 dout (B, T, Np), dg (B, T, 2 GHp: the tanh columns,
// then the sigmoid ones, each padded to GHp) and z (B, T, GHp), the fp32
// dw_in (G, 2C+M), db_g (G), dw_out (C+S, G/2), db_rs (C+S).  The backward
// runs the same kernels inside its one call; this entry point serves tests
// and timing; `scratch` holds
// pwn_flow_stack_train_wgrad_generic_workspace_bytes(...) bytes.  Returns a
// cudaError_t (0 on success).
int pwn_flow_stack_train_wgrad_generic(const void* x, const void* cond, const void* dg,
                                       const void* dout, const void* z, void* dw_in, void* db_g,
                                       void* dw_out, void* db_rs, void* scratch, int B, int T,
                                       int c, int g, int s, int m, int dilation, int n_sm,
                                       int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || dilation < 1 || n_sm < 1 || !widths_ok(c, g, s, m, true))
    return cudaErrorInvalidValue;
  const long long R = static_cast<long long>(B) * T;
  const Pack q = pack_dims(c, g, s, m);
  const Workspace w = workspace(R, 1, c, g, s, m, 1, n_sm);
  float* part0 = static_cast<float*>(scratch);
  float* part1 = reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) + w.part1 - w.part0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *dgp = static_cast<const float*>(dg), *dop = static_cast<const float*>(dout),
              *zp = static_cast<const float*>(z);
  float *dwi = static_cast<float*>(dw_in), *dbg = static_cast<float*>(db_g),
        *dwo = static_cast<float*>(dw_out), *dbr = static_cast<float*>(db_rs);
  if (is_bf16) {
    const Cat<bf16> cat{static_cast<const bf16*>(x), static_cast<const bf16*>(cond), R, T, c, m,
                        dilation, c % 8 == 0 && m % 8 == 0};
    const cudaError_t err = wgrad_products(cat, dgp, dop, zp, q, n_sm, 0, part0, part1, st);
    return err ? err : wgrad_sums(R, q, n_sm, 1, part0, part1, dwi, dbg, dwo, dbr, st);
  }
  const Cat<float> cat{static_cast<const float*>(x), static_cast<const float*>(cond), R, T, c, m,
                       dilation, c % 4 == 0 && m % 4 == 0};
  const cudaError_t err = wgrad_products(cat, dgp, dop, zp, q, n_sm, 0, part0, part1, st);
  return err ? err : wgrad_sums(R, q, n_sm, 1, part0, part1, dwi, dbg, dwo, dbr, st);
}

// Kernel 3's general body: dx (B, T, C) and dcond (B, T, M) in the operand
// type (fp32, or bf16 with is_bf16); with want_wgrads the fp32 dw_in (L, G,
// 2C+M), db_g (L, G), dw_out (L, C+S, G/2), db_rs (L, C+S), stored (out, in)
// like w_in and w_out.  w_gate, w_dz, w_dcat are the stack's packed weights
// (ops/flow_stack.py::pack_generic).  `workspace` holds
// pwn_flow_stack_train_bwd_generic_workspace_bytes(...) bytes.  Returns a
// cudaError_t (0 on success).
int pwn_flow_stack_train_bwd_generic(const void* acts, const void* cond, const void* dskip,
                                     const void* w_gate, const void* b_g, const void* w_dz,
                                     const void* w_dcat, void* dx, void* dcond, void* dw_in,
                                     void* db_g, void* dw_out, void* db_rs, void* workspace,
                                     int B, int T, int L, int c, int g, int s, int m,
                                     const int* dilations, int want_wgrads, int n_sm,
                                     int is_bf16, void* stream) {
  if (!valid(B, T, L, dilations, c, g, s, m) || n_sm < 1) return cudaErrorInvalidValue;
  if (want_wgrads && (!dw_in || !db_g || !dw_out || !db_rs)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  const float *wg = static_cast<const float*>(w_gate), *bg = static_cast<const float*>(b_g),
              *wz = static_cast<const float*>(w_dz), *wc = static_cast<const float*>(w_dcat);
  float *dwi = static_cast<float*>(dw_in), *dbg = static_cast<float*>(db_g);
  float *dwo = static_cast<float*>(dw_out), *dbr = static_cast<float*>(db_rs);
  if (is_bf16)
    return run<bf16>(acts, cond, dskip, wg, bg, wz, wc, dx, dcond, dwi, dbg, dwo, dbr, ws, B, T,
                     L, c, g, s, m, dilations, want_wgrads, n_sm, st);
  return run<float>(acts, cond, dskip, wg, bg, wz, wc, dx, dcond, dwi, dbg, dwo, dbr, ws, B, T,
                    L, c, g, s, m, dilations, want_wgrads, n_sm, st);
}

}  // extern "C"
