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
//   time segment) and walks it in order in tiles of TT = 128 rows.  It starts
//   halo = sum(d_l) samples before its segment from zero history: the top
//   layer's output at t depends on x0 only in [t - sum(d), t], and x0 (the
//   front 1x1 output) is in device memory for all T, so the recomputed halo
//   makes every emitted sample exact.  The segment length is chosen by the
//   caller so that B * segments fills the SMs; the halo is the price.
// * Each layer keeps a ring of only its last d_l inputs in shared memory
//   (sum(d) = 1023 rows for a student flow), beside this layer's x tile and
//   the cond tile.  The ring is read (the taps of rows t < d) before it is
//   written within a layer step, so d_l rows suffice.
// * The weights (0.7 MB of bf16 per stack) do not fit beside the rings, so
//   they stream: one producer thread brings each layer's k-slices by TMA into
//   a ring of three mbarrier-guarded 16 KB stages, 128 weight rows x 64 input
//   columns each, W_in's 208 columns as slices 64 / 64 / 64 / 16 (the last
//   box zero past column 208) and W_out's 64 as one.  They arrive stored
//   (out, in), the layout WaveNetStack.stacked() builds once per model, which
//   is wgmma's K-major B operand; the 128-byte swizzle is TMA's and wgmma's.
//   Every block reads all of a layer's weights once per tile from L2.
// * Products on wgmma, two consumer warpgroups of 64 rows each.  A comes from
//   registers: ldmatrix from the x tile, the cond tile, and for the tap from
//   the x tile at row r - d or the ring, which takes the tap's start row at
//   any alignment (a swizzled shared-memory A descriptor would not).  B comes
//   from the weight ring.  A slice's fragments load and its products issue
//   while the previous slice's run (wgmma.wait_group 1).
// * z never leaves registers.  The gate accumulator is m64n128, whose tanh
//   half [0, 64) and sigmoid half [64, 128) share one fragment layout, so z
//   is formed elementwise (`gate`: the hardware's exp2 and reciprocal, as in
//   kernel 5, absolute error below 3e-7), rounded to bf16 and repacked as the
//   A fragments of the out product, m64n128.  The out accumulator's skip half
//   is summed in fp32 in registers across all layers and emitted once per
//   tile; its residual half updates each thread's own x values, which it
//   holds in registers from layer to layer, and the x tile in place.
// * Barriers: mbarriers between the producer and the consumers; two named
//   barriers among the 256 consumer threads per layer (every read of x, the
//   taps and the ring done before the residual and ring writes; those done
//   before the next layer reads), none with the producer.  The skip sum is
//   updated before the first, where a warpgroup would otherwise wait.
// * Where the time goes (tools/torch_flow_stack_phases.py and builds with a
//   phase removed, on the H100): the gates are bound by the MUFU (three
//   operations per element, 16 a cycle per SM) and the epilogue by latency;
//   the weight stream costs ~3%.  With one block of eight consumer warps per
//   SM, offsetting the two warpgroups so that one's gates overlap the
//   other's products was slower, not faster.
// * Shared memory, sum(d) = 1023: weight ring 48 KB, x tile 16 KB and ring
//   128 KB in 128-byte rows with the 16-byte groups XORed by row % 8 (the
//   ldmatrix reads of 8 rows fall in distinct banks), cond tile 22 KB in rows
//   padded to 176 bytes (the same), barriers: 220 KB of the 227 KB.
// * A pipeline fault traps (mbar_wait) instead of hanging the card.
//
// With PWN_FLOW_STACK_PHASES defined (tools/torch_flow_stack_phases.py builds
// it so), thread 0 of block (0, 0) adds the clock cycles of each phase of
// each of its tiles into fs_phase_cycles: waiting for weights, the gate
// product, the gates, the out product, the skip sum, residual and ring update
// (with its two barriers), the tile's loads and its skip store; [6] counts
// tiles.

#include "hopper.cuh"

namespace {

constexpr int C = 64;             // residual channels
constexpr int GH = 64;            // gate channels / 2 (tanh half, sigmoid half)
constexpr int G = 2 * GH;         // gate channels
constexpr int S = 64;             // skip channels
constexpr int M = 80;             // conditioning channels (mel bands)
constexpr int K_IN = 2 * C + M;   // gate depth: [x | shift(x, d) | cond]
constexpr int N_OUT = C + S;      // out width: [residual | skip]
constexpr int TT = 128;           // rows per time tile
constexpr int WG_ROWS = 64;       // rows per consumer warpgroup
constexpr int NCONS = TT / WG_ROWS;
constexpr int CONS_THREADS = 128 * NCONS;
constexpr int NTHREADS = CONS_THREADS + 128;  // + the producer warpgroup
constexpr int MAX_L = 32;
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = G * ROW_BYTES;     // 128 weight rows x 64 columns
constexpr int NCH_IN = 4;                      // W_in slices: x, tap, cond, cond tail
constexpr int NCH = NCH_IN + 1;                // + W_out
constexpr int CS = M + 8;                      // cond row stride (bf16): 176 bytes
constexpr int X_OFF = STAGES * STAGE_BYTES;
constexpr int C_OFF = X_OFF + TT * ROW_BYTES;
constexpr int RING_OFF = C_OFF + TT * CS * 2;  // then sum(d) ring rows, the barriers
constexpr int ALIGN = 1024;                    // the 128-byte swizzle's period

static_assert(GH == KC && C == KC && N_OUT == STAGE_BYTES / ROW_BYTES,
              "one 64-column slice per operand, one stage per slice");
static_assert(M > KC && M <= 2 * KC && M % 16 == 0, "cond in two slices");
static_assert(RING_OFF % ROW_BYTES == 0 && (CS * 2) % 16 == 0, "row alignment");

struct Dilations {
  int d[MAX_L];    // dilation of layer l
  int off[MAX_L];  // first ring row of layer l
};

#ifdef PWN_FLOW_STACK_PHASES
__device__ unsigned long long fs_phase_cycles[7];
// a reduction whose result is not read: the thread does not wait for it
#define PHASE(k)                                                               \
  do {                                                                         \
    if (phase_on) {                                                            \
      const long long now = clock64();                                         \
      atomicAdd(&fs_phase_cycles[k], static_cast<unsigned long long>(now - phase_t)); \
      phase_t = now;                                                           \
    }                                                                          \
  } while (0)
#else
#define PHASE(k)
#endif

// Byte address of 16-byte group `chunk` of `row` in 128-byte rows whose
// groups are XORed with row % 8.
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  return base + row * ROW_BYTES + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The consumers' own barrier; the producer never joins it.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONS_THREADS) : "memory");
}

// One block = one (batch row, time segment).  Grid (segments, B).
//   tm_win  W_in  (L * G, K_IN)      bf16, stored (out, in): 64 x 128 boxes
//   tm_wout W_out (L * N_OUT, GH)    bf16, stored (out, in): 64 x 128 boxes
//   x0      (B, T, C)  bf16   front 1x1 output
//   cond    (B, T, M)  bf16
//   b_g     (L, G)     fp32
//   b_rs    (L, N_OUT) fp32
//   skip    (B, T, S)  bf16   output
// Ring order, per tile and layer: W_in's four slices, then W_out.
__global__ void __launch_bounds__(NTHREADS, 1)
flow_stack_kernel(const __grid_constant__ CUtensorMap tm_win,
                  const __grid_constant__ CUtensorMap tm_wout,
                  const bf16* __restrict__ x0, const bf16* __restrict__ cond,
                  const float* __restrict__ b_g, const float* __restrict__ b_rs,
                  bf16* __restrict__ skip, int T, int L, int seg, int halo,
                  Dilations dils) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  const uint32_t ws = base, xs = base + X_OFF, cs = base + C_OFF, rs = base + RING_OFF;
  const uint32_t full = rs + halo * ROW_BYTES, empty = full + 8 * STAGES;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * seg;
  const int t1 = min(T, t0 + seg);
  const int t_begin = max(0, t0 - halo);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCONS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NCONS) {
    // producer warpgroup: one thread starts every weight copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONS_THREADS) {
      int c = 0;  // ring slot count
      for (int s = t_begin; s < t1; s += TT)
        for (int l = 0; l < L; ++l)
          for (int i = 0; i < NCH; ++i, ++c) {
            const int st = c % STAGES;
            const uint32_t dst = ws + st * STAGE_BYTES, bar = full + 8 * st;
            mbar_wait(empty + 8 * st, ((c / STAGES) & 1) ^ 1);
            mbar_expect_tx(bar, STAGE_BYTES);
            if (i < NCH_IN)
              tma_load_2d(dst, &tm_win, i * KC, l * G, bar);
            else
              tma_load_2d(dst, &tm_wout, 0, l * N_OUT, bar);
          }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x;  // 0 .. CONS_THREADS - 1
  const int warp = (ct % 128) / 32, lane = ct % 32;
  const int q = lane % 4;
  // accumulator rows of this thread within the tile: r0 and r0 + 8
  const int r0 = wg * WG_ROWS + warp * 16 + lane / 4;
  // the A row whose address this lane gives ldmatrix, and its 8-column half
  const int lrow = wg * WG_ROWS + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;

  const bf16* x0b = x0 + static_cast<size_t>(b) * T * C;
  const bf16* cb = cond + static_cast<size_t>(b) * T * M;
  bf16* sb = skip + static_cast<size_t>(b) * T * S;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
#ifdef PWN_FLOW_STACK_PHASES
  const bool phase_on = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  long long phase_t = clock64();
#endif

  // zero history: exact causal padding at t_begin = 0, and for t_begin > 0
  // the halo makes the difference vanish before t0
  for (int i = ct; i < halo * (ROW_BYTES / 16); i += CONS_THREADS) sts128(rs + 16 * i, zero4);

  int c = 0;  // ring slot count, as the producer's
  for (int s = t_begin; s < t1; s += TT) {
    // this tile's x0 and cond (the previous tile's last barrier has passed)
    for (int i = ct; i < TT * (C / 8); i += CONS_THREADS) {
      const int r = i / (C / 8), ch = i % (C / 8);
      uint4 v = zero4;
      if (s + r < T) v = __ldg(reinterpret_cast<const uint4*>(x0b + (size_t)(s + r) * C) + ch);
      sts128(swz(xs, r, ch), v);
    }
    for (int i = ct; i < TT * (M / 8); i += CONS_THREADS) {
      const int r = i / (M / 8), ch = i % (M / 8);
      uint4 v = zero4;
      if (s + r < T) v = __ldg(reinterpret_cast<const uint4*>(cb + (size_t)(s + r) * M) + ch);
      sts128(cs + r * CS * 2 + 16 * ch, v);
    }
    consumers_sync();
    PHASE(5);
    uint32_t xr[C / 8][2];  // this thread's x values, as the residual needs them
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < C / 8; ++j) xr[j][h] = lds32(swz(xs, r0 + 8 * h, j) + 4 * q);

    float sacc[S / 2];  // skip sum of this thread's fragment, fp32
#pragma unroll
    for (int i = 0; i < S / 2; ++i) sacc[i] = 0.f;

    for (int l = 0; l < L; ++l) {
      const int d = dils.d[l];
      const int off = dils.off[l];
      // the tap row of this lane: x(t - d) is in the tile at row lrow - d,
      // or in the ring at slot t mod d
      const bool tap_in_tile = lrow >= d;
      const uint32_t tap_base = tap_in_tile ? xs : rs;
      const int tap_row = tap_in_tile ? lrow - d : off + (s + lrow) % d;

      // ---- gate product over [x | tap | cond]: m64n128, fp32
      float acc[G / 2];
#pragma unroll
      for (int i = 0; i < G / 2; ++i) acc[i] = 0.f;
      // Slice i's fragments load and its products issue while slice i - 1's
      // run; a stage goes back to the producer once its products are done.
#pragma unroll
      for (int i = 0; i < NCH_IN; ++i) {
        const int st = (c + i) % STAGES;
        const int steps = i < NCH_IN - 1 ? KC / 16 : (M - KC) / 16;
        uint32_t a[KC / 16][4];
#pragma unroll
        for (int k = 0; k < steps; ++k) {
          const int ch = 2 * k + lhalf;  // 16-byte group within the slice
          const uint32_t addr =
              i == 0 ? swz(xs, lrow, ch)
              : i == 1 ? swz(tap_base, tap_row, ch)
                       : cs + lrow * CS * 2 + ((i - 2) * KC / 8 + ch) * 16;
          ldmatrix_x4(a[k], addr);
        }
        PHASE(1);
        mbar_wait(full + 8 * st, ((c + i) / STAGES) & 1);
        PHASE(0);
        const uint64_t db = desc_sw128(ws + st * STAGE_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < steps; ++k) wgmma_m64n128_rs(acc, a[k], db + 2 * k);
        wgmma_commit();
        if (i > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * ((c + i - 1) % STAGES));
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * ((c + NCH_IN - 1) % STAGES));
      fence_regs(acc);
      c += NCH_IN;
      PHASE(1);

      // ---- z = tanh(g[:GH]) * sigmoid(g[GH:]) into the out product's A
      // fragments: k-step kk takes z columns 16kk + [0, 16), which are the
      // gate accumulator's fragments j = 2kk (a0: row g, a1: row g + 8) and
      // 2kk + 1 (a2, a3); fragment j's sigmoid partner is j + GH/8
      const float* bgl = b_g + static_cast<size_t>(l) * G;
      uint32_t za[GH / 16][4];
#pragma unroll
      for (int j = 0; j < GH / 8; ++j) {
        const int col = 8 * j + 2 * q;
        const float2 bt = __ldg(reinterpret_cast<const float2*>(bgl + col));
        const float2 bs = __ldg(reinterpret_cast<const float2*>(bgl + GH + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h, f = 4 * (j + GH / 8) + 2 * h;
          za[j / 2][2 * (j % 2) + h] = pack(gate(acc[e] + bt.x, acc[f] + bs.x),
                                            gate(acc[e + 1] + bt.y, acc[f + 1] + bs.y));
        }
      }
      PHASE(2);

      // ---- out product: z @ W_out, m64n128, fp32
      float out[N_OUT / 2];
#pragma unroll
      for (int i = 0; i < N_OUT / 2; ++i) out[i] = 0.f;
      {
        const int st = c % STAGES;
        mbar_wait(full + 8 * st, (c / STAGES) & 1);
        PHASE(0);
        const uint64_t db = desc_sw128(ws + st * STAGE_BYTES);
        fence_regs(out);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < GH / 16; ++k) wgmma_m64n128_rs(out, za[k], db + 2 * k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(out);
        if (lane == 0) mbar_arrive(empty + 8 * st);
        ++c;
      }
      PHASE(3);

      const float* brl = b_rs + static_cast<size_t>(l) * N_OUT;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = C / 8; j < N_OUT / 8; ++j) {
          const float2 bias = __ldg(reinterpret_cast<const float2*>(brl + 8 * j + 2 * q));
          const int e = 4 * (j - C / 8) + 2 * h;
          sacc[e] += out[4 * j + 2 * h] + bias.x;
          sacc[e + 1] += out[4 * j + 2 * h + 1] + bias.y;
        }
      consumers_sync();  // every read of x, the taps and this layer's ring is done

      // ---- this thread's rows: the ring keeps the layer's last d inputs,
      // the residual updates x in place (bf16 each layer), skip in fp32.
      // Fragment j holds output columns 8j + 2q + {0, 1} of rows r0 (h = 0)
      // and r0 + 8 (h = 1); j < C/8 is the residual half.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const bool to_ring = r >= TT - d;
        const int ring_row = off + (s + r) % d;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const uint32_t xa = swz(xs, r, j) + 4 * q;
          const uint32_t xv = xr[j][h];
          if (to_ring) sts32(swz(rs, ring_row, j) + 4 * q, xv);
          if (l + 1 < L) {  // the last layer's residual output is not needed
            const float2 bias = __ldg(reinterpret_cast<const float2*>(brl + 8 * j + 2 * q));
            __nv_bfloat162 xb;
            *reinterpret_cast<uint32_t*>(&xb) = xv;
            const float2 xo = __bfloat1622float2(xb);
            xr[j][h] = pack(xo.x + round_bf16(out[4 * j + 2 * h] + bias.x),
                            xo.y + round_bf16(out[4 * j + 2 * h + 1] + bias.y));
            sts32(xa, xr[j][h]);
          }
        }
      }
      consumers_sync();  // x holds the next layer's input, the ring its last d
      PHASE(4);
    }

    // ---- emit the skip sum for the rows of this block's own segment
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = s + r0 + 8 * h;
      if (t >= t0 && t < t1) {
#pragma unroll
        for (int j = 0; j < S / 8; ++j)
          *reinterpret_cast<uint32_t*>(sb + (size_t)t * S + 8 * j + 2 * q) =
              pack(sacc[4 * j + 2 * h], sacc[4 * j + 2 * h + 1]);
      }
    }
    PHASE(5);
#ifdef PWN_FLOW_STACK_PHASES
    if (phase_on) atomicAdd(&fs_phase_cycles[6], 1ull);
#endif
  }
}

}  // namespace

extern "C" {

#ifdef PWN_FLOW_STACK_PHASES
// Copies the phase cycles since the last call into out[7] and clears them.
int pwn_flow_stack_phases(unsigned long long* out) {
  const unsigned long long zero[7] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, fs_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(fs_phase_cycles, zero, sizeof(zero));
  return err;
}
#endif

// Rows per time tile; the caller rounds its segment length to a multiple.
int pwn_flow_stack_tile_rows() { return TT; }

// Dynamic shared memory of one block for a stack with sum(dilations) =
// ring_rows: the alignment slack, the weight ring, the x and cond tiles, the
// rings and the barriers.
long long pwn_flow_stack_smem_bytes(int ring_rows) {
  return ALIGN + RING_OFF + static_cast<long long>(ring_rows) * ROW_BYTES + 16 * STAGES;
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
  CUtensorMap tm_win, tm_wout;
  if (!make_map(&tm_win, w_in_t, false, 2, K_IN, static_cast<uint64_t>(L) * G, 1, G) ||
      !make_map(&tm_wout, w_out_t, false, 2, GH, static_cast<uint64_t>(L) * N_OUT, 1, N_OUT))
    return cudaErrorInvalidValue;
  const long long smem = pwn_flow_stack_smem_bytes(ring_rows);
  cudaError_t err = cudaFuncSetAttribute(
      flow_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + seg - 1) / seg, B);
  flow_stack_kernel<<<grid, NTHREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      tm_win, tm_wout, static_cast<const bf16*>(x0), static_cast<const bf16*>(cond),
      static_cast<const float*>(b_g), static_cast<const float*>(b_rs),
      static_cast<bf16*>(skip), T, L, seg, ring_rows, dl);
  return cudaGetLastError();
}

}  // extern "C"
