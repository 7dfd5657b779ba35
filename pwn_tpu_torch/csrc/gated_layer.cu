// One WaveNet gated residual layer for Hopper (sm_90a), with two epilogues:
// "layer" (the layer's residual and skip outputs) and "accumulate" (one layer
// of the whole-stack forward, skip summed in fp32 across launches).
//
// Replaces: pwn_tpu/ops/pallas/gated_layer.py::_kernel (reached through
// _fused_forward / fused_gated_residual), and, through the accumulate
// epilogue run once per layer, pwn_tpu/ops/pallas/flow_stack.py::_kernel at
// the widths the whole-stack kernel (flow_stack.cu) is not built for.  For
// every batch row b and time t, with dilation d:
//     g    = [x(t) | x(t - d) | cond(t)] @ W_in + b_g     fp32 accumulate
//     z    = bf16(tanh(g[:G/2]) * sigmoid(g[G/2:]))
//     out  = z @ W_out + b_out                            fp32 accumulate
//     res  = bf16(x + bf16(out[:C]))
// with x(t - d) = 0 for t < d.  Then
//   layer:       skip = bf16(out[C:])      (the Pallas per-layer kernel)
//   accumulate:  skip_acc = out[C:] (first layer) or skip_acc + out[C:] in
//                fp32; the last layer writes bf16(skip_acc + out[C:]) and no
//                res (the Pallas whole-stack kernel's rounding).
// The biases arrive in fp32: unrounded for "layer", as `_fused_forward` passes
// them; rounded to bf16 for "accumulate", as the stacked layout holds them.
//
// What bounds it on this card, per sample at C=128, G=256, S=128, M=80:
// 2*(336*256 + 128*256) = 237,568 FLOP (91.0 GFLOP at batch 8 x 47,872:
// 0.092 ms at 989 TFLOP/s) against, at 3.35 TB/s, 928 bytes for "layer" (x
// and cond read, res and skip written: 0.106 ms), 1,696 for a middle
// "accumulate" layer (skip_acc read and written in fp32: 0.194 ms) and 1,184
// for its first and last.  At C=64 (S=64, G=128): 69,632 FLOP against 544,
// 928 and 672 bytes.  Bytes bound every case, with the operations close
// behind at C=128: so no intermediate (g, z, out) leaves the chip, x and cond
// are read once, and both products run on the tensor cores.
//
// Design:
// * Persistent blocks, one per SM, walk the 128-row time tiles of all batch
//   rows (374 per row at T = 47,872).  Each block has two consumer
//   warpgroups of 64 rows each and one producer warpgroup whose single thread
//   starts every load.  setmaxnreg lowers the producer to 40 registers and
//   raises the consumers to 232; ptxas fits the whole kernel in the launch
//   bound's 168, 128 of them a consumer's 64 x 256 fp32 accumulator.
// * TMA brings the activations: one tensor map over x (B, T, C) and one over
//   cond (B, T, M), 64-column boxes of 128 rows with the 128-byte swizzle that
//   wgmma reads.  The tap is the x box at time t0 - d: TMA fills zeros for
//   t < 0 and t >= T, so no row is masked on load and no row crosses a batch
//   row.  cond's 80 columns are two boxes, the second zero past column 80.
//   The activations have a barrier pair of their own: the consumers hand them
//   back once the gate product is done and each thread holds its x(t) for the
//   residual, so the next tile's activations load during this tile's out
//   product and epilogue.
// * The weights stream through a ring of three mbarrier-guarded stages, one
//   64-column k-slice of W_in (G rows) or W_out (C+S rows) per stage: at
//   C=128 that is 6 slices of the gate product's 336 columns (the last one 16
//   wide) and 2 of the out product's 128, 32 KB each.  They arrive stored
//   (out, in), which is the K-major B operand wgmma reads from shared memory.
//   In the accumulate epilogue the ring also brings each warpgroup's 64 rows
//   of the fp32 skip sum (unless first), two more slots per tile.
// * wgmma m64nNk16 (bf16 in, fp32 sum) with A and B from shared memory.  The
//   gate product is one m64n(G) accumulator per warpgroup whose tanh half
//   [0, G/2) and sigmoid half [G/2, G) share one fragment layout, so z is
//   formed elementwise in registers (`gate`: the hardware's exp2 and
//   reciprocal), rounded to bf16 and stored in its own swizzled tile as the A
//   operand of the out product, m64n(C+S).
// * The epilogue stores from the accumulator's fragments.  Measured on the
//   H100, the gates and the epilogue's stores take most of a tile's time, not
//   the products or the loads: the two warpgroups' CUDA-core work is what a
//   later design has to spread or overlap.
// * Shared memory at C=128: x, tap and cond tiles 96 KB, z 32 KB, weight ring
//   96 KB.
// * Built at two widths: (C, G, S, M) = (64, 128, 64, 80) (student_iaf) and
//   (128, 256, 128, 80) (large_student_sharded, teacher_lj).  A third
//   instantiation, the JAX package's wide teacher (256, 512, 256, 80),
//   has its own kernel (`gated_layer_split_kernel`, `SplitDims`): 64-row
//   tiles whose columns the two consumer warpgroups split.  Per sample
//   there: 2*(592*512 + 256*512) = 868,352 FLOP (113.8 GFLOP at 8 x
//   16,384: 0.115 ms at 989 TFLOP/s) against 1,696 bytes for "layer" and
//   3,232 for a middle "accumulate" layer (0.066 and 0.126 ms): products
//   and bytes bound it about equally, and both products run on wgmma at
//   N = 256.

#include <type_traits>

#include "hopper.cuh"  // TMA, mbarrier and wgmma wrappers, the gates: shared with kernel 1

namespace {

constexpr int TM = 128;        // rows per tile
constexpr int WG_ROWS = 64;    // rows per consumer warpgroup
constexpr int NCONS = TM / WG_ROWS;
constexpr int NTHREADS = 128 * (NCONS + 1);  // + the producer warpgroup
constexpr int TILE_BYTES = TM * ROW_BYTES;   // one 64-column slice of 128 rows
static_assert(TM == 128, "swz128 addresses 128-row tiles");
constexpr int SMEM_MAX = 232448;            // a block's opt-in shared memory

template <int C_, int G_, int S_, int M_>
struct Dims {
  static constexpr int C = C_, G = G_, S = S_, M = M_;
  static constexpr int GH = G / 2;        // tanh half, sigmoid half
  static constexpr int K_IN = 2 * C + M;  // gate depth [x | tap | cond]
  static constexpr int N_OUT = C + S;     // out width [residual | skip]
  static constexpr int XCH = C / KC;      // slices of x, of the tap and of z
  static constexpr int CCH = (M + KC - 1) / KC;
  static constexpr int NCH_IN = 2 * XCH + CCH;  // k-slices of the gate product
  static constexpr int NCH_OUT = GH / KC;       // k-slices of the out product
  static constexpr int NCH = NCH_IN + NCH_OUT;
  static constexpr int STAGE_BYTES = (G > N_OUT ? G : N_OUT) * ROW_BYTES;
  static constexpr uint32_t A_BYTES = (2 * XCH + CCH) * TILE_BYTES;
  // one consumer warpgroup's rows of the fp32 skip sum: one ring stage
  static constexpr uint32_t ACC_BYTES = WG_ROWS * S * 4;
  // shared memory: the x, tap and cond tiles (the activations, one tile at a
  // time), z, the weight ring (three stages where they fit, else two), and
  // the barriers
  static constexpr int X_OFF = 0;
  static constexpr int T_OFF = X_OFF + XCH * TILE_BYTES;
  static constexpr int C_OFF = T_OFF + XCH * TILE_BYTES;
  static constexpr int Z_OFF = C_OFF + CCH * TILE_BYTES;
  static constexpr int W_OFF = Z_OFF + XCH * TILE_BYTES;
  static constexpr int STAGES = W_OFF + 3 * STAGE_BYTES + 8 * 8 + 1024 <= SMEM_MAX ? 3 : 2;
  static constexpr int BAR_OFF = W_OFF + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;  // + alignment
  static_assert(C % KC == 0 && GH % KC == 0 && M % 16 == 0, "slice widths");
  static_assert(GH == C, "z has the tap's slices");
  static_assert(G <= 256 && N_OUT <= 256 && S <= 256,
                "one wgmma and one TMA box span a width");
  static_assert(ACC_BYTES <= STAGE_BYTES, "skip_acc rows fit a ring stage");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  // k-steps of 16 in gate slice i: the last cond slice is M % 64 wide
  __host__ __device__ static constexpr int steps(int i) {
    return i < 2 * XCH ? KC / 16
                       : ((M - (i - 2 * XCH) * KC) >= KC ? KC : M - (i - 2 * XCH) * KC) / 16;
  }
};

using Narrow = Dims<64, 128, 64, 80>;
using Wide = Dims<128, 256, 128, 80>;

// The wide teacher's widths, (C, G, S, M) = (256, 512, 256, 80): no wgmma
// (N <= 256) and no consumer's registers span the 512 gate or output
// columns, and 128-row tiles of x, tap, cond and z would fill a block's
// shared memory.  So a tile has 64 rows, which both consumer warpgroups
// share, and the columns are split: warpgroup w owns tanh columns [WC w,
// WC w + WC) and their sigmoid partners (one m64n256 gate accumulator), z's
// columns [WC w, ...), and of the output the residual and skip columns
// [WC w, WC w + WC) (one m64n256 out accumulator over the whole z, which
// both warpgroups write and a named barrier publishes).  A ring stage holds
// one warpgroup's 2 WC rows of a 64-column k-slice of W_in or W_out (two
// 128-row TMA boxes, stacked as the K-major B operand), or its WC columns
// of the fp32 skip sum's 64 rows; the stages alternate between the two
// warpgroups.  With three stages a stage's consecutive uses belong to
// different warpgroups, so each stage has a full barrier per warpgroup:
// a warpgroup waits only on its own uses' phases, and never on a phase of
// the other's that has not completed yet.
template <int C_, int G_, int S_, int M_>
struct SplitDims {
  static constexpr int C = C_, G = G_, S = S_, M = M_;
  static constexpr int GH = G / 2;
  static constexpr int K_IN = 2 * C + M;
  static constexpr int N_OUT = C + S;
  static constexpr int TM = 64;                 // rows per tile, both warpgroups
  static constexpr int WC = GH / 2;             // a warpgroup's columns: 128
  static constexpr int SLICE = TM * ROW_BYTES;  // one 64-column slice of a tile: 8 KB
  static constexpr int XCH = C / KC;
  static constexpr int CCH = (M + KC - 1) / KC;
  static constexpr int NCH_IN = 2 * XCH + CCH;
  static constexpr int NCH_OUT = GH / KC;
  static constexpr int NCH = NCH_IN + NCH_OUT;
  static constexpr int STAGE_BYTES = 2 * WC * ROW_BYTES;  // 32 KB
  static constexpr uint32_t A_BYTES = NCH_IN * SLICE;
  static constexpr uint32_t ACC_BYTES = TM * WC * 4;      // a warpgroup's skip_acc
  static constexpr int STAGES = 3;
  static constexpr int X_OFF = 0;
  static constexpr int T_OFF = X_OFF + XCH * SLICE;
  static constexpr int C_OFF = T_OFF + XCH * SLICE;
  static constexpr int Z_OFF = C_OFF + CCH * SLICE;
  static constexpr int W_OFF = Z_OFF + NCH_OUT * SLICE;
  static constexpr int BAR_OFF = W_OFF + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 3 * STAGES) + 1024;  // + alignment
  static_assert(GH == C && S == C && 2 * WC == C && WC % KC == 0 && M % 16 == 0,
                "the column split: z, residual and skip halves of WC columns");
  static_assert(2 * WC <= 256 && WC <= 256, "one wgmma and one TMA box span a half");
  static_assert(ACC_BYTES <= STAGE_BYTES, "skip_acc columns fit a ring stage");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  __host__ __device__ static constexpr int steps(int i) {
    return i < 2 * XCH ? KC / 16
                       : ((M - (i - 2 * XCH) * KC) >= KC ? KC : M - (i - 2 * XCH) * KC) / 16;
  }
};

using WideTeacher = SplitDims<256, 512, 256, 80>;

// With PWN_GATED_LAYER_PHASES defined (tools/torch_gated_layer_phases.py
// builds it so), thread 0 of block 0 adds the clock cycles of each phase of
// each tile into gl_phase_cycles: waiting for the activations, the gate
// product, the gates and z, the out product, the epilogue; [5] counts tiles.
#ifdef PWN_GATED_LAYER_PHASES
__device__ unsigned long long gl_phase_cycles[6];
#define PHASE(k)                                                \
  do {                                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
      const unsigned long long now = clock64();                 \
      gl_phase_cycles[k] += now - phase_t;                      \
      phase_t = now;                                            \
    }                                                           \
  } while (0)
#else
#define PHASE(k)
#endif

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_n<128>(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_n<256>(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_m64n256(d, da, db);
}

// One layer over all tiles.  A persistent block walks the 128-row time
// tiles tile = blockIdx.x + k * gridDim.x (n_tt tiles per batch row, the
// batch row major).  NTHREADS threads: warpgroups 0 and 1 compute rows
// [64 wg, 64 wg + 64) of a tile, warpgroup 2 loads.
//   tm_x    x (B, T, C) bf16, 64 x 128 boxes     tm_cond  cond (B, T, M)
//   tm_win  W_in (G, K_IN), 64 x G boxes          tm_wout  W_out (N_OUT, GH)
//   tm_acc  skip_acc (B, T, S) fp32, S x 64 boxes, unswizzled (ACC and not
//           first only)
//   b_g (G), b_out (N_OUT) fp32
//   ACC = false: res (B, T, C), skip (B, T, S) bf16
//   ACC = true:  res (unless last), skip_acc (written unless last), skip
//                (B, T, S) bf16 (last only)
// Ring order per tile: NCH_IN slices of W_in, NCH_OUT of W_out, then (ACC
// and not first) the skip_acc rows of warpgroup 0 and of warpgroup 1.  The
// activations have their own barrier pair: the consumers release them once
// the gate product is done and each thread holds its x values for the
// residual, so the next tile's activations load during this tile's out
// product and epilogue.
template <class D, bool ACC>
__global__ void __launch_bounds__(NTHREADS, 1)
gated_layer_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_cond,
                   const __grid_constant__ CUtensorMap tm_win,
                   const __grid_constant__ CUtensorMap tm_wout,
                   const __grid_constant__ CUtensorMap tm_acc,
                   const float* __restrict__ b_g, const float* __restrict__ b_out,
                   bf16* __restrict__ res, bf16* __restrict__ skip,
                   float* __restrict__ skip_acc, int T, int n_tt, int n_tiles, int d,
                   int first, int last) {
  constexpr int STAGES = D::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t xs = base + D::X_OFF, ts = base + D::T_OFF, cs = base + D::C_OFF;
  const uint32_t zs = base + D::Z_OFF, ws = base + D::W_OFF;
  const uint32_t a_full = base + D::BAR_OFF, a_empty = a_full + 8;
  const uint32_t full = a_empty + 8, empty = full + 8 * STAGES;
  const int n_acc = ACC && !first ? NCONS : 0;  // skip_acc ring slots per tile
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, NCONS * 4);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NCONS) {
    // producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NCONS * 128) {
      int c = 0;  // ring slot count
      for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
        const int b = tile / n_tt, t0 = (tile % n_tt) * TM;
        mbar_wait(a_empty, (it & 1) ^ 1);
        mbar_expect_tx(a_full, D::A_BYTES);
        for (int k = 0; k < D::XCH; ++k) {
          tma_load_3d(xs + k * TILE_BYTES, &tm_x, k * KC, t0, b, a_full);
          tma_load_3d(ts + k * TILE_BYTES, &tm_x, k * KC, t0 - d, b, a_full);
        }
        for (int k = 0; k < D::CCH; ++k)
          tma_load_3d(cs + k * TILE_BYTES, &tm_cond, k * KC, t0, b, a_full);
        for (int i = 0; i < D::NCH + n_acc; ++i, ++c) {
          const int s = c % STAGES;
          const uint32_t dst = ws + s * D::STAGE_BYTES, bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((c / STAGES) & 1) ^ 1);
          if (i < D::NCH_IN) {
            mbar_expect_tx(bar, D::G * ROW_BYTES);
            tma_load_2d(dst, &tm_win, i * KC, 0, bar);
          } else if (i < D::NCH) {
            mbar_expect_tx(bar, D::N_OUT * ROW_BYTES);
            tma_load_2d(dst, &tm_wout, (i - D::NCH_IN) * KC, 0, bar);
          } else {
            mbar_expect_tx(bar, D::ACC_BYTES);
            tma_load_3d(dst, &tm_acc, 0, t0 + (i - D::NCH) * WG_ROWS, b, bar);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const uint32_t wg_rows = wg * WG_ROWS * ROW_BYTES;  // this warpgroup's A rows
    // fragment rows of this thread within the tile's 128: r0 and r0 + 8
    const int r0 = wg * WG_ROWS + warp * 16 + lane / 4;
    const int q2 = 2 * (lane % 4);
    int c = 0;  // ring slot count, as the producer's
#ifdef PWN_GATED_LAYER_PHASES
    unsigned long long phase_t = clock64();
#endif
    for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
      const int b = tile / n_tt, t0 = (tile % n_tt) * TM;
      mbar_wait(a_full, it & 1);
      PHASE(0);

      // gate product over the k-slices [x | tap | cond]
      float acc[D::G / 2];
#pragma unroll
      for (int i = 0; i < D::G / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < D::NCH_IN; ++i, ++c) {
        const int s = c % STAGES;
        const uint32_t a = (i < D::XCH ? xs + i * TILE_BYTES
                            : i < 2 * D::XCH ? ts + (i - D::XCH) * TILE_BYTES
                                             : cs + (i - 2 * D::XCH) * TILE_BYTES) + wg_rows;
        mbar_wait(full + 8 * s, (c / STAGES) & 1);
        const uint64_t da = desc_sw128(a), db = desc_sw128(ws + s * D::STAGE_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D::steps(i); ++k) wgmma_n<D::G>(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }

      PHASE(1);
      // z = tanh(g[:GH]) * sigmoid(g[GH:]): fragment j (columns 8j + [0, 8))
      // of the tanh half sits in acc[4j..4j+3], its sigmoid partner in
      // acc[4(j + GH/8)..]
#pragma unroll
      for (int j = 0; j < D::GH / 8; ++j) {
        const int col = 8 * j + q2;
        const float2 bt = __ldg(reinterpret_cast<const float2*>(b_g + col));
        const float2 bs = __ldg(reinterpret_cast<const float2*>(b_g + D::GH + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h, f = 4 * (j + D::GH / 8) + 2 * h;
          *reinterpret_cast<uint32_t*>(smem + D::Z_OFF + swz128(r0 + 8 * h, col)) =
              pack(gate(acc[e] + bt.x, acc[f] + bs.x),
                   gate(acc[e + 1] + bt.y, acc[f + 1] + bs.y));
        }
      }
      // this thread's x(t) for the residual, then the activations go back to
      // the producer for the next tile
      uint32_t xr[D::C / 8][2];
#pragma unroll
      for (int j = 0; j < D::C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xr[j][h] = *reinterpret_cast<const uint32_t*>(smem + D::X_OFF +
                                                        swz128(r0 + 8 * h, 8 * j + q2));
      __syncwarp();
      if (lane == 0) mbar_arrive(a_empty);
      // make z visible to wgmma (the async proxy), then to the whole warpgroup
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

      PHASE(2);
      // out product over z's k-slices
      float out[D::N_OUT / 2];
#pragma unroll
      for (int i = 0; i < D::N_OUT / 2; ++i) out[i] = 0.f;
#pragma unroll
      for (int o = 0; o < D::NCH_OUT; ++o, ++c) {
        const int s = c % STAGES;
        mbar_wait(full + 8 * s, (c / STAGES) & 1);
        const uint64_t da = desc_sw128(zs + o * TILE_BYTES + wg_rows);
        const uint64_t db = desc_sw128(ws + s * D::STAGE_BYTES);
        fence_regs(out);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KC / 16; ++k) wgmma_n<D::N_OUT>(out, da + 2 * k, db + 2 * k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(out);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }

      PHASE(3);
      // the skip_acc rows: every consumer warp waits for both slots (so that
      // its releases count in the right phase) and reads its own
      for (int k = 0; k < n_acc; ++k) {
        const int s = (c + k) % STAGES;
        mbar_wait(full + 8 * s, ((c + k) / STAGES) & 1);
      }
      const float* acc_s =
          reinterpret_cast<const float*>(smem + D::W_OFF + ((c + wg) % STAGES) * D::STAGE_BYTES);

      // epilogue: fragment j holds output columns 8j + q2 + {0, 1} of rows r0
      // (h = 0) and r0 + 8 (h = 1); j < C/8 is the residual half
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, t = t0 + r;
        if (t >= T) continue;
        const size_t row = static_cast<size_t>(b) * T + t;
#pragma unroll
        for (int j = 0; j < D::N_OUT / 8; ++j) {
          const int col = 8 * j + q2;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(b_out + col));
          const float o0 = out[4 * j + 2 * h] + bias.x;
          const float o1 = out[4 * j + 2 * h + 1] + bias.y;
          if (j < D::C / 8) {
            if (ACC && last) continue;
            __nv_bfloat162 xv;
            *reinterpret_cast<uint32_t*>(&xv) = xr[j][h];
            const float2 xo = __bfloat1622float2(xv);
            *reinterpret_cast<uint32_t*>(res + row * D::C + col) =
                pack(xo.x + round_bf16(o0), xo.y + round_bf16(o1));
          } else if (!ACC) {
            *reinterpret_cast<uint32_t*>(skip + row * D::S + col - D::C) = pack(o0, o1);
          } else {
            float2 v = make_float2(o0, o1);
            if (!first) {
              const float2 prev = *reinterpret_cast<const float2*>(
                  acc_s + (r - wg * WG_ROWS) * D::S + col - D::C);
              v = make_float2(prev.x + o0, prev.y + o1);
            }
            if (last)
              *reinterpret_cast<uint32_t*>(skip + row * D::S + col - D::C) = pack(v.x, v.y);
            else
              *reinterpret_cast<float2*>(skip_acc + row * D::S + col - D::C) = v;
          }
        }
      }
      for (int k = 0; k < n_acc; ++k) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((c + k) % STAGES));
      }
      c += n_acc;
      PHASE(4);
#ifdef PWN_GATED_LAYER_PHASES
      if (blockIdx.x == 0 && threadIdx.x == 0) ++gl_phase_cycles[5];
#endif
    }
  }
}

// One layer over all tiles at the split widths (SplitDims): the persistent
// walk, the arguments and the ring order of gated_layer_kernel, with
// 64-row tiles (n_tt per batch row) and one ring slot per warpgroup where
// that kernel has one per slice: for each k-slice of W_in, then of W_out,
// warpgroup 0's rows and then warpgroup 1's, then (ACC and not first)
// warpgroup 0's and 1's columns of the skip sum.
template <class D, bool ACC>
__global__ void __launch_bounds__(NTHREADS, 1)
gated_layer_split_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_cond,
                         const __grid_constant__ CUtensorMap tm_win,
                         const __grid_constant__ CUtensorMap tm_wout,
                         const __grid_constant__ CUtensorMap tm_acc,
                         const float* __restrict__ b_g, const float* __restrict__ b_out,
                         bf16* __restrict__ res, bf16* __restrict__ skip,
                         float* __restrict__ skip_acc, int T, int n_tt, int n_tiles, int d,
                         int first, int last) {
  constexpr int STAGES = D::STAGES, WC = D::WC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t xs = base + D::X_OFF, ts = base + D::T_OFF, cs = base + D::C_OFF;
  const uint32_t zs = base + D::Z_OFF, ws = base + D::W_OFF;
  // full: one barrier per (stage, warpgroup), at full + 8 (NCONS s + w)
  const uint32_t a_full = base + D::BAR_OFF, a_empty = a_full + 8;
  const uint32_t full = a_empty + 8, empty = full + 8 * NCONS * STAGES;
  const int n_acc = ACC && !first ? 1 : 0;  // skip_acc slots per tile and warpgroup
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, NCONS * 4);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      for (int w = 0; w < NCONS; ++w) mbar_init(full + 8 * (NCONS * s + w), 1);
      mbar_init(empty + 8 * s, 4);  // the warps of the slot's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NCONS * 128) {
      int c = 0;  // ring slot count
      for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
        const int b = tile / n_tt, t0 = (tile % n_tt) * D::TM;
        mbar_wait(a_empty, (it & 1) ^ 1);
        mbar_expect_tx(a_full, D::A_BYTES);
        for (int k = 0; k < D::XCH; ++k) {
          tma_load_3d(xs + k * D::SLICE, &tm_x, k * KC, t0, b, a_full);
          tma_load_3d(ts + k * D::SLICE, &tm_x, k * KC, t0 - d, b, a_full);
        }
        for (int k = 0; k < D::CCH; ++k)
          tma_load_3d(cs + k * D::SLICE, &tm_cond, k * KC, t0, b, a_full);
        for (int i = 0; i < D::NCH + n_acc; ++i) {
          for (int w = 0; w < NCONS; ++w, ++c) {
            const int s = c % STAGES;
            const uint32_t dst = ws + s * D::STAGE_BYTES, bar = full + 8 * (NCONS * s + w);
            mbar_wait(empty + 8 * s, ((c / STAGES) & 1) ^ 1);
            if (i < D::NCH_IN) {  // W_in's tanh rows, then their sigmoid partners
              mbar_expect_tx(bar, D::STAGE_BYTES);
              tma_load_2d(dst, &tm_win, i * KC, WC * w, bar);
              tma_load_2d(dst + WC * ROW_BYTES, &tm_win, i * KC, D::GH + WC * w, bar);
            } else if (i < D::NCH) {  // W_out's residual rows, then skip rows
              mbar_expect_tx(bar, D::STAGE_BYTES);
              tma_load_2d(dst, &tm_wout, (i - D::NCH_IN) * KC, WC * w, bar);
              tma_load_2d(dst + WC * ROW_BYTES, &tm_wout, (i - D::NCH_IN) * KC, D::C + WC * w,
                          bar);
            } else {
              mbar_expect_tx(bar, D::ACC_BYTES);
              tma_load_3d(dst, &tm_acc, WC * w, t0, b, bar);
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;  // fragment rows r0 and r0 + 8
    const int q2 = 2 * (lane % 4);
    const int cw = WC * wg;               // this warpgroup's first column
    // ring slot count, as the producer's; this warpgroup's is c + wg, in
    // stage (c + wg) % STAGES, whose full barrier of this warpgroup it
    // finds in phase (c / NCONS) / STAGES
    int c = 0;
    auto wait_own = [&](int s) {
      mbar_wait(full + 8 * (NCONS * s + wg), ((c / NCONS) / STAGES) & 1);
    };
    for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
      const int b = tile / n_tt, t0 = (tile % n_tt) * D::TM;
      mbar_wait(a_full, it & 1);

      // gate product: tanh columns [cw, cw + WC) in acc[0, WC/2), their
      // sigmoid partners in acc[WC/2, WC)
      float acc[WC];
#pragma unroll
      for (int i = 0; i < WC; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < D::NCH_IN; ++i, c += NCONS) {
        const int s = (c + wg) % STAGES;
        const uint32_t a = i < D::XCH ? xs + i * D::SLICE
                           : i < 2 * D::XCH ? ts + (i - D::XCH) * D::SLICE
                                            : cs + (i - 2 * D::XCH) * D::SLICE;
        wait_own(s);
        const uint64_t da = desc_sw128(a), db = desc_sw128(ws + s * D::STAGE_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D::steps(i); ++k) wgmma_m64n256(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }

      // both warpgroups' out products of the previous tile have read z
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      // z = tanh(g) * sigmoid(g'): fragment j of this warpgroup's tanh
      // columns in acc[4j..4j+3], its sigmoid partner in acc[4(j + WC/8)..]
#pragma unroll
      for (int j = 0; j < WC / 8; ++j) {
        const int col = cw + 8 * j + q2;
        const float2 bt = __ldg(reinterpret_cast<const float2*>(b_g + col));
        const float2 bs = __ldg(reinterpret_cast<const float2*>(b_g + D::GH + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h, f = 4 * (j + WC / 8) + 2 * h;
          *reinterpret_cast<uint32_t*>(smem + D::Z_OFF + swz64(r0 + 8 * h, col)) =
              pack(gate(acc[e] + bt.x, acc[f] + bs.x),
                   gate(acc[e + 1] + bt.y, acc[f + 1] + bs.y));
        }
      }
      // this thread's x(t) for its residual columns, then the activations go
      // back to the producer
      uint32_t xr[WC / 8][2];
#pragma unroll
      for (int j = 0; j < WC / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xr[j][h] = *reinterpret_cast<const uint32_t*>(smem + D::X_OFF +
                                                        swz64(r0 + 8 * h, cw + 8 * j + q2));
      __syncwarp();
      if (lane == 0) mbar_arrive(a_empty);
      // z to the async proxy, then to both warpgroups
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 2, 256;\n" ::: "memory");

      // out product over all of z: residual columns [cw, cw + WC) in
      // out[0, WC/2), skip columns [cw, cw + WC) in out[WC/2, WC)
      float out[WC];
#pragma unroll
      for (int i = 0; i < WC; ++i) out[i] = 0.f;
#pragma unroll
      for (int o = 0; o < D::NCH_OUT; ++o, c += NCONS) {
        const int s = (c + wg) % STAGES;
        wait_own(s);
        const uint64_t da = desc_sw128(zs + o * D::SLICE);
        const uint64_t db = desc_sw128(ws + s * D::STAGE_BYTES);
        fence_regs(out);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KC / 16; ++k) wgmma_m64n256(out, da + 2 * k, db + 2 * k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(out);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }

      // this warpgroup's columns of the skip sum's rows
      const int sa = (c + wg) % STAGES;
      if (n_acc) wait_own(sa);
      const float* acc_s =
          reinterpret_cast<const float*>(smem + D::W_OFF + sa * D::STAGE_BYTES);

      // epilogue: fragment j < WC/8 holds residual columns cw + 8j + q2 +
      // {0, 1}, fragment j >= WC/8 skip columns cw + 8(j - WC/8) + q2 + {0, 1},
      // of rows r0 (h = 0) and r0 + 8 (h = 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, t = t0 + r;
        if (t >= T) continue;
        const size_t row = static_cast<size_t>(b) * T + t;
#pragma unroll
        for (int j = 0; j < 2 * (WC / 8); ++j) {
          const int jc = 8 * (j % (WC / 8)) + q2;  // within this warpgroup's columns
          const int col = j < WC / 8 ? cw + jc : D::C + cw + jc;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(b_out + col));
          const float o0 = out[4 * j + 2 * h] + bias.x;
          const float o1 = out[4 * j + 2 * h + 1] + bias.y;
          if (j < WC / 8) {
            if (ACC && last) continue;
            __nv_bfloat162 xv;
            *reinterpret_cast<uint32_t*>(&xv) = xr[j][h];
            const float2 xo = __bfloat1622float2(xv);
            *reinterpret_cast<uint32_t*>(res + row * D::C + col) =
                pack(xo.x + round_bf16(o0), xo.y + round_bf16(o1));
          } else if (!ACC) {
            *reinterpret_cast<uint32_t*>(skip + row * D::S + col - D::C) = pack(o0, o1);
          } else {
            float2 v = make_float2(o0, o1);
            if (!first) {
              const float2 prev = *reinterpret_cast<const float2*>(acc_s + r * WC + jc);
              v = make_float2(prev.x + o0, prev.y + o1);
            }
            if (last)
              *reinterpret_cast<uint32_t*>(skip + row * D::S + col - D::C) = pack(v.x, v.y);
            else
              *reinterpret_cast<float2*>(skip_acc + row * D::S + col - D::C) = v;
          }
        }
      }
      if (n_acc) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * sa);
      }
      c += NCONS * n_acc;
    }
  }
}

template <class D, bool ACC>
int launch(const void* x, const void* cond, const void* w_in, const void* b_g,
           const void* w_out, const void* b_out, void* res, void* skip, void* skip_acc,
           int B, int T, int d, int first, int last, cudaStream_t st) {
  // the split widths: 64-row tiles, 128-row weight boxes (two a ring
  // slot), a warpgroup's 128 columns of skip_acc a box
  constexpr bool SPLIT = std::is_same<D, WideTeacher>::value;
  constexpr int TR = SPLIT ? WideTeacher::TM : TM;
  constexpr int WIN_ROWS = SPLIT ? WideTeacher::WC : D::G;
  constexpr int WOUT_ROWS = SPLIT ? WideTeacher::WC : D::N_OUT;
  constexpr int ACC_ROWS = SPLIT ? WideTeacher::TM : WG_ROWS;
  constexpr uint32_t ACC_COLS = SPLIT ? WideTeacher::WC : 0;
  CUtensorMap tm_x, tm_cond, tm_win, tm_wout, tm_acc = {};
  if (!make_map(&tm_x, x, false, 3, D::C, T, B, TR) ||
      !make_map(&tm_cond, cond, false, 3, D::M, T, B, TR) ||
      !make_map(&tm_win, w_in, false, 2, D::K_IN, D::G, 1, WIN_ROWS) ||
      !make_map(&tm_wout, w_out, false, 2, D::GH, D::N_OUT, 1, WOUT_ROWS) ||
      (ACC && !first &&
       !make_map(&tm_acc, skip_acc, true, 3, D::S, T, B, ACC_ROWS, ACC_COLS)))
    return cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (SPLIT)
      return gated_layer_split_kernel<D, ACC>;
    else
      return gated_layer_kernel<D, ACC>;
  }();
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
  if (err != cudaSuccess) return err;
  const int n_tt = (T + TR - 1) / TR, n_tiles = B * n_tt;
  const int grid = n_tiles < n_sm ? n_tiles : n_sm;
  kernel<<<grid, NTHREADS, D::SMEM, st>>>(
      tm_x, tm_cond, tm_win, tm_wout, tm_acc, static_cast<const float*>(b_g),
      static_cast<const float*>(b_out), static_cast<bf16*>(res), static_cast<bf16*>(skip),
      static_cast<float*>(skip_acc), T, n_tt, n_tiles, d, first, last);
  return cudaGetLastError();
}

template <class D>
bool is(int c, int g, int s, int m) {
  return c == D::C && g == D::G && s == D::S && m == D::M;
}

template <bool ACC>
int dispatch(const void* x, const void* cond, const void* w_in, const void* b_g,
             const void* w_out, const void* b_out, void* res, void* skip, void* skip_acc,
             int B, int T, int c, int g, int s, int m, int d, int first, int last,
             void* stream) {
  if (B < 1 || B > 65535 || T < 1 || d < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is<Narrow>(c, g, s, m))
    return launch<Narrow, ACC>(x, cond, w_in, b_g, w_out, b_out, res, skip, skip_acc, B, T,
                               d, first, last, st);
  if (is<Wide>(c, g, s, m))
    return launch<Wide, ACC>(x, cond, w_in, b_g, w_out, b_out, res, skip, skip_acc, B, T, d,
                             first, last, st);
  if (is<WideTeacher>(c, g, s, m))
    return launch<WideTeacher, ACC>(x, cond, w_in, b_g, w_out, b_out, res, skip, skip_acc, B,
                                    T, d, first, last, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

#ifdef PWN_GATED_LAYER_PHASES
// Copies the phase cycles since the last call into out[6] and clears them.
int pwn_gated_layer_phases(unsigned long long* out) {
  const unsigned long long zero[6] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, gl_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gl_phase_cycles, zero, sizeof(zero));
  return err;
}
#endif

// Kernel 5, "layer" epilogue: one gated residual layer on `stream`, res and
// skip out.  Returns a cudaError_t (0 on success); cudaErrorInvalidValue for
// widths it is not built for.
int pwn_gated_layer_bf16(const void* x, const void* cond, const void* w_in,
                         const void* b_g, const void* w_out, const void* b_out,
                         void* res, void* skip, int B, int T, int c, int g, int s,
                         int m, int dilation, void* stream) {
  return dispatch<false>(x, cond, w_in, b_g, w_out, b_out, res, skip, nullptr, B, T, c, g, s,
                         m, dilation, 0, 0, stream);
}

// Kernel 5, "accumulate" epilogue: layer `first` / `last` of a stack.  The
// fp32 skip_acc is written (first), read and written (middle) or read (last,
// unless also first); res is written unless last; skip only by the last.
int pwn_gated_layer_acc_bf16(const void* x, const void* cond, const void* w_in,
                             const void* b_g, const void* w_out, const void* b_rs,
                             void* res, void* skip_acc, void* skip, int B, int T, int c,
                             int g, int s, int m, int dilation, int first, int last,
                             void* stream) {
  return dispatch<true>(x, cond, w_in, b_g, w_out, b_rs, res, skip, skip_acc, B, T, c, g, s,
                        m, dilation, first, last, stream);
}

}  // extern "C"
