// Whole-stack WaveNet training backward for Hopper (sm_90a), with its
// weight gradients.  (The forward that saves every layer's input runs
// kernel 5's accumulate epilogue once per layer: csrc/gated_layer.cu,
// through ops/gated_layer.py::flow_stack_train_by_layers.)
//
// Replaces:
//   kernel 3  pwn_tpu/ops/pallas/flow_stack.py::_bwd_chunk_kernel
//             (via _flow_stack_train_bwd_impl), both want_wgrads modes.
//
// The forward, per layer l with dilation d, for every time t:
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
//     dW_in[l] = dg^T cat, db_g[l] = sum dg, dW_out[l] = dout^T z,
//     db_rs[l] = sum dout                                         fp32
// The rounding points are the Pallas kernels' (dout, dg and z to bf16; the
// gates, dz and every sum in fp32).  Two of its roundings come from the TPU's
// tile and chunk layout and are not kept: the tap cotangent crossing a tile
// and dx crossing a layer chunk stay fp32 here.
//
// What bounds it on this card.  At teacher_lj widths (C=128, G=256, S=128,
// M=80) a row costs per layer 2 x 336 x 256 (gates recomputed) + 2 x 256 x
// 128 (dz) + 2 x 256 x 336 (dcat) FLOP, and with weight gradients 2 x 256 x
// (336 + 128) more: 2.06 ms at B=8, T=16,384 over 24 layers at 989
// TFLOP/s.  Against that it moves per row and layer ~3 KB (dx-only: fp32
// dpart and dcs written and read back, dcond read and written; acts, cond
// and dskip read) and with weight gradients ~1 KB more (bf16 dg, dout, z
// stored and read by the GEMM): a byte bound of 3-4 ms, so bytes bound it.
// At student_iaf widths (C=64, G=128, S=64, M=80) a row costs a quarter of
// the products (192,512 FLOP a layer with weight gradients: 0.255 ms over
// 10 layers at B=8, T=16,384) against about half the bytes (the fp32
// dcond chain keeps its 80 columns), so the memory phases take a larger
// share than at the teacher's widths.
//
// At the wide teacher's widths (C=256, G=512, S=256, M=80) a row costs
// four times the teacher's products (7.46 ms over 24 layers at B=8,
// T=16,384 with weight gradients, 4.69 dx-only) against about twice its
// bytes, so the products bound it: the split body below (`SplitDims`)
// keeps them on wgmma.
//
// Two instantiations, `Teacher` and `Student` below: one body, its slice
// and ring-slot counts derived from the widths in `Dims`.  At the student's
// widths x, tap and z are one 64-column slice each, dout and dg two; the
// gates are one 128-column pass (64 tanh columns, their 64 sigmoid
// partners), so the "gate halves" loop runs once; dz, dcx and dcs have
// N = 64 and take m64n64 products over ring slots of 128 K rows (two 64-row
// boxes stacked) where the teacher's N = 128 products take slots of 64 K
// rows (two 64-column boxes side by side).  The gate accumulator (64 x 128)
// and dz (64 x 64) fit a consumer's registers together, so at these widths
// nothing forces "dz first": the order is kept only so that one body
// serves both.
//
// Design, and what it does about the TPU kernels' assumptions:
// * Grid order.  The TPU grid runs its time tiles in order and carries the
//   tap cotangent of the earlier tile in VMEM scratch.  CUDA blocks run in
//   no order, so there is no carry: every layer is one launch, and the tap
//   cotangent dx_l(t) needs dcs(t + d) from rows of a later tile.  Each
//   layer's launch writes dpart = dx + dcx and dcs to device memory; the
//   next (lower) layer's launch reads dpart(t) + dcs(t + d) as its dx.  dcs
//   alternates between two buffers, since a block reads other blocks' rows
//   of it.  A last pass folds layer 0's dcs into dx.
// * Weights on chip.  The TPU kernel keeps a chunk of layers' weights in
//   VMEM; one layer's W_in and W_out (236 KB) do not fit a block's shared
//   memory beside its tiles.  The layer pass (`train_bwd_layer`) is kernel
//   5's structure: persistent blocks over 128-row tiles, one producer
//   thread streaming the weights by TMA through a ring of four 16 KB slots
//   (28 a tile at the teacher's widths, 9 at the student's), two consumer
//   warpgroups of 64 rows running every product on wgmma.  The epilogues'
//   read-modify-writes (dpart, dcond32) issue their loads before the
//   product whose result they take.  W_in and W_out arrive as stored,
//   (out, in): the gate product reads W_in K-major, dz = dout @ W_out^T
//   and dcat = dg @ W_in read W_out and W_in MN-major (their rows are the
//   product's K), so there are no transposed copies.
// * Registers.  At the teacher's widths the gate accumulator (64 x 256
//   fp32) beside dz (64 x 128) would not fit a consumer's registers: dz
//   comes first, then the gate product runs in two halves of 128 columns
//   (64 tanh, their 64 sigmoid partners), and dg is formed in registers
//   per half (the exp2 / reciprocal forms of tanh and sigmoid below) and
//   stored in bf16 over the dout tile, whose product is done.
// * Weight gradients.  The TPU kernel keeps fp32 accumulators resident
//   across the whole grid.  Here each layer's pass stores dg and dout (TMA
//   from their swizzled tiles) and z (bf16, as the reference rounds them),
//   and a split-K GEMM on wgmma (`wgrad_gemm`) forms dg^T cat and dout^T z
//   over row ranges into fp32 partials, which `wgrad_reduce` sums in a
//   fixed order: the result is the same on every run, with no atomics
//   (dcond32 too has one writer per row).  Both of the GEMM's operands are
//   row-major with the rows (time) as its K, so TMA brings 64-column boxes
//   of them in the 128-byte swizzle and wgmma reads both as MN-major
//   operands: no transpose in registers or shared memory.  The tap columns
//   are the acts box at t0 - d of a (B, T, C) tensor map, zero-filled for
//   t < 0, so a range of rows never crosses a batch row.  The bias
//   gradients are column sums of the dg and dout tiles already in shared
//   memory, taken by one more product with an all-ones B operand.

#include <type_traits>

#include "hopper.cuh"  // TMA, mbarrier and wgmma wrappers: shared with kernels 1, 4, 5

namespace {

constexpr int L_SLOT = 16384;            // one weight-ring slot: two 64 x 64 boxes

// The widths and, derived from them, the 64-column slices of the layer
// pass's tiles and its ring slots (teacher | student):
template <int C_, int G_, int S_, int M_>
struct Dims {
  static constexpr int C = C_, G = G_, S = S_, M = M_;
  static constexpr int GH = G / 2;        // tanh half, sigmoid half
  static constexpr int K_IN = 2 * C + M;  // gate depth [x | tap | cond]
  static constexpr int N_OUT = C + S;     // out width [residual | skip]
  static constexpr int XS = C / KC;       // x, tap (and z): 2 | 1 slices
  static constexpr int CS = 2;            // cond: 64 columns, then M - 64
  static constexpr int AS = 2 * XS + CS;  // [x | tap | cond]: 6 | 4
  static constexpr int OS = N_OUT / KC;   // dout, then dg over it: 4 | 2
  static constexpr int SS = S / KC;       // dskip, after dx's XS: 2 | 1
  static constexpr int NH = GH / KC;      // gate passes of 64 tanh + 64 sigmoid rows
  // The products with N = C (= GH): dz over W_out's N_OUT rows, dcx and
  // dcs over W_in's G rows, B MN-major.  A slot holds KR rows of their K
  // (64 | 128), as two 64-column boxes side by side (C = 128) or two
  // 64-row boxes stacked (C = 64).
  static constexpr int KR = L_SLOT / (2 * C);
  static_assert((C == KC || C == 2 * KC) && GH == C && G == N_OUT && S % KC == 0 &&
                    M > KC && M <= 2 * KC && M % 16 == 0 && AS % 2 == 0,
                "the slices of the layer pass and the weight-gradient tiles");
};

using Teacher = Dims<128, 256, 128, 80>;
using Student = Dims<64, 128, 64, 80>;

// The wide teacher's widths, (C, G, S, M) = (256, 512, 256, 80), where no
// consumer's registers hold a row's dz, gates or dcat, and 128-row tiles
// of [x | tap | cond] and dout would fill a block's shared memory: the
// layer pass (`train_bwd_layer_split`) takes 64-row tiles that both
// consumer warpgroups share, and splits the columns.  Warpgroup w owns
// dz's columns [WC w, WC w + WC) (and so those z and tanh columns and
// their sigmoid partners, NH gate passes of 64 + 64), dcx's and dcs's
// [WC w, ...) and dcc's [MC w, MC w + MC).  The ring's 16 KB slots
// alternate between the warpgroups.  The weight-gradient GEMM splits G
// into row blocks of 256 (`Wg::RB`).
template <int C_, int G_, int S_, int M_>
struct SplitDims {
  static constexpr int C = C_, G = G_, S = S_, M = M_;
  static constexpr int GH = G / 2;
  static constexpr int K_IN = 2 * C + M;
  static constexpr int N_OUT = C + S;
  static constexpr int XS = C / KC;       // 4
  static constexpr int CS = 2;
  static constexpr int AS = 2 * XS + CS;  // 10
  static constexpr int OS = N_OUT / KC;   // 8
  static constexpr int SS = S / KC;       // 4
  static constexpr int TM = 64;           // rows per tile, both warpgroups
  static constexpr int WC = C / 2;        // a warpgroup's dz, dcx and dcs columns: 128
  static constexpr int MC = M / 2;        // a warpgroup's dcc columns: 40
  static constexpr int NH = WC / KC;      // a warpgroup's gate passes: 2
  static constexpr int KR = L_SLOT / (2 * WC);  // K rows of an N = WC slot: 64
  static constexpr int SLICE = TM * ROW_BYTES;  // one 64-column slice of a tile: 8 KB
  // shared memory: [x | tap | cond], dout then dg, the ring, the barriers
  static constexpr int A_ = 0;
  static constexpr int D_ = A_ + AS * SLICE;
  static constexpr int W = D_ + OS * SLICE;
  static constexpr int BAR = W + 4 * L_SLOT;
  static constexpr int SMEM = BAR + 8 * (2 + 2 + 2 * 4) + 1024;  // + alignment
  static_assert(GH == C && G == N_OUT && S == C && C % (2 * KC) == 0 && KR == KC &&
                    M > KC && M <= 2 * KC && M % 16 == 0 && MC % 8 == 0 && AS % 2 == 0,
                "the column split of the layer pass and the weight-gradient tiles");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

using WideTeacher = SplitDims<256, 512, 256, 80>;

// ----------------------------------------------------- kernel 3: layer pass
// One layer of the backward over all 128-row tiles.  A persistent block
// walks tiles tile = blockIdx.x + k gridDim.x (n_tt per batch row, the
// batch row major).  Warpgroups 0 and 1 (threads [0, 256)) compute rows
// [64 wg, 64 wg + 64) of a tile; warpgroup 2's first thread loads.
// setmaxnreg gives the producer 40 registers and the consumers 232; ptxas
// still fits the kernel in the launch bound's 168 with a few hundred bytes
// of spills (on the H100 a 9-warp block without setmaxnreg ran slower).
//   tm_x    acts[l] (B, T, C), 64 x 128 boxes      tm_cond  cond (B, T, M)
//   tm_dskip dskip (B, T, S), 64 x 64 boxes
//   tm_win   W_in (G, K_IN), 64 x 64 boxes
//   tm_wout W_out (N_OUT, GH), 64 x 64 boxes
//   tm_dout, tm_dg  dout_g (B, T, N_OUT), dg_g (B, T, G), 64 x 64 boxes
//                   (stores; with weight gradients only)
//   b_g (G) fp32; dpart, dcs_prev, dcs_cur (B, T, C), dcond32 (B, T, M) fp32
//   z_g (B, T, GH) bf16 or null
// Per tile, each warpgroup:
//   1. dx = dpart(t) + dcs_prev(t + d_prev) (0 at the top), rounded to bf16
//      into the dout tile's first C columns; dskip arrives by TMA in the
//      others.  With weight gradients, the dout tile goes to dout_g by TMA.
//   2. dz = dout @ W_out^T (m64n128, B MN-major: W_out's rows are the K).
//   3. Per half h of the gate columns, g = [x | tap | cond] @ W_in^T over
//      W_in's tanh rows [64h, 64h + 64) and sigmoid rows [GH + 64h, ...)
//      (m64n128, both K-major); then ta, sb and dg (and z, stored to z_g)
//      in registers, dg in bf16 into the dout tile's place.
//   4. dcat = dg @ W_in (B MN-major: W_in's rows are the K) as dcx, dcs
//      (m64n128 each) and dcc (m64n80), each with its epilogue: dpart = dx
//      + dcx in place, dcs_cur = dcs, dcond32 (+)= dcc; the loads of the
//      read-modify-writes are issued before the product.  With weight
//      gradients, the dg tile goes to dg_g by TMA.
// Ring order per tile, slots of 16 KB (teacher 28 | student 9): dz N_OUT
// / KR (4 | 1), the gate passes NH x AS (the k-slices [x | tap | cond]:
// 2 x 6 | 1 x 4), dcx and dcs G / KR each (4 | 1), dcc G / 64 (64 rows of
// W_in each: 4 | 2).
constexpr int LT = 128;                  // rows per tile
constexpr int LWG = 64;                  // rows per consumer warpgroup
constexpr int L_THREADS = 384;           // two consumer warpgroups + a producer
constexpr int L_TILE = LT * ROW_BYTES;   // one 64-column slice of a tile: 16 KB
static_assert(LT == 128, "swz128 addresses 128-row tiles");
constexpr int L_STAGES = 4;
constexpr int L_A = 0;                   // x (XS slices), tap (XS), cond (2)
// Shared memory of the layer pass: teacher 230,512 B, student 164,976 B,
// against the 232,448 a block may opt in to.
template <class D>
struct Lay {
  static constexpr int D_ = L_A + D::AS * L_TILE;  // dout, then dg: OS slices
  static constexpr int W = D_ + D::OS * L_TILE;    // the weight ring
  static constexpr int BAR = W + L_STAGES * L_SLOT;
  static constexpr int SMEM = BAR + 8 * (2 + 4 + 2 * L_STAGES) + 1024;  // + alignment
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// With PWN_FLOW_STACK_TRAIN_PHASES defined (tools/torch_flow_stack_train_phases.py
// builds it so), thread 0 of block 0 adds the clock cycles of each phase of
// each tile into fst_phase_cycles: dx in and the dskip wait, the dz product,
// the activations wait, the gate products, the gates and dg, the dcx and dcs
// products and their epilogues, the dcc product and its epilogue; [7] counts
// tiles.  The same tool's builds with PWN_FST_NO_GATES (the gates as plain
// products), PWN_FST_NO_DX (no dx loads) or PWN_FST_NO_EPILOGUE (no dpart,
// dcs, dcond and z stores) time the kernel without that work; their
// results are wrong.
#ifdef PWN_FLOW_STACK_TRAIN_PHASES
__device__ unsigned long long fst_phase_cycles[8];
#define PHASE(k)                                                \
  do {                                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
      const unsigned long long now = clock64();                 \
      fst_phase_cycles[k] += now - phase_t;                     \
      phase_t = now;                                            \
    }                                                           \
  } while (0)
#else
#define PHASE(k)
#endif

// tanh and sigmoid apart (the derivatives need both), from one hardware
// exp2 and one reciprocal each, exponents clamped to +-30 nats.  Against
// fp64 over every fp32 |x| <= 64 (tools/torch_train_gate_error.py, H100):
// absolute error at most 2.3e-7 for tanh and 1.2e-7 for sigmoid (libm's
// tanhf 1.1e-7, 1 / (1 + expf(-x)) 9e-8), and 4.5e-7 for 1 - tanh^2, 1.2e-7
// for s (1 - s).  The relative error of tanh is unbounded near 0, where
// e^2x - 1 cancels: the gates are summed, so only the absolute error counts.
__device__ __forceinline__ float tanh_fast(float a) {
  constexpr float LOG2E = 1.44269504f, CLAMP = 43.28f;  // 30 nats in log2
#ifdef PWN_FST_NO_GATES
  return a;
#else
  const float ea = ex2_approx(fminf(fmaxf(2.f * LOG2E * a, -CLAMP), CLAMP));
  return (ea - 1.f) * rcp_approx(ea + 1.f);
#endif
}
__device__ __forceinline__ float sigmoid_fast(float b) {
  constexpr float LOG2E = 1.44269504f, CLAMP = 43.28f;
#ifdef PWN_FST_NO_GATES
  return b;
#else
  return rcp_approx(1.f + ex2_approx(fminf(fmaxf(-LOG2E * b, -CLAMP), CLAMP)));
#endif
}

// Wait for ring slot c, run `body` (the products on it), commit, wait and
// release the slot.
template <class F>
__device__ __forceinline__ void on_slot(int& c, uint32_t full, uint32_t empty, int lane,
                                        F body) {
  const int s = c % L_STAGES;
  mbar_wait(full + 8 * s, (c / L_STAGES) & 1);
  wgmma_fence();
  body(s);
  wgmma_commit();
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(empty + 8 * s);
  ++c;
}

template <class D>
__global__ void __launch_bounds__(L_THREADS, 1)
train_bwd_layer(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_cond,
                const __grid_constant__ CUtensorMap tm_dskip,
                const __grid_constant__ CUtensorMap tm_win,
                const __grid_constant__ CUtensorMap tm_wout,
                const __grid_constant__ CUtensorMap tm_dout,
                const __grid_constant__ CUtensorMap tm_dg, const float* __restrict__ b_g,
                float* __restrict__ dpart, const float* __restrict__ dcs_prev,
                float* __restrict__ dcs_cur, float* __restrict__ dcond32,
                bf16* __restrict__ z_g, int T, int n_tt, int n_tiles, int d, int d_prev,
                int top, int wgrads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  using Y = Lay<D>;
  constexpr int KR = D::KR;
  const uint32_t base = smem_u32(smem);
  const uint32_t a_full = base + Y::BAR, a_empty = a_full + 8;
  const uint32_t d_full = a_empty + 8, d_empty = d_full + 16;  // one each per warpgroup
  const uint32_t full = d_empty + 16, empty = full + 8 * L_STAGES;
  const uint32_t ring = base + Y::W;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, 8);  // one arrival per consumer warp
    for (int w = 0; w < 2; ++w) {
      mbar_init(d_full + 8 * w, 1);
      mbar_init(d_empty + 8 * w, 1);
    }
    for (int s = 0; s < L_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    // the producer: activations, dskip rows and the weight ring
    int c = 0;
    // one ring slot: the 64 x 64 boxes of a weight at (col, row) and at
    // (col + dcol, row + drow)
    auto slot = [&](const CUtensorMap* map, int col, int row, int dcol, int drow) {
      const int s = c % L_STAGES;
      const uint32_t dst = ring + s * L_SLOT, bar = full + 8 * s;
      mbar_wait(empty + 8 * s, ((c / L_STAGES) & 1) ^ 1);
      mbar_expect_tx(bar, L_SLOT);
      tma_load_2d(dst, map, col, row, bar);
      tma_load_2d(dst + L_SLOT / 2, map, col + dcol, row + drow, bar);
      ++c;
    };
    // slot i of a product with N = C and B MN-major: KR rows of the
    // weight from row KR i, columns [col, col + C)
    auto slot_mn = [&](const CUtensorMap* map, int col, int i) {
      if (D::C == 2 * KC)
        slot(map, col, KR * i, KC, 0);
      else
        slot(map, col, KR * i, 0, KC);
    };
    auto load_a = [&](int tile, int it) {
      const int b = tile / n_tt, t0 = (tile % n_tt) * LT;
      mbar_wait(a_empty, (it & 1) ^ 1);
      mbar_expect_tx(a_full, D::AS * L_TILE);
      for (int k = 0; k < D::XS; ++k) {
        tma_load_3d(base + L_A + k * L_TILE, &tm_x, k * KC, t0, b, a_full);
        tma_load_3d(base + L_A + (D::XS + k) * L_TILE, &tm_x, k * KC, t0 - d, b, a_full);
      }
      for (int k = 0; k < D::CS; ++k)
        tma_load_3d(base + L_A + (2 * D::XS + k) * L_TILE, &tm_cond, k * KC, t0, b, a_full);
    };
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      const int b = tile / n_tt, t0 = (tile % n_tt) * LT;
      if (it == 0) load_a(tile, 0);
      for (int w = 0; w < 2; ++w) {
        mbar_wait(d_empty + 8 * w, (it & 1) ^ 1);
        mbar_expect_tx(d_full + 8 * w, D::SS * LWG * ROW_BYTES);
        for (int k = 0; k < D::SS; ++k)
          tma_load_3d(base + Y::D_ + (D::XS + k) * L_TILE + w * LWG * ROW_BYTES, &tm_dskip,
                      k * KC, t0 + w * LWG, b, d_full + 8 * w);
      }
      for (int i = 0; i < D::N_OUT / KR; ++i) slot_mn(&tm_wout, 0, i);  // dz
      for (int h = 0; h < D::NH; ++h)  // the gate passes: tanh rows, sigmoid rows
        for (int i = 0; i < D::AS; ++i) slot(&tm_win, KC * i, KC * h, 0, D::GH);
      if (tile + (int)gridDim.x < n_tiles) load_a(tile + gridDim.x, it + 1);
      for (int h = 0; h < 2; ++h)  // dcx, dcs
        for (int i = 0; i < D::G / KR; ++i) slot_mn(&tm_win, h * D::C, i);
      for (int i = 0; i < D::G / KC; ++i) slot(&tm_win, 2 * D::C, KC * i, KC, 0);  // dcc
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const uint32_t wrow = wg * LWG * ROW_BYTES;  // this warpgroup's rows in a slice
  const int r0 = wg * LWG + warp * 16 + lane / 4;  // fragment rows r0, r0 + 8
  const int q2 = 2 * (lane % 4);
  const uint32_t bar_id = 1 + wg;
  int c = 0;
  // acc += the dout or dg tile (its first K columns) @ B, a product with
  // N = C whose B (W_out or W_in rows [0, K) at some column) arrives in
  // the ring as K / KR MN-major slots of KR rows
  auto mn_product = [&](auto& acc, int K) {
#pragma unroll
    for (int i = 0; i < K / KR; ++i) {
      fence_regs(acc);
      on_slot(c, full, empty, lane, [&](int s) {
        const uint64_t db = desc_mn_sw128(ring + s * L_SLOT, L_SLOT / 2);
#pragma unroll
        for (int k = 0; k < KR / 16; ++k) {
          const int kk = i * (KR / 16) + k;  // the k-step over the tile's columns
          const uint64_t da = desc_sw128(base + Y::D_ + (kk / 4) * L_TILE + wrow) + 2 * (kk % 4);
          wgmma_mn<0, 1>(acc, da, db + 128 * k);
        }
      });
      fence_regs(acc);
    }
  };
#ifdef PWN_FLOW_STACK_TRAIN_PHASES
  unsigned long long phase_t = clock64();
#endif
  for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int b = tile / n_tt, t0 = (tile % n_tt) * LT;
    const size_t rb = (size_t)b * T;

    // 1. dx = dpart(t) + dcs_prev(t + d_prev): in bf16 into the dout tile's
    //    columns [0, C), and in fp32 back into dpart for the epilogue.  Each
    //    thread moves 16 float4 of a 64-row half tile, its loads issued 8 at
    //    a time before any is used (they wait on device memory).
    constexpr int DX_PER = LWG * (D::C / 4) / 128, DX_BATCH = 8;
#pragma unroll
    for (int k0 = 0; k0 < DX_PER; k0 += DX_BATCH) {
      float4 v[DX_BATCH], u[DX_BATCH];
#pragma unroll
      for (int k = 0; k < DX_BATCH; ++k) {
        const int i = tid + 128 * (k0 + k);
        const int t = t0 + wg * LWG + i / (D::C / 4), col = (i % (D::C / 4)) * 4;
        v[k] = u[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#ifndef PWN_FST_NO_DX
        if (!top && t < T) {
          v[k] = *reinterpret_cast<const float4*>(dpart + (rb + t) * D::C + col);
          if (t + d_prev < T)
            u[k] = __ldg(reinterpret_cast<const float4*>(dcs_prev + (rb + t + d_prev) * D::C + col));
        }
#endif
      }
#pragma unroll
      for (int k = 0; k < DX_BATCH; ++k) {
        const int i = tid + 128 * (k0 + k);
        const int r = wg * LWG + i / (D::C / 4), col = (i % (D::C / 4)) * 4;
        const int t = t0 + r;
        if (!top && t < T && t + d_prev < T) {
          v[k].x += u[k].x; v[k].y += u[k].y; v[k].z += u[k].z; v[k].w += u[k].w;
        }
#ifndef PWN_FST_NO_DX
        if (!top && t < T) *reinterpret_cast<float4*>(dpart + (rb + t) * D::C + col) = v[k];
#endif
        *reinterpret_cast<uint2*>(smem + Y::D_ + swz128(r, col)) =
            make_uint2(pack(v[k].x, v[k].y), pack(v[k].z, v[k].w));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    mbar_wait(d_full + 8 * wg, it & 1);
    if (wgrads && tid == 0) {
      for (int k = 0; k < D::OS; ++k)
        tma_store_3d(&tm_dout, base + Y::D_ + k * L_TILE + wrow, k * KC, t0 + wg * LWG, b);
      bulk_commit();
    }
    PHASE(0);

    // 2. dz = dout @ W_out^T
    float dz[D::GH / 2];
#pragma unroll
    for (int i = 0; i < D::GH / 2; ++i) dz[i] = 0.f;
    mn_product(dz, D::N_OUT);
    if (wgrads && tid == 0) bulk_wait_read<0>();  // dout_g has read the tile
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    PHASE(1);
    mbar_wait(a_full, it & 1);
    PHASE(2);

    // 3. the gates per pass of 64 tanh columns and their partners, dg into
    //    the dout tile's place
#pragma unroll
    for (int h = 0; h < D::NH; ++h) {
      float g[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) g[i] = 0.f;
#pragma unroll
      for (int i = 0; i < D::AS; ++i) {
        fence_regs(g);
        on_slot(c, full, empty, lane, [&](int s) {
          const uint64_t da = desc_sw128(base + L_A + i * L_TILE + wrow);
          const uint64_t db = desc_sw128(ring + s * L_SLOT);
          const int steps = (i < D::AS - 1 ? KC : D::M - KC) / 16;  // cond's 2nd: M - 64
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < steps) wgmma_m64n128<0, 0>(g, da + 2 * k, db + 2 * k);
        });
        fence_regs(g);
      }
      PHASE(3);
      // fragment j < 8: tanh column 64h + 8j + q2 (+1); j + 8 its sigmoid
      // partner; dz's fragment 8h + j the same column
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * h + 8 * j + q2;
        const float2 bt = __ldg(reinterpret_cast<const float2*>(b_g + col));
        const float2 bs = __ldg(reinterpret_cast<const float2*>(b_g + D::GH + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float da[2], db[2], z[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ta = tanh_fast(g[4 * j + 2 * hh + e] + (e ? bt.y : bt.x));
            const float sb = sigmoid_fast(g[4 * (j + 8) + 2 * hh + e] + (e ? bs.y : bs.x));
            const float dzv = dz[4 * (8 * h + j) + 2 * hh + e];
            da[e] = dzv * sb * (1.f - ta * ta);
            db[e] = dzv * ta * sb * (1.f - sb);
            z[e] = ta * sb;
          }
          const int r = r0 + 8 * hh;
          *reinterpret_cast<uint32_t*>(smem + Y::D_ + swz128(r, col)) = pack(da[0], da[1]);
          *reinterpret_cast<uint32_t*>(smem + Y::D_ + swz128(r, D::GH + col)) =
              pack(db[0], db[1]);
#ifndef PWN_FST_NO_EPILOGUE
          if (z_g != nullptr && t0 + r < T)
            *reinterpret_cast<uint32_t*>(z_g + (rb + t0 + r) * D::GH + col) = pack(z[0], z[1]);
#endif
        }
      }
      PHASE(4);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(a_empty);  // the activations go back to the producer
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (wgrads && tid == 0) {
      for (int k = 0; k < D::OS; ++k)
        tma_store_3d(&tm_dg, base + Y::D_ + k * L_TILE + wrow, k * KC, t0 + wg * LWG, b);
      bulk_commit();
    }

    // 4a. dcx = dg @ W_in[:, :C] and its epilogue dpart = dx + dcx (dx in
    //     dpart since step 1), then dcs = dg @ W_in[:, C:2C] into dcs_cur.
    //     The dpart loads are issued before the product, which hides them.
    {
      float2 dx[2][D::C / 8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + r0 + 8 * hh;
#pragma unroll
        for (int j = 0; j < D::C / 8; ++j)
          dx[hh][j] = top || t >= T ? make_float2(0.f, 0.f)
                                    : *reinterpret_cast<const float2*>(
                                          dpart + (rb + t) * D::C + 8 * j + q2);
      }
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        float acc[D::C / 2];
#pragma unroll
        for (int i = 0; i < D::C / 2; ++i) acc[i] = 0.f;
        mn_product(acc, D::G);
#ifndef PWN_FST_NO_EPILOGUE
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t0 + r0 + 8 * hh;
          if (t >= T) continue;
          const size_t row = rb + t;
#pragma unroll
          for (int j = 0; j < D::C / 8; ++j) {
            const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
            if (part == 0)
              *reinterpret_cast<float2*>(dpart + row * D::C + 8 * j + q2) =
                  make_float2(dx[hh][j].x + v0, dx[hh][j].y + v1);
            else
              *reinterpret_cast<float2*>(dcs_cur + row * D::C + 8 * j + q2) =
                  make_float2(v0, v1);
          }
        }
#endif
      }
    }
    PHASE(5);

    // 4b. dcc = dg @ W_in[:, 2C:], dcond32 += dcc (= at the top); the
    //     dcond32 loads issued before the product
    {
      float2 prev[2][D::M / 8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + r0 + 8 * hh;
#pragma unroll
        for (int j = 0; j < D::M / 8; ++j)
          prev[hh][j] = top || t >= T ? make_float2(0.f, 0.f)
                                      : *reinterpret_cast<const float2*>(
                                            dcond32 + (rb + t) * D::M + 8 * j + q2);
      }
      float acc[40];
#pragma unroll
      for (int i = 0; i < 40; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < D::G / KC; ++i) {
        fence_regs(acc);
        on_slot(c, full, empty, lane, [&](int s) {
          const uint64_t da = desc_sw128(base + Y::D_ + i * L_TILE + wrow);
          const uint64_t db = desc_mn_sw128(ring + s * L_SLOT, L_SLOT / 2);
#pragma unroll
          for (int k = 0; k < 4; ++k) wgmma_m64n80<0, 1>(acc, da + 2 * k, db + 128 * k);
        });
        fence_regs(acc);
      }
#ifndef PWN_FST_NO_EPILOGUE
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + r0 + 8 * hh;
        if (t >= T) continue;
        const size_t row = rb + t;
#pragma unroll
        for (int j = 0; j < D::M / 8; ++j) {
          const float2 v = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
          *reinterpret_cast<float2*>(dcond32 + row * D::M + 8 * j + q2) =
              top ? v : make_float2(prev[hh][j].x + v.x, prev[hh][j].y + v.y);
        }
      }
#endif
    }
    if (wgrads && tid == 0) bulk_wait_read<0>();  // dg_g has read the tile
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
    if (tid == 0) mbar_arrive(d_empty + 8 * wg);
    PHASE(6);
#ifdef PWN_FLOW_STACK_TRAIN_PHASES
    if (blockIdx.x == 0 && threadIdx.x == 0) ++fst_phase_cycles[7];
#endif
  }
  if (wgrads && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One layer of the backward at the split widths (SplitDims): the arguments,
// maps and per-tile steps of train_bwd_layer, over 64-row tiles whose rows
// both consumer warpgroups take, each on its own columns:
//   1. dx (all 256 consumer threads over the tile's C columns) into the
//      dout tile, dskip by TMA; a named barrier (the whole dout tile is
//      every warpgroup's A operand);
//   2. dz's columns [WC w, WC w + WC) = dout @ W_out[:, those]^T;
//      a named barrier: the dout tile is read (by both products and by
//      the dout_g store) and dg may go over it;
//   3. NH passes of the gates of 64 of those columns and their sigmoid
//      partners; dg's columns into the dout tile's place; a named barrier;
//   4. dcx and dcs on columns [WC w, ...), dcc on [MC w, MC w + MC), each
//      over the whole dg, with the epilogues of train_bwd_layer.
// Ring order per tile, each step one 16 KB slot for warpgroup 0 and then
// one for warpgroup 1: dz N_OUT / KR (8), the gate passes NH x AS (2 x 10),
// dcx and dcs G / KR each (8), dcc G / 128 (4: two 64-row boxes of MC
// columns stacked, 128 K rows).
template <class D>
__global__ void __launch_bounds__(L_THREADS, 1)
train_bwd_layer_split(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_cond,
                      const __grid_constant__ CUtensorMap tm_dskip,
                      const __grid_constant__ CUtensorMap tm_win,
                      const __grid_constant__ CUtensorMap tm_wout,
                      const __grid_constant__ CUtensorMap tm_dout,
                      const __grid_constant__ CUtensorMap tm_dg, const float* __restrict__ b_g,
                      float* __restrict__ dpart, const float* __restrict__ dcs_prev,
                      float* __restrict__ dcs_cur, float* __restrict__ dcond32,
                      bf16* __restrict__ z_g, int T, int n_tt, int n_tiles, int d, int d_prev,
                      int top, int wgrads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int KR = D::KR, WC = D::WC, MC = D::MC, TM = D::TM;
  const uint32_t base = smem_u32(smem);
  const uint32_t a_full = base + D::BAR, a_empty = a_full + 8;
  const uint32_t d_full = a_empty + 8, d_empty = d_full + 8;
  const uint32_t full = d_empty + 8, empty = full + 8 * L_STAGES;
  const uint32_t ring = base + D::W;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, 8);  // one arrival per consumer warp
    mbar_init(d_full, 1);
    mbar_init(d_empty, 1);
    for (int s = 0; s < L_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // the warps of the slot's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    int c = 0;
    // one ring slot: the 64 x 64 boxes of a weight at (col, row) and at
    // (col + dcol, row + drow)
    auto slot = [&](const CUtensorMap* map, int col, int row, int dcol, int drow) {
      const int s = c % L_STAGES;
      const uint32_t dst = ring + s * L_SLOT, bar = full + 8 * s;
      mbar_wait(empty + 8 * s, ((c / L_STAGES) & 1) ^ 1);
      mbar_expect_tx(bar, L_SLOT);
      tma_load_2d(dst, map, col, row, bar);
      tma_load_2d(dst + L_SLOT / 2, map, col + dcol, row + drow, bar);
      ++c;
    };
    auto load_a = [&](int tile, int it) {
      const int b = tile / n_tt, t0 = (tile % n_tt) * TM;
      mbar_wait(a_empty, (it & 1) ^ 1);
      mbar_expect_tx(a_full, D::AS * D::SLICE);
      for (int k = 0; k < D::XS; ++k) {
        tma_load_3d(base + D::A_ + k * D::SLICE, &tm_x, k * KC, t0, b, a_full);
        tma_load_3d(base + D::A_ + (D::XS + k) * D::SLICE, &tm_x, k * KC, t0 - d, b, a_full);
      }
      for (int k = 0; k < D::CS; ++k)
        tma_load_3d(base + D::A_ + (2 * D::XS + k) * D::SLICE, &tm_cond, k * KC, t0, b,
                    a_full);
    };
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      const int b = tile / n_tt, t0 = (tile % n_tt) * TM;
      if (it == 0) load_a(tile, 0);
      mbar_wait(d_empty, (it & 1) ^ 1);
      mbar_expect_tx(d_full, D::SS * D::SLICE);
      for (int k = 0; k < D::SS; ++k)
        tma_load_3d(base + D::D_ + (D::XS + k) * D::SLICE, &tm_dskip, k * KC, t0, b, d_full);
      for (int i = 0; i < D::N_OUT / KR; ++i)  // dz: W_out rows [KR i, ...), N = WC
        for (int w = 0; w < 2; ++w) slot(&tm_wout, WC * w, KR * i, KC, 0);
      for (int h = 0; h < D::NH; ++h)  // the gate passes: tanh rows, sigmoid rows
        for (int i = 0; i < D::AS; ++i)
          for (int w = 0; w < 2; ++w) slot(&tm_win, KC * i, WC * w + KC * h, 0, D::GH);
      if (tile + (int)gridDim.x < n_tiles) load_a(tile + gridDim.x, it + 1);
      for (int p = 0; p < 2; ++p)  // dcx, dcs
        for (int i = 0; i < D::G / KR; ++i)
          for (int w = 0; w < 2; ++w) slot(&tm_win, p * D::C + WC * w, KR * i, KC, 0);
      for (int i = 0; i < D::G / (2 * KC); ++i)  // dcc: 128 K rows, MC columns
        for (int w = 0; w < 2; ++w) slot(&tm_win, 2 * D::C + MC * w, 2 * KC * i, 0, KC);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ctid = threadIdx.x;  // of the 256 consumer threads
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // fragment rows r0, r0 + 8
  const int q2 = 2 * (lane % 4);
  const int cw = WC * wg;  // this warpgroup's first dz / dcx / dcs column
  int c = 0;  // ring slot count, as the producer's; this warpgroup's is c + wg
  // wait for this warpgroup's next slot, run `body` on it, release it
  auto own_slot = [&](auto body) {
    const int s = (c + wg) % L_STAGES;
    mbar_wait(full + 8 * s, ((c + wg) / L_STAGES) & 1);
    wgmma_fence();
    body(s);
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    c += 2;
  };
  // acc += the dout or dg tile (its first K columns) @ B, a product with
  // N = WC whose B arrives as K / KR MN-major slots of KR rows
  auto mn_product = [&](float (&acc)[WC / 2], int K) {
#pragma unroll
    for (int i = 0; i < K / KR; ++i) {
      fence_regs(acc);
      own_slot([&](int s) {
        const uint64_t db = desc_mn_sw128(ring + s * L_SLOT, L_SLOT / 2);
#pragma unroll
        for (int k = 0; k < KR / 16; ++k) {
          const int kk = i * (KR / 16) + k;  // the k-step over the tile's columns
          const uint64_t da = desc_sw128(base + D::D_ + (kk / 4) * D::SLICE) + 2 * (kk % 4);
          wgmma_m64n128<0, 1>(acc, da, db + 128 * k);
        }
      });
      fence_regs(acc);
    }
  };
  for (int tile = blockIdx.x, it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int b = tile / n_tt, t0 = (tile % n_tt) * TM;
    const size_t rb = (size_t)b * T;

    // 1. dx = dpart(t) + dcs_prev(t + d_prev) over the tile's C columns, by
    //    all 256 consumer threads: bf16 into the dout tile, fp32 back into
    //    dpart
    constexpr int DX_PER = TM * (D::C / 4) / 256, DX_BATCH = 8;
#pragma unroll
    for (int k0 = 0; k0 < DX_PER; k0 += DX_BATCH) {
      float4 v[DX_BATCH], u[DX_BATCH];
#pragma unroll
      for (int k = 0; k < DX_BATCH; ++k) {
        const int i = ctid + 256 * (k0 + k);
        const int t = t0 + i / (D::C / 4), col = (i % (D::C / 4)) * 4;
        v[k] = u[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!top && t < T) {
          v[k] = *reinterpret_cast<const float4*>(dpart + (rb + t) * D::C + col);
          if (t + d_prev < T)
            u[k] = __ldg(reinterpret_cast<const float4*>(dcs_prev + (rb + t + d_prev) * D::C + col));
        }
      }
#pragma unroll
      for (int k = 0; k < DX_BATCH; ++k) {
        const int i = ctid + 256 * (k0 + k);
        const int r = i / (D::C / 4), col = (i % (D::C / 4)) * 4;
        const int t = t0 + r;
        if (!top && t < T && t + d_prev < T) {
          v[k].x += u[k].x; v[k].y += u[k].y; v[k].z += u[k].z; v[k].w += u[k].w;
        }
        if (!top && t < T) *reinterpret_cast<float4*>(dpart + (rb + t) * D::C + col) = v[k];
        *reinterpret_cast<uint2*>(smem + D::D_ + swz64(r, col)) =
            make_uint2(pack(v[k].x, v[k].y), pack(v[k].z, v[k].w));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    mbar_wait(d_full, it & 1);
    if (wgrads && ctid == 0) {
      for (int k = 0; k < D::OS; ++k)
        tma_store_3d(&tm_dout, base + D::D_ + k * D::SLICE, k * KC, t0, b);
      bulk_commit();
    }

    // 2. this warpgroup's columns of dz = dout @ W_out^T
    float dz[WC / 2];
#pragma unroll
    for (int i = 0; i < WC / 2; ++i) dz[i] = 0.f;
    mn_product(dz, D::N_OUT);
    if (wgrads && ctid == 0) bulk_wait_read<0>();  // dout_g has read the tile
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    mbar_wait(a_full, it & 1);

    // 3. the gates per pass of 64 of this warpgroup's tanh columns and
    //    their partners, dg into the dout tile's place
#pragma unroll
    for (int h = 0; h < D::NH; ++h) {
      float g[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) g[i] = 0.f;
#pragma unroll
      for (int i = 0; i < D::AS; ++i) {
        fence_regs(g);
        own_slot([&](int s) {
          const uint64_t da = desc_sw128(base + D::A_ + i * D::SLICE);
          const uint64_t db = desc_sw128(ring + s * L_SLOT);
          const int steps = (i < D::AS - 1 ? KC : D::M - KC) / 16;  // cond's 2nd: M - 64
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < steps) wgmma_m64n128<0, 0>(g, da + 2 * k, db + 2 * k);
        });
        fence_regs(g);
      }
      // fragment j < 8: tanh column cw + 64h + 8j + q2 (+1); j + 8 its
      // sigmoid partner; dz's fragment 8h + j the same column
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cw + 64 * h + 8 * j + q2;
        const float2 bt = __ldg(reinterpret_cast<const float2*>(b_g + col));
        const float2 bs = __ldg(reinterpret_cast<const float2*>(b_g + D::GH + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float da[2], db[2], z[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ta = tanh_fast(g[4 * j + 2 * hh + e] + (e ? bt.y : bt.x));
            const float sb = sigmoid_fast(g[4 * (j + 8) + 2 * hh + e] + (e ? bs.y : bs.x));
            const float dzv = dz[4 * (8 * h + j) + 2 * hh + e];
            da[e] = dzv * sb * (1.f - ta * ta);
            db[e] = dzv * ta * sb * (1.f - sb);
            z[e] = ta * sb;
          }
          const int r = r0 + 8 * hh;
          *reinterpret_cast<uint32_t*>(smem + D::D_ + swz64(r, col)) = pack(da[0], da[1]);
          *reinterpret_cast<uint32_t*>(smem + D::D_ + swz64(r, D::GH + col)) =
              pack(db[0], db[1]);
          if (z_g != nullptr && t0 + r < T)
            *reinterpret_cast<uint32_t*>(z_g + (rb + t0 + r) * D::GH + col) = pack(z[0], z[1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(a_empty);  // the activations go back to the producer
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wgrads && ctid == 0) {
      for (int k = 0; k < D::OS; ++k)
        tma_store_3d(&tm_dg, base + D::D_ + k * D::SLICE, k * KC, t0, b);
      bulk_commit();
    }

    // 4a. dcx = dg @ W_in[:, cw + (0..WC)] and its epilogue dpart = dx +
    //     dcx, then dcs = dg @ W_in[:, C + cw + (0..WC)] into dcs_cur
    {
      float2 dx[2][WC / 8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + r0 + 8 * hh;
#pragma unroll
        for (int j = 0; j < WC / 8; ++j)
          dx[hh][j] = top || t >= T ? make_float2(0.f, 0.f)
                                    : *reinterpret_cast<const float2*>(
                                          dpart + (rb + t) * D::C + cw + 8 * j + q2);
      }
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        float acc[WC / 2];
#pragma unroll
        for (int i = 0; i < WC / 2; ++i) acc[i] = 0.f;
        mn_product(acc, D::G);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t0 + r0 + 8 * hh;
          if (t >= T) continue;
          const size_t row = rb + t;
#pragma unroll
          for (int j = 0; j < WC / 8; ++j) {
            const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
            const int col = cw + 8 * j + q2;
            if (part == 0)
              *reinterpret_cast<float2*>(dpart + row * D::C + col) =
                  make_float2(dx[hh][j].x + v0, dx[hh][j].y + v1);
            else
              *reinterpret_cast<float2*>(dcs_cur + row * D::C + col) = make_float2(v0, v1);
          }
        }
      }
    }

    // 4b. dcc's columns [MC w, MC w + MC) = dg @ W_in[:, 2C + ...],
    //     dcond32 += dcc (= at the top)
    {
      const int cm = MC * wg;
      float2 prev[2][MC / 8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + r0 + 8 * hh;
#pragma unroll
        for (int j = 0; j < MC / 8; ++j)
          prev[hh][j] = top || t >= T ? make_float2(0.f, 0.f)
                                      : *reinterpret_cast<const float2*>(
                                            dcond32 + (rb + t) * D::M + cm + 8 * j + q2);
      }
      float acc[MC / 2];
#pragma unroll
      for (int i = 0; i < MC / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < D::G / (2 * KC); ++i) {
        fence_regs(acc);
        own_slot([&](int s) {
          const uint64_t db = desc_mn_sw128(ring + s * L_SLOT, L_SLOT / 2);
#pragma unroll
          for (int k = 0; k < 2 * KC / 16; ++k) {
            const int kk = i * (2 * KC / 16) + k;  // the k-step over dg's columns
            const uint64_t da = desc_sw128(base + D::D_ + (kk / 4) * D::SLICE) + 2 * (kk % 4);
            wgmma_m64n40<0, 1>(acc, da, db + 128 * k);
          }
        });
        fence_regs(acc);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + r0 + 8 * hh;
        if (t >= T) continue;
        const size_t row = rb + t;
#pragma unroll
        for (int j = 0; j < MC / 8; ++j) {
          const float2 v = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
          *reinterpret_cast<float2*>(dcond32 + row * D::M + cm + 8 * j + q2) =
              top ? v : make_float2(prev[hh][j].x + v.x, prev[hh][j].y + v.y);
        }
      }
    }
    if (wgrads && ctid == 0) bulk_wait_read<0>();  // dg_g has read the tile
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (ctid == 0) mbar_arrive(d_empty);
  }
  if (wgrads && ctid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------- kernel 3: weight gradients
// part[split] = [dW_in (G, K_IN) | dW_out (N_OUT, GH) | db_g (G) | db_rs
// (N_OUT)], each summed over the rows of this split's stages.
template <class D>
struct Part {
  static constexpr int IN = 0;
  static constexpr int OUT = IN + D::G * D::K_IN;
  static constexpr int BG = OUT + D::N_OUT * D::GH;
  static constexpr int BRS = BG + D::G;
  static constexpr int P = BRS + D::N_OUT;
};

// Blocks (tile, split).  A tile is a row block rb of GR output rows (all G
// of them, except at the wide widths: two of 256) and a column tile ct:
// ct < IN_TILES are the 128-column blocks of dW_in = dg^T [x | x(t - d) |
// cond], two 64-column boxes of B each (box kb of the AS slices [x | tap |
// cond]), with db_g in column tile 0; the OUT_TILES after them are the
// 128-column blocks of dW_out = dout^T z, with db_rs in the first.
// Teacher: tiles x, tap, cond, out; student: [x | tap], cond, out; wide:
// 2 x (x, x, tap, tap, cond, out, out).  Every tile is a GR x 128 output
// (cond's 80 columns, and the student's 64 of z, with zeros or repeats
// past them that are not stored): A (dg's or dout's columns of the row
// block) GR columns, B 128.  A stage is WR rows of one batch row, t0 = (q
// % n_tt) * WR for stage q of b = q / n_tt; TMA fills zeros past T, where
// both operands then contribute nothing.  Warpgroups 0 and 1 own the
// output rows [GR/2 wg, GR/2 wg + GR/2) of the row block as NA m64n128
// accumulators (2 | 1 | 2); warpgroup 2's first thread loads.
constexpr int WR = 64;                  // rows of the reduction per stage
constexpr int WBOX = WR * ROW_BYTES;    // one 64-column box of WR rows: 8 KB
constexpr int W_STAGES = 4;
constexpr int W_THREADS = 384;

template <class D>
struct Wg {
  static constexpr int GR = D::G < 256 ? D::G : 256;  // output rows a block
  static constexpr int RB = D::G / GR;                // row blocks: 1 | 1 | 2
  static constexpr int A_BOXES = GR / KC;             // A: 4 | 2 | 4 boxes
  static constexpr int NA = A_BOXES / 2;              // per warpgroup
  static constexpr int IN_TILES = D::AS / 2;          // 3 | 2 | 5
  static constexpr int OUT_TILES = (D::GH + 127) / 128;  // 1 | 1 | 2
  static constexpr int CT = IN_TILES + OUT_TILES;     // column tiles a row block
  static constexpr int TILES = RB * CT;               // 4 | 3 | 14
  static_assert(D::G % GR == 0 && NA <= 2, "row blocks: at most 2 x 64 accumulator rows");
  static constexpr int STAGE = (A_BOXES + 2) * WBOX;  // A, then B's 2 boxes
  static constexpr int ONES = W_STAGES * STAGE;       // an all-ones 8 x 64 K-major tile
  static constexpr int BAR = ONES + 1024;
  static constexpr int SMEM = BAR + 16 * W_STAGES + 1024;  // + alignment
};

template <class D, bool BIAS>
__device__ __forceinline__ void wgrad_mma(float (&acc)[Wg<D>::NA][64],
                                          float (&bs)[Wg<D>::NA][4], uint32_t stages,
                                          uint32_t ones, uint32_t full, uint32_t empty,
                                          int wg, int n, int lane) {
  using W = Wg<D>;
  const uint64_t d1 = desc_sw128(ones);
  for (int i = 0; i < n; ++i) {
    const int s = i % W_STAGES;
    mbar_wait(full + 8 * s, (i / W_STAGES) & 1);
    const uint32_t a = stages + s * W::STAGE + W::NA * wg * WBOX;
    const uint64_t da = desc_mn_sw128(a, WBOX);
    const uint64_t db = desc_mn_sw128(stages + s * W::STAGE + W::A_BOXES * WBOX, WBOX);
#pragma unroll
    for (int m = 0; m < W::NA; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < WR / 16; ++k) {  // one k-step = 16 rows = 2048 bytes
#pragma unroll
      for (int m = 0; m < W::NA; ++m) {
        wgmma_m64n128<1, 1>(acc[m], da + m * (WBOX >> 4) + 128 * k, db + 128 * k);
        if (BIAS) wgmma_m64n8<1, 0>(bs[m], da + m * (WBOX >> 4) + 128 * k, d1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
    for (int m = 0; m < W::NA; ++m) fence_regs(acc[m]);
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % W_STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < W::NA; ++m) {
    fence_regs(acc[m]);
    fence_regs(bs[m]);
  }
}

// One m64n128 accumulator into a split's partials: fragment j holds columns
// 8j + 2 (lane % 4) + {0, 1} of column tile ct of rows m0 (e = 0) and m0 + 8
// (e = 1); the bias column sum sits in every column of the n8 accumulator.
template <class D>
__device__ __forceinline__ void wgrad_store(const float (&acc)[64], const float (&bs)[4],
                                            float* pp, int ct, bool bias, int m0,
                                            int lane) {
  using P = Part<D>;
  const bool out_tile = ct >= Wg<D>::IN_TILES;
  const int oc = 128 * (ct - Wg<D>::IN_TILES);  // the dW_out tile's first column
  const int q2 = 2 * (lane % 4);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = m0 + 8 * e;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + q2;
      const float2 v = make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
      if (out_tile) {
        if (oc + col < D::GH)
          *reinterpret_cast<float2*>(pp + P::OUT + (size_t)m * D::GH + oc + col) = v;
      } else if (128 * ct + col < D::K_IN) {
        *reinterpret_cast<float2*>(pp + P::IN + (size_t)m * D::K_IN + 128 * ct + col) = v;
      }
    }
    if (bias && lane % 4 == 0) pp[(ct == 0 ? P::BG : P::BRS) + m] = bs[2 * e];
  }
}

template <class D>
__global__ void __launch_bounds__(W_THREADS, 1)
wgrad_gemm(const __grid_constant__ CUtensorMap tm_dg,
           const __grid_constant__ CUtensorMap tm_dout,
           const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_cond,
           const __grid_constant__ CUtensorMap tm_z, float* __restrict__ part, int n_tt,
           int n_stages, int per_split, int d) {
  using P = Part<D>;
  using W = Wg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + W::BAR, empty = full + 8 * W_STAGES;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int rb = W::RB == 1 ? 0 : tile / W::CT, ct = W::RB == 1 ? tile : tile % W::CT;
  const int q0 = split * per_split;
  const int q1 = min(q0 + per_split, n_stages);
  const int n = max(q1 - q0, 0);
  const bool out_tile = ct >= W::IN_TILES;
  const bool bias = ct == 0 || ct == W::IN_TILES;
  const int wg = threadIdx.x / 128;

  for (int i = threadIdx.x; i < 1024 / 4; i += W_THREADS)  // bf16 1.0 pairs
    reinterpret_cast<uint32_t*>(smem + W::ONES)[i] = 0x3F803F80u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the ones, for wgmma
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const CUtensorMap* ma = out_tile ? &tm_dout : &tm_dg;
      // B's two boxes: z's columns of the out tile (the student's second
      // one repeats its first, past GH and not stored), or boxes 2 ct,
      // 2 ct + 1 of [x | tap | cond]
      const CUtensorMap* mb[2];
      int col[2], shift[2];
      for (int k = 0; k < 2; ++k) {
        const int kb = 2 * ct + k;
        mb[k] = out_tile ? &tm_z : kb < 2 * D::XS ? &tm_x : &tm_cond;
        col[k] = out_tile ? min(128 * (ct - W::IN_TILES) + k * KC, D::GH - KC)
                          : KC * (kb < D::XS ? kb : kb < 2 * D::XS ? kb - D::XS : kb - 2 * D::XS);
        shift[k] = !out_tile && kb >= D::XS && kb < 2 * D::XS ? d : 0;
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % W_STAGES, q = q0 + i;
        const int b = q / n_tt, t0 = (q % n_tt) * WR;
        const uint32_t dst = base + s * W::STAGE, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((i / W_STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, W::STAGE);
        for (int k = 0; k < W::A_BOXES; ++k)
          tma_load_3d(dst + k * WBOX, ma, rb * W::GR + k * KC, t0, b, bar);
        for (int k = 0; k < 2; ++k)
          tma_load_3d(dst + (W::A_BOXES + k) * WBOX, mb[k], col[k], t0 - shift[k], b, bar);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float acc[W::NA][64], bs[W::NA][4];
#pragma unroll
  for (int m = 0; m < W::NA; ++m) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[m][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) bs[m][i] = 0.f;
  }
  if (bias)
    wgrad_mma<D, true>(acc, bs, base, base + W::ONES, full, empty, wg, n, lane);
  else
    wgrad_mma<D, false>(acc, bs, base, base + W::ONES, full, empty, wg, n, lane);

  float* pp = part + (size_t)split * P::P;
#pragma unroll
  for (int m = 0; m < W::NA; ++m)
    wgrad_store<D>(acc[m], bs[m], pp, ct, bias,
                   rb * W::GR + 64 * (W::NA * wg + m) + 16 * warp + lane / 4, lane);
}

// Sums the partials in split order into dw_in (G, K_IN), dw_out (N_OUT, GH),
// db_g (G) and db_rs (N_OUT).
template <class D>
__global__ void wgrad_reduce(const float* __restrict__ part, int splits,
                             float* __restrict__ dw_in, float* __restrict__ db_g,
                             float* __restrict__ dw_out, float* __restrict__ db_rs) {
  using P = Part<D>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P::P) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * P::P + i];
  if (i < P::OUT)
    dw_in[i - P::IN] = s;
  else if (i < P::BG)
    dw_out[i - P::OUT] = s;
  else if (i < P::BRS)
    db_g[i - P::BG] = s;
  else
    db_rs[i - P::BRS] = s;
}

// Stages of WR rows and their splits: about one block per SM over the
// TILES tiles.
struct WgradSplits {
  int n_tt, n_stages, per, splits;
};

template <class D>
WgradSplits wgrad_splits(int B, int T, int n_sm) {
  WgradSplits w;
  w.n_tt = (T + WR - 1) / WR;
  w.n_stages = B * w.n_tt;
  int s = n_sm / Wg<D>::TILES;
  s = s < 1 ? 1 : s > w.n_stages ? w.n_stages : s;
  w.per = (w.n_stages + s - 1) / s;
  w.splits = (w.n_stages + w.per - 1) / w.per;
  return w;
}

template <class D>
size_t wgrad_part_bytes(int B, int T, int n_sm) {
  return (size_t)wgrad_splits<D>(B, T, n_sm).splits * Part<D>::P * 4;
}

// One layer's weight gradients from x = acts[l] (B, T, C), cond (B, T, M),
// dg (B, T, G), dout (B, T, N_OUT) and z (B, T, GH), all bf16; `part` holds
// wgrad_part_bytes.
template <class D>
int wgrad(const bf16* x, const bf16* cond, const bf16* dg, const bf16* dout, const bf16* z,
          float* part, float* dw_in, float* db_g, float* dw_out, float* db_rs, int B, int T,
          int d, int n_sm, cudaStream_t st) {
  CUtensorMap tm_dg, tm_dout, tm_x, tm_cond, tm_z;
  if (!make_map(&tm_dg, dg, false, 3, D::G, T, B, WR) ||
      !make_map(&tm_dout, dout, false, 3, D::N_OUT, T, B, WR) ||
      !make_map(&tm_x, x, false, 3, D::C, T, B, WR) ||
      !make_map(&tm_cond, cond, false, 3, D::M, T, B, WR) ||
      !make_map(&tm_z, z, false, 3, D::GH, T, B, WR))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wgrad_gemm<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Wg<D>::SMEM);
  if (err != cudaSuccess) return err;
  const WgradSplits w = wgrad_splits<D>(B, T, n_sm);
  wgrad_gemm<D><<<dim3(Wg<D>::TILES, w.splits), W_THREADS, Wg<D>::SMEM, st>>>(
      tm_dg, tm_dout, tm_x, tm_cond, tm_z, part, w.n_tt, w.n_stages, w.per, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_reduce<D><<<(Part<D>::P + 255) / 256, 256, 0, st>>>(part, w.splits, dw_in, db_g,
                                                            dw_out, db_rs);
  return cudaGetLastError();
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

struct BwdWorkspace {
  size_t dpart, dcs0, dcs1, dcond32, dout, dg, z, part, total;
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
  if (want_wgrads) {
    w.dout = take(R * D::N_OUT * 2);
    w.dg = take(R * D::G * 2);
    w.z = take(R * D::GH * 2);
    w.part = take(wgrad_part_bytes<D>(B, T, n_sm));
  }
  w.total = off;
  return w;
}

template <class D>
bool is_dims(int c, int g, int s, int m) {
  return c == D::C && g == D::G && s == D::S && m == D::M;
}

// f(D{}) for the instantiation of these widths (teacher_lj's,
// student_iaf's or the wide teacher's), else `other`.
template <class F>
long long with_dims(int c, int g, int s, int m, long long other, F f) {
  if (is_dims<Teacher>(c, g, s, m)) return f(Teacher{});
  if (is_dims<Student>(c, g, s, m)) return f(Student{});
  if (is_dims<WideTeacher>(c, g, s, m)) return f(WideTeacher{});
  return other;
}

template <class D>
int train_bwd(const bf16* acts, const bf16* cond, const bf16* dskip,
              const bf16* w_in, const float* b_g, const bf16* w_out, bf16* dx,
              bf16* dcond, float* dw_in, float* db_g, float* dw_out, float* db_rs,
              unsigned char* ws, int B, int T, int L, const int* dil, int want_wgrads,
              int n_sm, cudaStream_t st) {
  // the split widths' layer pass: 64-row tiles (SplitDims)
  constexpr bool SPLIT = std::is_same<D, WideTeacher>::value;
  auto layer = [] {
    if constexpr (SPLIT)
      return train_bwd_layer_split<D>;
    else
      return train_bwd_layer<D>;
  }();
  constexpr int TR = [] {
    if constexpr (SPLIT)
      return D::TM;
    else
      return LT;
  }();
  constexpr int SMEM = [] {
    if constexpr (SPLIT)
      return D::SMEM;
    else
      return Lay<D>::SMEM;
  }();
  cudaError_t err = cudaFuncSetAttribute(layer, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return err;
  const BwdWorkspace w = bwd_workspace<D>(B, T, want_wgrads, n_sm);
  float* dpart = reinterpret_cast<float*>(ws + w.dpart);
  float* dcs[2] = {reinterpret_cast<float*>(ws + w.dcs0), reinterpret_cast<float*>(ws + w.dcs1)};
  float* dcond32 = reinterpret_cast<float*>(ws + w.dcond32);
  bf16* dout_g = want_wgrads ? reinterpret_cast<bf16*>(ws + w.dout) : nullptr;
  bf16* dg_g = want_wgrads ? reinterpret_cast<bf16*>(ws + w.dg) : nullptr;
  bf16* z_g = want_wgrads ? reinterpret_cast<bf16*>(ws + w.z) : nullptr;
  float* part = want_wgrads ? reinterpret_cast<float*>(ws + w.part) : nullptr;

  CUtensorMap tm_cond, tm_dskip, tm_dout = {}, tm_dg = {};
  if (!make_map(&tm_cond, cond, false, 3, D::M, T, B, TR) ||
      !make_map(&tm_dskip, dskip, false, 3, D::S, T, B, LWG) ||
      (want_wgrads && (!make_map(&tm_dout, dout_g, false, 3, D::N_OUT, T, B, LWG) ||
                       !make_map(&tm_dg, dg_g, false, 3, D::G, T, B, LWG))))
    return cudaErrorInvalidValue;
  const int n_tt = (T + TR - 1) / TR, n_tiles = B * n_tt;
  const int grid = n_tiles < n_sm ? n_tiles : n_sm;
  const size_t act = (size_t)B * T * D::C;
  int cur = 0;
  for (int l = L - 1; l >= 0; --l) {
    cur = (L - 1 - l) & 1;
    const bf16* acts_l = acts + l * act;
    const bf16* w_in_l = w_in + (size_t)l * D::G * D::K_IN;
    const bf16* w_out_l = w_out + (size_t)l * D::N_OUT * D::GH;
    CUtensorMap tm_x, tm_win, tm_wout;
    if (!make_map(&tm_x, acts_l, false, 3, D::C, T, B, TR) ||
        !make_map(&tm_win, w_in_l, false, 2, D::K_IN, D::G, 1, 64) ||
        !make_map(&tm_wout, w_out_l, false, 2, D::GH, D::N_OUT, 1, 64))
      return cudaErrorInvalidValue;
    layer<<<grid, L_THREADS, SMEM, st>>>(
        tm_x, tm_cond, tm_dskip, tm_win, tm_wout, tm_dout, tm_dg,
        b_g + (size_t)l * D::G, dpart, dcs[cur ^ 1], dcs[cur], dcond32, z_g, T, n_tt,
        n_tiles, dil[l], l + 1 < L ? dil[l + 1] : 0, l == L - 1, want_wgrads);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (!want_wgrads) continue;
    err = (cudaError_t)wgrad<D>(acts_l, cond, dg_g, dout_g, z_g, part,
                                dw_in + (size_t)l * D::G * D::K_IN, db_g + (size_t)l * D::G,
                                dw_out + (size_t)l * D::N_OUT * D::GH,
                                db_rs + (size_t)l * D::N_OUT, B, T, dil[l], n_sm, st);
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

#ifdef PWN_FLOW_STACK_TRAIN_PHASES
// Copies the phase cycles since the last call into out[8] and clears them.
int pwn_flow_stack_train_phases(unsigned long long* out) {
  const unsigned long long zero[8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, fst_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(fst_phase_cycles, zero, sizeof(zero));
  return err;
}
#endif

// Bytes of device workspace the backward needs (dx and dcond chains, the
// tap-cotangent buffers, and with weight gradients the bf16 dout/dg/z and
// the split-K partials); -1 for widths the kernels are not built for
// (teacher_lj's (128, 256, 128, 80) and student_iaf's (64, 128, 64, 80)
// are).
long long pwn_flow_stack_train_bwd_workspace_bytes(int B, int T, int c, int g,
                                                   int s, int m, int want_wgrads,
                                                   int n_sm) {
  return with_dims(c, g, s, m, -1, [&](auto dims) {
    return (long long)bwd_workspace<decltype(dims)>(B, T, want_wgrads, n_sm).total;
  });
}

// Kernel 3: dx (B, T, C) and dcond (B, T, M) in bf16; with want_wgrads the
// fp32 weight gradients dw_in (L, G, K_IN), db_g (L, G), dw_out (L, C+S, G/2),
// db_rs (L, C+S), stored (out, in) like the weights w_in and w_out.
// `workspace` holds pwn_flow_stack_train_bwd_workspace_bytes(...) bytes.
int pwn_flow_stack_train_bwd_bf16(const void* acts, const void* cond,
                                  const void* dskip, const void* w_in,
                                  const void* b_g, const void* w_out, void* dx,
                                  void* dcond, void* dw_in, void* db_g, void* dw_out,
                                  void* db_rs, void* workspace, int B, int T,
                                  int L, int c, int g, int s, int m,
                                  const int* dilations, int want_wgrads,
                                  int n_sm, void* stream) {
  if (!valid_shape(B, T, L, dilations) || n_sm < 1) return cudaErrorInvalidValue;
  if (want_wgrads && (!dw_in || !db_g || !dw_out || !db_rs))
    return cudaErrorInvalidValue;
  return (int)with_dims(c, g, s, m, cudaErrorInvalidValue, [&](auto dims) {
    return (long long)train_bwd<decltype(dims)>(
        static_cast<const bf16*>(acts), static_cast<const bf16*>(cond),
        static_cast<const bf16*>(dskip), static_cast<const bf16*>(w_in),
        static_cast<const float*>(b_g), static_cast<const bf16*>(w_out),
        static_cast<bf16*>(dx), static_cast<bf16*>(dcond), static_cast<float*>(dw_in),
        static_cast<float*>(db_g), static_cast<float*>(dw_out),
        static_cast<float*>(db_rs), static_cast<unsigned char*>(workspace), B, T,
        L, dilations, want_wgrads, n_sm, static_cast<cudaStream_t>(stream));
  });
}

// Bytes of device workspace for pwn_flow_stack_train_wgrad_bf16; -1 for
// widths it is not built for.
long long pwn_flow_stack_train_wgrad_workspace_bytes(int B, int T, int c, int g, int s,
                                                     int m, int n_sm) {
  if (B < 1 || T < 1 || n_sm < 1) return -1;
  return with_dims(c, g, s, m, -1, [&](auto dims) {
    return (long long)wgrad_part_bytes<decltype(dims)>(B, T, n_sm);
  });
}

// Kernel 3's weight-gradient GEMM alone, for one layer: from x = acts[l]
// (B, T, C), cond (B, T, M), dg (B, T, G), dout (B, T, C+S), z (B, T, G/2)
// in bf16, the fp32 dw_in (G, K_IN), db_g (G), dw_out (C+S, G/2), db_rs
// (C+S).  Returns a cudaError_t (0 on success).
int pwn_flow_stack_train_wgrad_bf16(const void* x, const void* cond, const void* dg,
                                    const void* dout, const void* z, void* dw_in,
                                    void* db_g, void* dw_out, void* db_rs, void* workspace,
                                    int B, int T, int c, int g, int s, int m, int dilation,
                                    int n_sm, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || dilation < 1 || n_sm < 1) return cudaErrorInvalidValue;
  return (int)with_dims(c, g, s, m, cudaErrorInvalidValue, [&](auto dims) {
    return (long long)wgrad<decltype(dims)>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(cond),
        static_cast<const bf16*>(dg), static_cast<const bf16*>(dout),
        static_cast<const bf16*>(z), static_cast<float*>(workspace),
        static_cast<float*>(dw_in), static_cast<float*>(db_g), static_cast<float*>(dw_out),
        static_cast<float*>(db_rs), B, T, dilation, n_sm, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
