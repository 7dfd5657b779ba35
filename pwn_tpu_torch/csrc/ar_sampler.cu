// Whole-loop teacher autoregressive sampler for Hopper (sm_90a): Fast
// WaveNet with per-layer conv queues, all T steps in one launch, each batch
// row on one cluster of N = 8 thread blocks (at the wide teacher's widths,
// two rows a cluster of 16; at every other width a cluster of 8 over a
// runtime-width loop: the last two items of the design below).
//
// Replaces: pwn_tpu/ops/pallas/ar_sampler.py::_kernel (reached through
// ar_sample_pallas <- models/sampling.py::fast_sample_pallas <-
// generate.generate_teacher).  Per step t, for one batch row, all in fp32
// over weights stored in bf16 or fp32:
//     x    = x_prev * front_k + front_b                          (C)
//     per layer l (dilation d_l, queue slot s = off_l + t % d_l):
//       tap = queue[s];  queue[s] = x                            read, then write
//       g   = [x | tap | cond(t)] @ W_in[l] + b_g[l]             (2C+M) x G
//       z   = tanh(g[:G/2]) * sigmoid(g[G/2:])
//       out = z @ W_out[l] + b_rs[l]                             (G/2) x (C+S)
//       x  += out[:C];  skip += out[C:]
//     h = relu(skip);  h = relu(h @ head1 + b1);  p = h @ head2 + b2
//     MoL:  k* = argmax(p[:K] - log(-log u[:K])) (a tie splits evenly),
//           x_t = mean[k*] + exp(max(log_s[k*], lsm)) * temp * (log u_K - log1p(-u_K))
//     Gaussian:  x_t = p0 + exp(max(p1, lsm)) * temp * eps
//     x_t = clip(x_t, -1, 1), written out and fed back as x_prev.
// The noise (uniforms or normals) is drawn outside, as in the reference.
//
// What bounds it on this card.  A step is a chain of 2L + 2 small dependent
// matrix-vector products per row.  At teacher_lj widths (C=128, G=256,
// S=128, M=80, L=24) that is 5.9 MFLOP per row per step over 5.79 MB of bf16
// weights: by the roofline (67 TFLOP/s fp32, 3.35 TB/s), about 0.7 us per
// step at batch 8.  The weights (5.79 MB in bf16, 11.6 MB in fp32) fit in no
// SM, so they stay in the 50 MB L2 and are read again every step; split over
// a row's 8 SMs that is 712,704 B per SM per step, which L2 delivers faster
// than the layers consume it.  What bounds a step is latency: each of its 24
// layers is a chain of dependent shared-memory passes, shuffle sums,
// libm calls, two block barriers and one exchange between SMs
// (tools/torch_ar_sampler_phases.py splits it).
//
// Design:
// * One cluster of N = 8 blocks (one per SM) per batch row.  Rank j owns
//   gate columns [j GH/N, (j+1) GH/N) of the tanh half and the same of the
//   sigmoid half (32 columns at GH = 128), and the same GH/N rows of W_out.
//   Per layer it reads its 2GH/N x (2C+M) slice of W_in (column-major) and
//   GH/N x (C+S) slice of W_out: 29,696 B in bf16, 712,704 B per step at
//   L = 24, against 5.79 MB for one block.  `pack_ar_ranks`
//   (ops/ar_sampler.py) lays each rank's slices out as one contiguous run per
//   layer.  Clusters own whole rows and never wait on each other, so a batch
//   larger than the card's clusters runs in waves.
// * The stream.  One thread brings each layer's run into a ring of STAGES
//   shared-memory stages with one 1-D bulk copy (cp.async.bulk, completion
//   counted on the stage's mbarrier); the ring cycles through the layers
//   across the steps.  A stage is refilled at the block barrier of the layer
//   after the one that used it, so a copy has about STAGES - 2 layers to
//   land (4 stages ran faster than 3 on the H100; the tool below times both).
// * The gate.  Warp w owns GH/(8N) tanh columns and their sigmoid partners,
//   so each gate column is one whole K = 2C+M dot product inside one warp
//   (lanes over k pairs, then a shuffle sum): no sum across warps or SMs
//   before the gated unit.  Then one block barrier, and thread n computes
//   output n's partial z @ W_out over this rank's z rows.
// * One exchange per layer.  The residual half of the partial (C floats)
//   goes to every rank's shared memory by st.async (16 bytes a store),
//   double-buffered by layer parity and counted on the receiving rank's
//   mbarrier for that parity: a rank waits only until all N partials have
//   landed in its own shared memory, not for the other ranks to reach a
//   barrier.  While it waits, every warp computes the next layer's gate
//   product over its tap and cond rows (C+M of the 2C+M), which do not
//   depend on x.  Then every warp of every rank sums the N partials in rank
//   order 0..N-1 into its own copy of x (lane i holds rows 2i, 2i+1, 2i+64,
//   2i+65 at C = 128), so the gate product follows with no block barrier.
//   A buffer is written again two layers later only by a rank that has
//   received this rank's next partial, which this rank sends after reading
//   the buffer.  The skip half stays in the rank across the layers; at the
//   last layer the skip partials go out in place of the residual, which that
//   layer does not need.
// * Every rank holds the same x, skip, head output and sample, bit for bit:
//   each reduces the same partials in the same order with the same code (no
//   atomics, nothing rank-dependent).  The head (its weights in each block's
//   shared memory) and the draw run in every rank; rank 0 writes wav.
// * The queues (sum(d) x C fp32, 392 KB per row at teacher_lj) live in
//   device memory, (B, sum(d), C), zeroed by the caller.  Rank j writes only
//   its C/N columns of each layer's x, and only for layers with d > 1.  Every
//   rank keeps all L taps of the step in shared memory and fills them for the
//   next step while this one runs: a layer with d = 1 takes this step's x, a
//   layer with d > 1 its queue slot for step t+1, written at step t+1-d or
//   earlier, read after the layer's gate product with ld.global.cg (never
//   the non-coherent path: other SMs write the queue during the launch).
//   One cluster barrier per step orders the queue: its arrive (release)
//   ends a step, its wait (acquire) comes before the next step's first
//   queue access, so every write of a step is seen by the reads of the next,
//   and every read of a slot comes before the step that writes it again.
// * Numerics are the reference's: fp32 FMAs on the CUDA cores, IEEE
//   tanhf/expf/logf/log1pf (no fast-math), sigmoid as 1/(1+exp(-x)).  Only
//   the summation order differs from the plain version.
// * Shared memory at teacher_lj, bf16 weights: the ring 119 KB (4 stages),
//   the head's weights 40 KB, the taps 12 KB, the exchange 8 KB: 178 KB.
//   fp32 weights take 2 stages (116 KB; a refill then meets its use) and
//   79 KB of head weights.
// * A pipeline fault traps (2^26 polls of an mbarrier) instead of hanging
//   the card.
// * The wide teacher, (C, G, S, M) = (256, 512, 256, 80) (the JAX package's
//   "wide (24 x 256ch)"), runs a kernel of its own, `ar_wide_kernel`, sized
//   by `WideDims`.  Its weights are 20.8 MB in bf16 (41.7 MB in fp32); a
//   rank's layer slice at N = 8 is 108,544 B in bf16, so no ring of whole
//   slices fits a block, and one row a cluster read every weight once a row
//   (8 x 20.8 MB a step at batch 8).  What it does instead:
//   - R = 2 batch rows a cluster, N = 16 blocks (a non-portable cluster
//     size; 7 clusters fit the H100, 4 run a batch of 8 in one wave).  Every
//     weight a thread loads serves both rows, so a step reads (B/R) x 20.8
//     MB from L2 (83 MB at batch 8, not 167), and a rank's slice of a layer
//     is 54,272 B in bf16: 1.3 MB an SM a step over 64 SMs.  The choice,
//     from the budget of bytes and FMAs an SM and the phase tool (H100,
//     bf16, batch 8): R x N = 2 x 8 on 32 SMs streams 2.6 MB an SM a step
//     and ran 92-101 us a step where 2 x 16, which halves the stream and
//     the products an SM, ran 71-76 in the same calls
//     (tools/torch_ar_sampler_phases.py, "8 ranks" beside the kernel).
//   - The stream.  A producer warp (a 9th warp: lane 0) brings each layer's
//     run into a ring of chunks of WIDE_CHUNK_E = 4,096 weights (8 KB in
//     bf16, 16 KB in fp32) by 1-D bulk copies, each counted on its stage's
//     full mbarrier; the 8 consumer warps read every chunk and release its
//     stage on its empty mbarrier (8 arrivals), after which the producer
//     refills it.  The ring takes as many stages as the shared memory left
//     holds, up to 16 (bf16: 16, fp32: 7, at L = 24).  The run is laid out
//     in the order it is consumed (`pack_ar_ranks(..., "chunks")`): the tap
//     and cond rows of W_in (the product that runs while the exchange
//     lands), its x rows, then W_out's rows.  Chunks of 2,048 weights were
//     slower (more hand-offs), of 8,192 slower in both types, a ring of 6
//     stages as fast as one of 16, and a copy of a quarter of each chunk as
//     fast as the whole: the stream's bytes do not bound a step, its
//     hand-offs and the layer's chain of dependent phases do.
//   - The products read 16-byte operands from the ring.  Gate: warp w owns
//     its rank's z values [w ZW, (w+1) ZW) (ZW = 2 at N = 16), lane group a
//     (LG = 16 lanes) value w ZW + a: its tanh and sigmoid columns; lane o
//     holds 16-byte vectors o + LG v of each chunk's columns, so weights e =
//     4h + i of vector gv are rows 4 (h kc/VW + gv) + i and the lanes' input
//     reads cover consecutive addresses; two accumulators a column and row,
//     a shuffle sum over the group, then lane o = r forms row r's z.  Out:
//     thread q owns outputs 2q and 2q + 1, a 16-byte vector RV rows of its
//     two columns.  Both are software-pipelined: chunk j + 1's weights and
//     inputs are loaded while chunk j's FMAs run.
//   - The exchange is a reduce-scatter and a broadcast.  Rank k owns columns
//     [16k, 16k + 16) of x and of the skip sum.  Each residual partial goes
//     to its owner by st.async (lanes 2m and 2m + 1 swap halves, so that
//     lane 2m + r holds row r of 4 columns: one 16-byte store a thread),
//     counted on the owner's pbar; warp OWNER of the owner sums the N
//     partials in rank order, adds them to x, writes its columns to the
//     queues, and sends the 16 x R new values to every rank by st.async,
//     counted on each rank's xbar.  A rank moves 4 KB a layer over DSMEM
//     this way, against 32 KB for every partial to every rank; at the last
//     layer the skip partials go the same way and relu(skip) lands in hs.
//     Every rank holds the owners' bits, so all ranks agree.  Buffers are
//     written again only after every reader has sent what the writer waits
//     for (z is double-buffered by layer parity for the out product's
//     stragglers).  Summing on warp OWNER, which has no x pair of its own,
//     ran 4-7% faster than on warp 0.
//   - head1 is split: rank j holds its S/N = 16 columns and sends those
//     hidden values of each row to every rank by st.async (one more
//     mbarrier); head2 and the draw run in every rank, warp r for row r.
//   - A row past B (a batch that R does not divide) reads row B - 1's cond
//     and noise and writes nothing.
//   Shared memory at L = 24 (taps 48 KB, head1's slice and head2 23 KB in
//   bf16, 46 KB in fp32, the rest 11 KB) leaves the ring 128 KB in bf16,
//   112 KB in fp32; a longer stack leaves less, and fewer than 2 stages is
//   refused.  teacher_lj's and the tiny teacher's instantiations are the
//   ring kernel above, unchanged: their samples are the same bits as
//   before (tools/torch_ar_sampler_phases.py --before).  At batch 8 a step
//   is 902.6 GFLOP / 5,376 in fp32 (2.5 us at 67 TFLOP/s); on the H100
//   (700 W) it took 71.3 us in bf16 weights and 73.5 in fp32, against 88.6
//   and 112.5 in the same call for one row an 8-block cluster reading its
//   slices from L2; the phase split is in PERF.md section 5.
// * The general-width body, `ar_generic_kernel`, takes what the three
//   instantiations above do not: any (C, G, S, M) with G even, any head
//   width HD (3K for MoL, any K; 2 for the Gaussian head) and any number of
//   layers, the widths at run time.  It is the ring kernel's design over a
//   runtime-width loop:
//   - One batch row a cluster of N = 8 blocks (the portable size).  Rank j
//     owns z values [j gn, (j+1) gn) (gn = ceil(G/2 / N)): their tanh and
//     sigmoid columns of W_in and their rows of W_out.  Where N does not
//     divide G/2 the packing pads with zero columns, biases and W_out rows,
//     so a padded z is tanh(0) sigmoid(0) = 0 and adds nothing.  A step's
//     weights come into 8 SMs: 17,664 B an SM a layer at (96, 192, 96, 80)
//     in bf16 (424 KB a step at 24 layers), not 3.42 MB into one.
//   - The stream.  `ops/ar_sampler.py::generic_ar_plan` cuts a rank's layer
//     into tiles in the order they are consumed (`gen_tiles`): per pass of
//     16 z values, the tap rows and the cond rows of W_in, then per pass its
//     x rows (k-blocks of rows; a tile column-major, each column's rows
//     rounded up to whole 16-byte vectors with zeros), then W_out (row
//     blocks of 256 columns).  Where a whole layer fits a stage twice (up to
//     4 stages) it moves in one 1-D bulk copy; else each tile is a unit of
//     its own, up to 8 KB, 2 to 8 stages.  A producer warp (lane 0) issues
//     the units into the ring on full/empty mbarriers, as the wide kernel's,
//     so the next layers land while this one computes.
//   - The gate: warp w owns z values w + 8i of a pass (i < 2), both columns
//     of each; a column's whole 2C+M dot product stays in the warp (lane v
//     takes 16-byte weight vector v of each column and the 8 or 4 inputs of
//     its rows from x, the tap or cond, each zero-padded to 8 floats; then a
//     transposed shuffle butterfly for all of a warp's columns): no partial
//     sums across warps before the gated unit.  The tap-and-cond product
//     (its sums and the biases kept in shared memory) runs while the
//     exchange of the layer before lands; the x product follows it.  Two z
//     values a warp a pass ran faster than four or one (H100, CLI widths:
//     75.3 us a step against 78.1 and 95.5).  tools/torch_ar_sampler_phases.py
//     splits a step and times copies with one piece removed.
//   - The exchange: thread q's out partial of a residual column goes to every
//     rank by st.async (4 columns a lane, gathered by shuffles), counted on
//     that rank's mbarrier for the layer's parity, one block barrier after;
//     every rank sums the N partials in rank order, so all ranks hold the
//     same x, skip, head output and sample, bit for bit.  The skip partials
//     stay in the rank until the last layer, where they go out in place of
//     the residual.  The head (its weights in shared memory where they fit,
//     else read from L2) and the draw run in every rank; rank 0 writes wav.
//   - The queues: fp32 (B, sum(d + 1), round8(C)) in global memory, d + 1
//     slots a layer, so the slot a step reads is never the one it writes;
//     rank j writes columns [j ceil(C/N), ...) of x.  Where L x C fits, the
//     taps are held in shared memory and refilled for the next step by
//     16-byte cp.async.cg (d > 1) or from x (d = 1); else the tap product
//     reads the slot with ld.global.cg.  Both read after the step's cluster
//     barrier, never through the non-coherent path (other SMs write the
//     queue during the launch).
//   - Numerics as above: fp32 FMAs, IEEE tanhf/expf/logf/log1pf; the draw in
//     warp 0 over K in strides of 32.  Tensor cores are not used: a step is
//     a product of one row's vector, and wgmma's 64-row tile would leave at
//     least 63/64 of it idle.
//   Its shared memory (`generic_ar_smem_bytes`) is mostly the exchange
//   buffer, 2 x N x max(C, S) floats: past max(C, S) ~ 3,400 no plan fits
//   a block (at C = 3,380, S = 1, M = 40 the buffer is 216,320 B of the
//   232,448 and two 1 KB tiles fill the rest), and those widths run the
//   one-block body, `ar_block_kernel` ("block"): one block of 512 threads a
//   row, the weights read from L2 every step (the general body before this
//   design: about 24 us a MB of weights a step plus 80 us).
// With PWN_AR_SAMPLER_PHASES defined (tools/torch_ar_sampler_phases.py builds
// it so), one thread of block 0 (thread 0; in the wide kernel lane 0 of warp
// OWNER) adds the clock cycles of each phase of each step into
// ar_phase_cycles (PHASE_NAMES below), then counts the steps.  With
// PWN_AR_SAMPLER_CHECK defined, every rank writes its samples to wav_ranks
// (N, B, T), so that a tool can hold the ranks equal bit for bit.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NTHREADS = 256;  // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_L = 64;      // layers
constexpr int MAX_HD = 32;     // head width
constexpr unsigned FULL = 0xffffffffu;
constexpr int REFILL = NTHREADS - 32;  // lane 0 of the last warp feeds the ring

struct Dilations {
  int d[MAX_L];    // dilation of layer l
  int off[MAX_L];  // first queue slot of layer l
};

struct Args {
  const void* cond;      // (B, T, M) bf16 or fp32
  const float* noise;    // (T, B, NZ): K+1 uniforms (MoL) or 1 normal
  const void* front_k;   // (1, C)
  const float* front_b;  // (1, C)
  const void* w_rank;    // (N, L, LAYER_E): per rank and layer, its W_in columns
                         // (2GH/N x (2C+M)) then its W_out rows (GH/N x (C+S))
  const float* b_rank;   // (N, L, 2GH/N): its gate biases
  const float* b_rs;     // (L, C+S)
  const void* head1_k;   // (S, S)
  const float* head1_b;  // (1, S)
  const void* head2_k;   // (S, HD)
  const float* head2_b;  // (1, HD)
  float* queue;          // (B, sum(d), C), zero on entry
  float* wav;            // (B, T)
  float* wav_ranks;      // (N, B, T), written by the PWN_AR_SAMPLER_CHECK build only
  int B, T, L, HD, K, NZ, sum_d, gaussian;
  float log_scale_min, temperature;
};

#ifdef PWN_AR_SAMPLER_PHASES
constexpr int NPHASES = 9;
constexpr const char* PHASE_NAMES =
    "step start;waiting for weights;tap and cond product;x update;"
    "x product and gates;out product;DSMEM push;exchange wait;head and draw";
// the cycles of each phase, then the count of steps
__device__ unsigned long long ar_phase_cycles[NPHASES + 1];
#define PHASE(k)                                                               \
  do {                                                                         \
    if (phase_on) {                                                            \
      const long long now = clock64();                                         \
      phase_acc[k] += static_cast<unsigned long long>(now - phase_t);          \
      phase_t = now;                                                           \
    }                                                                          \
  } while (0)
#else
#define PHASE(k)
#endif

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Two consecutive weights as fp32.
__device__ __forceinline__ float2 pair_f32(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// 16 bytes of cond: 8 bf16 or 4 fp32 values.
template <typename T> struct Vec;
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void to_f32(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void to_f32(const uint4& r, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&r);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// The widths, the rank split, the thread maps and the shared memory.
template <typename W, typename CT, int C, int G, int S, int M, int N>
struct Dims {
  static constexpr int GH = G / 2, GN = GH / N, GC = 2 * GN, KIN = 2 * C + M, NO = C + S;
  static constexpr int WIN_E = GC * KIN, LAYER_E = WIN_E + GN * NO;
  static constexpr int LAYER_BYTES = LAYER_E * sizeof(W);
  static constexpr int STAGES = sizeof(W) == 2 ? 4 : 2;
  // gate: warp w owns z values [w ZW, (w+1) ZW), so 2 ZW columns; lanes
  // over k pairs: XP pairs a lane over x (k < C), RP over tap and cond
  static constexpr int ZW = GN / NWARPS, ZC = 2 * ZW;
  static constexpr int KP = KIN / 2, XP = C / 64, RP = (KP - C / 2 + 31) / 32;
  static constexpr int HP = NTHREADS / S;                  // k parts of head1's product
  static constexpr int CH = M * (int)sizeof(CT) / 16;      // 16-byte chunks of cond(t)
  // shared memory, in bytes: the ring, then floats, then the head's weights
  static constexpr int RING = 0;
  static constexpr int F0 = STAGES * LAYER_BYTES;          // floats from here
  static constexpr int XBUF = 0;    // the exchange: 2 parities x N ranks x C (= S)
  static constexpr int CS = XBUF + 2 * N * C;      // cond(t) (M)
  static constexpr int ZP = round4(GN);
  static constexpr int ZS = CS + round4(M);        // z (GN), 2 parities
  static constexpr int HS = ZS + 2 * ZP;           // the head's hidden (S)
  static constexpr int HPART = HS + S;             // head1 partials, HP x S
  static constexpr int HPO = HPART + HP * S;       // head outputs (MAX_HD)
  static constexpr int TAPS = HPO + MAX_HD;        // then the taps, L x C
  static_assert(GH % N == 0 && C % N == 0 && GN % NWARPS == 0, "gate split");
  static_assert(C % 64 == 0 && M % 2 == 0 && NO % 32 == 0 && NO <= NTHREADS, "thread maps");
  static_assert(S == C && NTHREADS % S == 0 && (S / HP) % 2 == 0, "head split");
  static_assert(M * sizeof(CT) % 16 == 0 && C + CH <= NTHREADS, "cond chunks");
  static_assert(LAYER_BYTES % 16 == 0 && F0 % 16 == 0, "16-byte bulk copies");
};

template <typename W, typename CT, int C, int G, int S, int M, int N>
size_t smem_bytes(int L, int HD) {
  using D = Dims<W, CT, C, G, S, M, N>;
  return D::F0 + sizeof(float) * (size_t)(D::TAPS + L * C) + sizeof(W) * (size_t)S * (S + HD);
}

// The gate product of warp `warp`'s columns over the tap and cond rows of
// [x | tap | cond] (k pairs C/2 .. KP-1), into acc: lanes over the pairs.
template <typename W, typename CT, int C, int G, int S, int M, int N>
__device__ __forceinline__ void gate_tap_cond(float (&acc)[Dims<W, CT, C, G, S, M, N>::ZC],
                                              const W* win, const float* tap, const float* cs,
                                              int warp, int lane) {
  using D = Dims<W, CT, C, G, S, M, N>;
#pragma unroll
  for (int i = 0; i < D::ZC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int m = 0; m < D::RP; ++m) {
    const int p = C / 2 + lane + 32 * m;
    if (p < D::KP) {
      const float2 in = p < C ? *reinterpret_cast<const float2*>(tap + 2 * p - C)
                              : *reinterpret_cast<const float2*>(cs + 2 * p - 2 * C);
#pragma unroll
      for (int c = 0; c < D::ZC; ++c) {
        const int col = c < D::ZW ? warp * D::ZW + c : D::GN + warp * D::ZW + (c - D::ZW);
        const float2 w = pair_f32(win + col * D::KIN + 2 * p);
        acc[c] = fmaf(in.x, w.x, acc[c]);
        acc[c] = fmaf(in.y, w.y, acc[c]);
      }
    }
  }
}

// Rank `rank`'s C/N columns of x (lane's rows 2p, 2p + 1, p = lane + 32m)
// into queue slot `slot`.
template <int C, int N, int XP>
__device__ __forceinline__ void queue_store(float* queue, int slot, const float (&xv)[2 * XP],
                                            int rank, int lane) {
#pragma unroll
  for (int m = 0; m < XP; ++m) {
    const int p = lane + 32 * m;
    if (2 * p / (C / N) == rank)
      __stcg(reinterpret_cast<float2*>(queue + (size_t)slot * C) + p,
             make_float2(xv[2 * m], xv[2 * m + 1]));
  }
}

// The stack widths (C, G, S, M) and the ranks N are compile-time, so the
// products unroll.
template <typename W, typename CT, int C, int G, int S, int M, int N>
__global__ void __launch_bounds__(NTHREADS, 1)
ar_sampler_kernel(const Args a, const Dilations dl) {
  using D = Dims<W, CT, C, G, S, M, N>;
  constexpr int GN = D::GN, GC = D::GC, NO = D::NO, ZW = D::ZW, ZC = D::ZC;
  constexpr int STAGES = D::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int b = blockIdx.x / N;
  const int L = a.L, T = a.T, HD = a.HD, K = a.K;
  const char* cond = static_cast<const char*>(a.cond) + (size_t)b * T * M * sizeof(CT);
  const W* w_rank = static_cast<const W*>(a.w_rank) + (size_t)rank * L * D::LAYER_E;
  const float* b_rank = a.b_rank + (size_t)rank * L * GC;
  float* queue = a.queue + (size_t)b * a.sum_d * C;

  extern __shared__ __align__(128) unsigned char smem[];
  const W* ring = reinterpret_cast<const W*>(smem + D::RING);
  float* fsm = reinterpret_cast<float*>(smem + D::F0);
  float* xbuf = fsm + D::XBUF;
  float* cs = fsm + D::CS;
  float* zs = fsm + D::ZS;
  float* hs = fsm + D::HS;
  float* hpart = fsm + D::HPART;
  float* hp = fsm + D::HPO;
  float* taps = fsm + D::TAPS;
  W* head1 = reinterpret_cast<W*>(taps + L * C);
  W* head2 = head1 + S * S;
  __shared__ int dd[MAX_L], oo[MAX_L], slot_now[MAX_L], slot_next[MAX_L];
  __shared__ float x_prev;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t xbar[2];  // the exchange's arrivals, by parity

#ifdef PWN_AR_SAMPLER_PHASES
  const bool phase_on = blockIdx.x == 0 && tid == 0;
  unsigned long long phase_acc[NPHASES + 1] = {};
  long long phase_t = clock64();
#endif

  // -- once: the ring's first layers, the dilations, the head's weights,
  //    zero taps, cond(0), per-thread constants
  const long long n_layers = (long long)T * L;  // layers over all steps
  constexpr uint32_t XBYTES = N * C * sizeof(float);  // one layer's exchange
  if (tid == REFILL) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    for (int p = 0; p < 2; ++p) {
      mbar_init(smem_u32(&xbar[p]), 1);
      mbar_expect_tx(smem_u32(&xbar[p]), XBYTES);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && s < n_layers; ++s) {
      mbar_expect_tx(smem_u32(&full[s]), D::LAYER_BYTES);
      bulk_load(smem_u32(ring + s * D::LAYER_E), w_rank + (size_t)(s % L) * D::LAYER_E,
                D::LAYER_BYTES, smem_u32(&full[s]));
    }
  }
  for (int l = tid; l < L; l += NTHREADS) {
    dd[l] = dl.d[l];
    oo[l] = dl.off[l];
  }
  {
    const uint4* src1 = static_cast<const uint4*>(a.head1_k);
    const uint4* src2 = static_cast<const uint4*>(a.head2_k);
    uint4* dst1 = reinterpret_cast<uint4*>(head1);
    uint4* dst2 = reinterpret_cast<uint4*>(head2);
    const int n1 = S * S * (int)sizeof(W) / 16, n2 = S * HD * (int)sizeof(W) / 16;
    for (int i = tid; i < n1; i += NTHREADS) dst1[i] = __ldg(src1 + i);
    for (int i = tid; i < n2; i += NTHREADS) dst2[i] = __ldg(src2 + i);
  }
  for (int i = tid; i < L * C; i += NTHREADS) taps[i] = 0.f;
  for (int m = tid; m < M; m += NTHREADS)
    cs[m] = to_f32(reinterpret_cast<const CT*>(cond)[m]);
  // every warp holds all of x: lane `lane` rows 2p, 2p + 1 for p = lane + 32m
  constexpr int XP = D::XP;
  float fk[2 * XP], fb[2 * XP], xv[2 * XP];
#pragma unroll
  for (int e = 0; e < 2 * XP; ++e) {
    const int row = 2 * (lane + 32 * (e / 2)) + e % 2;
    fk[e] = to_f32(static_cast<const W*>(a.front_k)[row]);
    fb[e] = a.front_b[row];
  }
  float bsum = 0.f;
  if (tid < S)
    for (int l = 0; l < L; ++l) bsum += a.b_rs[l * NO + C + tid];
  if (tid == 0) x_prev = 0.f;
  __syncthreads();
  // every block of the cluster has started before any writes into another's
  // shared memory
  cluster_arrive();
  cluster_wait();

  const bool res_warp = warp < C / 32;                // outputs [0, C): residual
  const bool skip_warp = !res_warp && warp < NO / 32; // outputs [C, C+S): skip
  // the exchange buffer and its barriers in ranks lane / 8 + 4i, where this
  // lane's pushes go
  uint32_t xbuf_at[N / 4], xbar_at[N / 4];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    xbuf_at[i] = mapa(smem_u32(xbuf), (lane >> 3) + 4 * i);
    xbar_at[i] = mapa(smem_u32(&xbar[0]), (lane >> 3) + 4 * i);
  }
  float skip_part = 0.f;  // this rank's skip partial of output tid (skip warps)
  float2 pend[XP];        // the next step's tap of the layer before (warp 0)
  bool pending = false;
  int par = 0;            // parity of the layers so far: the exchange's and z's buffer
  long long c = 0;        // layers so far, over all steps: the ring's counter

  for (int t = 0; t < T; ++t) {
    // -- step start: the queue slots, the front 1x1 (in every warp), layer 0's
    //    gate product over its tap and cond rows
    float u = 0.f;
    uint4 cond_next = make_uint4(0u, 0u, 0u, 0u);
    for (int l = tid; l < L; l += NTHREADS) {
      slot_now[l] = oo[l] + t % dd[l];
      slot_next[l] = oo[l] + (t + 1) % dd[l];
    }
#pragma unroll
    for (int e = 0; e < 2 * XP; ++e) xv[e] = __fadd_rn(__fmul_rn(x_prev, fk[e]), fb[e]);
    float acc[ZC];
    PHASE(0);
    mbar_spin(smem_u32(&full[c % STAGES]), (uint32_t)((c / STAGES) & 1));
    PHASE(1);
    gate_tap_cond<W, CT, C, G, S, M, N>(acc, ring + (c % STAGES) * D::LAYER_E, taps, cs, warp,
                                        lane);
    PHASE(2);

    for (int l = 0; l < L; ++l, ++c) {
      const W* stage = ring + (c % STAGES) * D::LAYER_E;
      const bool last = l + 1 == L;
      float* z = zs + par * D::ZP;
      const int zi = warp * ZW + lane % ZW;  // lanes 0..ZW-1: z value zi
      const float bga = __ldg(b_rank + l * GC + zi), bgb = __ldg(b_rank + l * GC + GN + zi);
      // gate product over the x rows (in registers); the gated unit in lanes
      // 0..ZW-1
#pragma unroll
      for (int m = 0; m < XP; ++m) {
        const int p = lane + 32 * m;
#pragma unroll
        for (int i = 0; i < ZC; ++i) {
          const int col = i < ZW ? warp * ZW + i : GN + warp * ZW + (i - ZW);
          const float2 w = pair_f32(stage + col * D::KIN + 2 * p);
          acc[i] = fmaf(xv[2 * m], w.x, acc[i]);
          acc[i] = fmaf(xv[2 * m + 1], w.y, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < ZC; ++i) acc[i] = warp_sum(acc[i]);
      if (lane < ZW) {
        float ga = acc[0], gb = acc[ZW];
#pragma unroll
        for (int i = 1; i < ZW; ++i)
          if (lane == i) {
            ga = acc[i];
            gb = acc[ZW + i];
          }
        ga = bga + ga;
        gb = bgb + gb;
        z[zi] = tanhf(ga) * (1.f / (1.f + expf(-gb)));
      }
      __syncthreads();
      // every thread is past the layer before's products: refill its stage
      if (tid == REFILL && c >= 1 && c - 1 + STAGES < n_layers) {
        const uint32_t bar = smem_u32(&full[(c - 1) % STAGES]);
        mbar_expect_tx(bar, D::LAYER_BYTES);
        bulk_load(smem_u32(ring + ((c - 1) % STAGES) * D::LAYER_E),
                  w_rank + (size_t)((c - 1 + STAGES) % L) * D::LAYER_E, D::LAYER_BYTES, bar);
      }
      PHASE(4);
      // the queue's writes of the step before are visible from here on
      if (l == 0 && t > 0) cluster_wait();
      // the taps of step t+1: this layer's (read above by every warp) from x
      // if d = 1, else from its queue slot; the layer before's lands now
      if (warp == 0) {
        const bool was = pending;
        pending = dd[l] > 1;
#pragma unroll
        for (int m = 0; m < XP; ++m) {
          const int p = lane + 32 * m;
          if (was) reinterpret_cast<float2*>(taps + (l - 1) * C)[p] = pend[m];
          if (!pending)
            reinterpret_cast<float2*>(taps + l * C)[p] = make_float2(xv[2 * m], xv[2 * m + 1]);
        }
      }
      // out product: output tid's partial over this rank's z rows
      float p = 0.f;
      if (tid < NO) {
        const W* wout = stage + D::WIN_E;
#pragma unroll
        for (int i = 0; i < GN; ++i) p = fmaf(z[i], to_f32(wout[i * NO + tid]), p);
      }
      PHASE(5);
      // the residual partials to every rank (the skip partials, summed over
      // the layers, at the last layer): 4 columns a lane, gathered by shuffles
      if (skip_warp) skip_part += p;
      if (last ? skip_warp : res_warp) {
        const float val = last ? skip_part : p;
        const int f = lane & 7;
        const float4 v = make_float4(__shfl_sync(FULL, val, 4 * f), __shfl_sync(FULL, val, 4 * f + 1),
                                     __shfl_sync(FULL, val, 4 * f + 2),
                                     __shfl_sync(FULL, val, 4 * f + 3));
        const int col = 32 * (last ? warp - C / 32 : warp) + 4 * f;
        const uint32_t off = 4 * ((par * N + rank) * C + col);
#pragma unroll
        for (int i = 0; i < N / 4; ++i) st_async(xbuf_at[i] + off, v, xbar_at[i] + 8 * par);
      }
      if (last && skip_warp) skip_part = 0.f;
      if (warp == 0 && pending)
#pragma unroll
        for (int m = 0; m < XP; ++m)
          pend[m] = __ldcg(reinterpret_cast<const float2*>(queue + (size_t)slot_next[l] * C) +
                           lane + 32 * m);
      if (l == 0) {
        if (warp == 0 && lane < a.NZ) u = __ldg(a.noise + ((size_t)t * a.B + b) * a.NZ + lane);
        if (tid >= C && tid < C + D::CH && t + 1 < T)
          cond_next = __ldg(
              reinterpret_cast<const uint4*>(cond + (size_t)(t + 1) * M * sizeof(CT)) + (tid - C));
      }
      PHASE(6);
      // while the other ranks catch up: the next layer's tap and cond rows
      if (!last) {
        mbar_spin(smem_u32(&full[(c + 1) % STAGES]), (uint32_t)(((c + 1) / STAGES) & 1));
        PHASE(1);
        gate_tap_cond<W, CT, C, G, S, M, N>(acc, ring + ((c + 1) % STAGES) * D::LAYER_E,
                                            taps + (l + 1) * C, cs, warp, lane);
        PHASE(2);
      }
      float2 brs[XP];
#pragma unroll
      for (int m = 0; m < XP; ++m)
        brs[m] = last ? make_float2(0.f, 0.f)
                      : __ldg(reinterpret_cast<const float2*>(a.b_rs + l * NO) + lane + 32 * m);
      // every rank's partials have landed here: arm this parity's next use
      mbar_spin_cluster(smem_u32(&xbar[par]), (uint32_t)((c >> 1) & 1));
      if (tid == REFILL && c + 2 < n_layers) mbar_expect_tx(smem_u32(&xbar[par]), XBYTES);
      PHASE(7);
      // every rank, and in it every warp, sums the N partials in rank order
      const float* xb = xbuf + par * N * C;
      par ^= 1;
      // warp 0 writes rank j's C/N columns of x into the queue (layers with
      // d > 1), after the step's cluster barrier: x_0 here, x_{l+1} below
      if (l == 0 && warp == 0 && dd[0] > 1) queue_store<C, N, XP>(queue, slot_now[0], xv, rank, lane);
      if (!last) {
        // every warp: its lanes' rows of x
#pragma unroll
        for (int m = 0; m < XP; ++m) {
          float ox = 0.f, oy = 0.f;
#pragma unroll
          for (int r = 0; r < N; ++r) {
            const float2 v = reinterpret_cast<const float2*>(xb + r * C)[lane + 32 * m];
            ox += v.x;
            oy += v.y;
          }
          xv[2 * m] = xv[2 * m] + (brs[m].x + ox);
          xv[2 * m + 1] = xv[2 * m + 1] + (brs[m].y + oy);
        }
        if (warp == 0 && dd[l + 1] > 1) queue_store<C, N, XP>(queue, slot_now[l + 1], xv, rank, lane);
      } else {
        if (tid < S) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < N; ++r) s += xb[r * C + tid];
          hs[tid] = fmaxf(bsum + s, 0.f);
        }
        __syncthreads();
      }
      PHASE(3);
    }

    // -- head: relu (above), 1x1, relu, 1x1, in every rank
    {
      constexpr int KH = S / D::HP;
      const int n = tid % S, part = tid / S;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll 8
      for (int k = part * KH; k < (part + 1) * KH; k += 2) {
        v0 = fmaf(hs[k], to_f32(head1[k * S + n]), v0);
        v1 = fmaf(hs[k + 1], to_f32(head1[(k + 1) * S + n]), v1);
      }
      hpart[part * S + n] = v0 + v1;
    }
    __syncthreads();
    if (tid < S) {
      float v = 0.f;
#pragma unroll
      for (int part = 0; part < D::HP; ++part) v += hpart[part * S + tid];
      hs[tid] = fmaxf(a.head1_b[tid] + v, 0.f);
    }
    __syncthreads();
    {
      constexpr int NJ = MAX_HD / NWARPS;  // columns warp, warp + NWARPS, ...
      float v[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) v[j] = 0.f;
#pragma unroll
      for (int k = lane; k < S; k += 32) {
        const float h = hs[k];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = warp + NWARPS * j;
          if (n < HD) v[j] = fmaf(h, to_f32(head2[k * HD + n]), v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = warp + NWARPS * j;
        if (n < HD) {  // warp-uniform
          const float s = warp_sum(v[j]);
          if (lane == 0) hp[n] = a.head2_b[n] + s;
        }
      }
    }
    __syncthreads();

    // -- the sample (warp 0 of every rank); the last layer's tap and cond(t+1)
    //    land
    if (warp == 0) {
      float xt;
      if (a.gaussian) {
        const float eps = __shfl_sync(FULL, u, 0);
        const float ls = fmaxf(hp[1], a.log_scale_min);
        xt = hp[0] + expf(ls) * a.temperature * eps;
      } else {
        const float score = lane < K ? hp[lane] - logf(-logf(u)) : -INFINITY;
        const float best = warp_max(score);
        const bool pick = lane < K && score >= best;
        const int count = __popc(__ballot_sync(FULL, pick));
        const float wgt = pick ? 1.f / (float)count : 0.f;
        const float mean = warp_sum(lane < K ? hp[K + lane] * wgt : 0.f);
        const float ls = warp_sum(lane < K ? fmaxf(hp[2 * K + lane], a.log_scale_min) * wgt : 0.f);
        const float ul = __shfl_sync(FULL, u, K);
        xt = mean + expf(ls) * a.temperature * (logf(ul) - log1pf(-ul));
      }
      xt = fminf(fmaxf(xt, -1.f), 1.f);
      if (lane == 0) {
        x_prev = xt;
        if (rank == 0) a.wav[(size_t)b * T + t] = xt;
#ifdef PWN_AR_SAMPLER_CHECK
        a.wav_ranks[((size_t)rank * a.B + b) * T + t] = xt;
#endif
      }
    }
    if (warp == 0 && pending)
#pragma unroll
      for (int m = 0; m < XP; ++m)
        reinterpret_cast<float2*>(taps + (L - 1) * C)[lane + 32 * m] = pend[m];
    pending = false;
    if (tid >= C && tid < C + D::CH)
      Vec<CT>::to_f32(cond_next, cs + (tid - C) * Vec<CT>::N);
    // this step's queue reads and writes are done (release)
    cluster_arrive();
    __syncthreads();
    PHASE(8);
#ifdef PWN_AR_SAMPLER_PHASES
    if (phase_on) ++phase_acc[NPHASES];
#endif
  }
  cluster_wait();
#ifdef PWN_AR_SAMPLER_PHASES
  if (phase_on)
    for (int k = 0; k <= NPHASES; ++k) atomicAdd(&ar_phase_cycles[k], phase_acc[k]);
#endif
}

// ---------------------------------------------------------------------------
// The wide teacher's kernel: R batch rows a cluster, the layer slices
// streamed through a ring of 8 KB chunks (the design in the comment at the
// top of this file).

constexpr int WT = NTHREADS;          // consumer threads
constexpr int W_THREADS = WT + 32;    // and one producer warp
constexpr int WIDE_CHUNK_E = 4096;    // weights a stage of the ring
constexpr int WIDE_STAGES = 16;       // the most stages the ring takes
constexpr int BAR_ALL = 1;            // named barrier of the consumer threads
constexpr int OWNER = NWARPS - 1;     // the warp that sums this rank's columns

template <typename W, typename CT, int C, int G, int S, int M, int N, int R>
struct WideDims {
  static constexpr int GH = G / 2, GN = GH / N, GC = 2 * GN, KIN = 2 * C + M, NO = C + S;
  static constexpr int LAYER_E = GC * KIN + GN * NO;  // a rank's slice of a layer
  static constexpr int VW = 16 / (int)sizeof(W);      // weights in 16 bytes
  // gate: warp w owns z values [w ZW, (w+1) ZW); lane group a (LG lanes)
  // z value w ZW + a, its tanh and sigmoid columns; lane o of the group
  // k vector o of every chunk
  static constexpr int ZW = GN / NWARPS, LG = 32 / ZW;
  static constexpr int CHUNK_E = WIDE_CHUNK_E;
  static constexpr int CHUNK_BYTES = CHUNK_E * (int)sizeof(W);  // 8 KB in bf16, 16 KB in fp32
  static constexpr int KCH = CHUNK_E / GC;             // gate rows a chunk
  static constexpr int VPL = KCH / (LG * VW);          // 16-byte vectors a lane a column
  static constexpr int TCK = C + M;                    // tap and cond rows
  static constexpr int NTC = (TCK + KCH - 1) / KCH, NX = C / KCH;
  static constexpr int KLAST = TCK - (NTC - 1) * KCH;  // rows of the last tap/cond chunk
  // out product: thread q owns outputs 2q, 2q + 1; a 16-byte vector holds
  // RV rows of its two columns; a chunk ZR rows of W_out
  static constexpr int NP = NO / 2, RV = VW / 2, ZR = CHUNK_E / NO, NOUT = GN / ZR;
  static constexpr int NCH = NTC + NX + NOUT;          // chunks a layer
  static constexpr int CP = C / 2;                     // x pairs: threads [0, CP)
  // head1: rank j its columns [j SN, (j+1) SN); thread tid column tid % SN
  // over rows part tid / SN (NPART parts of HK rows)
  static constexpr int SN = S / N, NPART = WT / SN, HK = S / NPART;
  // the split head's sends: FQ float4s a row, each to N ranks, over a warp
  static constexpr int FQ = SN / 4, HSEND = N * FQ / 32;
  static constexpr int CH = M * (int)sizeof(CT) / 16;  // 16-byte chunks of cond(t)
  // the exchange: rank k owns columns [k CN, (k+1) CN) of x (and of the
  // skip sum); NV2 float4s of them a layer, R rows
  static constexpr int CN = C / N, NV2 = R * CN / 4;
  static constexpr uint32_t XBYTES = R * C * 4;        // one layer's partials, and its x
  static constexpr uint32_t HXBYTES = R * S * 4;       // one step's split head
  // floats after the ring
  static constexpr int MP = round4(M), ZP = round4(GN);
  static constexpr int PART = 0;                       // the owned partials, N x R x CN
  static constexpr int XS = PART + R * C;              // x, R x C
  static constexpr int ZS = XS + R * C;                // z, 2 parities x R x GN
  static constexpr int CS = ZS + 2 * R * ZP;           // cond(t), R x M
  static constexpr int HS = CS + R * MP;               // relu(skip), R x S
  static constexpr int HPART = HS + R * S;             // head1 partials, R x NPART x SN
  static constexpr int HX = HPART + R * NPART * SN;    // every rank's hidden, R x S
  static constexpr int HPO = HX + R * S;               // head outputs, R x MAX_HD
  static constexpr int XPREV = HPO + R * MAX_HD;       // the samples fed back, R
  static constexpr int TAPS = XPREV + round4(R);       // then the taps, L x R x C
  // then head1's columns (S x SN) and head2 (S x HD) in the weights' type
  static_assert(GH % N == 0 && GN % NWARPS == 0 && 32 % ZW == 0, "gate split");
  static_assert(C % KCH == 0 && KLAST % VW == 0 && CHUNK_E % NO == 0 && GN % ZR == 0 &&
                    ZR % RV == 0 && VW % 4 == 0,
                "chunks");
  static_assert(GC * KCH == CHUNK_E && VPL * LG * VW == KCH, "a gate chunk fills a stage");
  static_assert(NP == WT && CP <= WT && S == C && C % (2 * N) == 0, "thread maps");
  static_assert(R == 2, "rows: a lane pair swaps halves into one row's 4 columns");
  static_assert(CN % 4 == 0 && NV2 <= 32 && 32 % NV2 == 0 && NV2 * N % 32 == 0,
                "the exchange: an owner's float4s over warp 0");
  static_assert(SN <= 32 && WT % SN == 0 && S % NPART == 0 && SN * sizeof(W) % 16 == 0 &&
                    N * FQ % 32 == 0,
                "split head: a warp's lanes over a rank's columns");
  static_assert(M * sizeof(CT) % 16 == 0 && CP + R * CH <= WT, "cond chunks");
  static_assert((LAYER_E * sizeof(W)) % 16 == 0 && (GC * TCK * sizeof(W)) % 16 == 0,
                "16-byte bulk copies");
};

// Dynamic shared memory past the ring, in bytes.
template <typename W, typename CT, int C, int G, int S, int M, int N, int R>
size_t wide_rest_bytes(int L, int HD) {
  using D = WideDims<W, CT, C, G, S, M, N, R>;
  return sizeof(float) * (size_t)(D::TAPS + L * R * C) + sizeof(W) * (size_t)S * (D::SN + HD);
}

// Chunk j of a layer's run: its offset in elements and its bytes.
template <class D>
__device__ __forceinline__ void chunk_at(int j, int& off, int& bytes) {
  constexpr int W_SIZE = D::CHUNK_BYTES / D::CHUNK_E;
  if (j < D::NTC) {
    off = j * D::CHUNK_E;
    bytes = D::GC * (j + 1 < D::NTC ? D::KCH : D::KLAST) * W_SIZE;
  } else {
    off = D::GC * D::TCK + (j - D::NTC) * D::CHUNK_E;  // x rows, then W_out
    bytes = D::CHUNK_BYTES;
  }
}

template <typename W, typename CT, int C, int G, int S, int M, int N, int R>
__global__ void __launch_bounds__(W_THREADS, 1)
ar_wide_kernel(const Args a, const Dilations dl, const int stages) {
  using D = WideDims<W, CT, C, G, S, M, N, R>;
  constexpr int VW = D::VW, LG = D::LG, ZW = D::ZW, CP = D::CP, RV = D::RV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int b0 = (int)(blockIdx.x / N) * R;  // the cluster's first row
  const int L = a.L, T = a.T, HD = a.HD, K = a.K;
  const W* w_rank = static_cast<const W*>(a.w_rank) + (size_t)rank * L * D::LAYER_E;
  const float* b_rank = a.b_rank + (size_t)rank * L * D::GC;

  extern __shared__ __align__(128) unsigned char smem[];
  const W* ring = reinterpret_cast<const W*>(smem);
  float* fsm = reinterpret_cast<float*>(smem + (size_t)stages * D::CHUNK_BYTES);
  float* part = fsm + D::PART;
  float* xs = fsm + D::XS;
  float* zs = fsm + D::ZS;
  float* cs = fsm + D::CS;
  float* hs = fsm + D::HS;
  float* hpart = fsm + D::HPART;
  float* hx = fsm + D::HX;
  float* hp = fsm + D::HPO;
  float* xprev = fsm + D::XPREV;
  float* taps = fsm + D::TAPS;
  W* head1 = reinterpret_cast<W*>(taps + L * R * C);  // S x SN: this rank's columns
  W* head2 = head1 + S * D::SN;
  __shared__ int dd[MAX_L], oo[MAX_L], slot_now[MAX_L], slot_next[MAX_L];
  __shared__ __align__(8) uint64_t full[WIDE_STAGES], empty[WIDE_STAGES];
  __shared__ __align__(8) uint64_t pbar;     // the owned partials' arrivals
  __shared__ __align__(8) uint64_t xbar;     // the owners' x (or skip sums)
  __shared__ __align__(8) uint64_t hbar;     // the split head's arrivals

#ifdef PWN_AR_SAMPLER_PHASES
  const bool phase_on = blockIdx.x == 0 && tid == 32 * OWNER;
  unsigned long long phase_acc[NPHASES + 1] = {};
  long long phase_t = clock64();
#endif

  // -- once: the barriers, the dilations, the head's weights, zero taps,
  //    cond(0), x_prev
  const long long n_layers = (long long)T * L;  // layers over all steps
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), NWARPS);
    }
    for (uint64_t* bar : {&pbar, &xbar}) {
      mbar_init(smem_u32(bar), 1);
      mbar_expect_tx(smem_u32(bar), D::XBYTES);
    }
    mbar_init(smem_u32(&hbar), 1);
    mbar_expect_tx(smem_u32(&hbar), D::HXBYTES);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int l = tid; l < L; l += W_THREADS) {
    dd[l] = dl.d[l];
    oo[l] = dl.off[l];
  }
  {
    // head1's columns [rank SN, (rank+1) SN) of every row: RC 16-byte chunks
    // a row out of the row's RS
    constexpr int RC = D::SN * (int)sizeof(W) / 16, RS = S * (int)sizeof(W) / 16;
    const uint4* src1 = static_cast<const uint4*>(a.head1_k) + rank * RC;
    const uint4* src2 = static_cast<const uint4*>(a.head2_k);
    uint4* dst1 = reinterpret_cast<uint4*>(head1);
    uint4* dst2 = reinterpret_cast<uint4*>(head2);
    const int n1 = S * RC, n2 = S * HD * (int)sizeof(W) / 16;
    for (int i = tid; i < n1; i += W_THREADS) dst1[i] = __ldg(src1 + (i / RC) * RS + i % RC);
    for (int i = tid; i < n2; i += W_THREADS) dst2[i] = __ldg(src2 + i);
  }
  // row r of the cluster: batch row b0 + r; a row past B (the last cluster
  // of a batch that R does not divide) reads row B - 1's cond and noise and
  // writes nothing
  const char* cond_row[R];
  float* queue_row[R];
  bool valid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    valid[r] = b0 + r < a.B;
    const int br = valid[r] ? b0 + r : a.B - 1;
    cond_row[r] = static_cast<const char*>(a.cond) + (size_t)br * T * M * sizeof(CT);
    queue_row[r] = a.queue + (size_t)br * a.sum_d * C;
  }
  for (int i = tid; i < L * R * C; i += W_THREADS) taps[i] = 0.f;
  for (int i = tid; i < R * M; i += W_THREADS)
    cs[(i / M) * D::MP + i % M] = to_f32(reinterpret_cast<const CT*>(cond_row[i / M])[i % M]);
  if (tid < R) xprev[tid] = 0.f;
  __syncthreads();
  // every block of the cluster has started before any writes into another's
  // shared memory
  cluster_arrive();
  cluster_wait();

  if (warp == NWARPS) {
    // -- the producer warp: lane 0 streams every layer's chunks through the
    //    ring, each into a stage its 8 consumer warps have released; every
    //    lane takes its part in the step's cluster barrier (after issuing
    //    the step's chunks, so the stream runs across the step's end)
    int s = 0;
    uint32_t ph = 0;
    bool first = true;
    for (int t = 0; t < T; ++t) {
      if (lane == 0)
        for (int l = 0; l < L; ++l) {
          const W* src = w_rank + (size_t)l * D::LAYER_E;
          for (int j = 0; j < D::NCH; ++j) {
            if (!first) mbar_wait(smem_u32(&empty[s]), ph);
            int off, bytes;
            chunk_at<D>(j, off, bytes);
            mbar_expect_tx(smem_u32(&full[s]), bytes);
            bulk_load(smem_u32(ring + s * D::CHUNK_E), src + off, bytes, smem_u32(&full[s]));
            if (++s == stages) {
              s = 0;
              if (!first) ph ^= 1;
              first = false;
            }
          }
        }
      __syncwarp();
      if (t > 0) cluster_wait();
      cluster_arrive();
    }
    cluster_wait();
    return;
  }

  // -- the consumers
  // gate: lane group a, z value zi, its columns ct (tanh) and ct + ZW
  // (sigmoid) in the packed order, k vector o of each chunk
  const int ga = lane / LG, o = lane % LG;
  const int zi = warp * ZW + ga, ct = warp * 2 * ZW + ga;
  const bool xo = tid < CP;  // owns x pair tid: rows 2 tid, 2 tid + 1
  const int qs = tid - CP;   // tid >= CP: skip pair qs
  float fk[2] = {0.f, 0.f}, fb[2] = {0.f, 0.f};
  if (xo)
    for (int e = 0; e < 2; ++e) {
      fk[e] = to_f32(static_cast<const W*>(a.front_k)[2 * tid + e]);
      fb[e] = a.front_b[2 * tid + e];
    }
  // warp OWNER, lane v < NV2: this rank's float4 v of the owned columns,
  // row orow, columns ocol .. ocol + 3; the skip biases summed over the
  // layers
  const int orow = (lane % D::NV2) / (D::CN / 4);
  const int ocol = rank * D::CN + 4 * ((lane % D::NV2) % (D::CN / 4));
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};
  if (warp == OWNER && lane < D::NV2)
    for (int e = 0; e < 4; ++e)
      for (int l = 0; l < L; ++l) bsum[e] += a.b_rs[l * D::NO + C + ocol + e];
  // the split head's destinations (warps r < R: lane's ranks lane / FQ +
  // 32 / FQ i)
  uint32_t hx_at[D::HSEND], hbar_at[D::HSEND];
#pragma unroll
  for (int i = 0; i < D::HSEND; ++i) {
    hx_at[i] = mapa(smem_u32(hx), lane / D::FQ + 32 / D::FQ * i);
    hbar_at[i] = mapa(smem_u32(&hbar), lane / D::FQ + 32 / D::FQ * i);
  }
  float skip_part[2][R];  // tid >= CP: this rank's skip partials of pair qs
#pragma unroll
  for (int r = 0; r < R; ++r) skip_part[0][r] = skip_part[1][r] = 0.f;
  int rs = 0;             // the ring: the stage of the next chunk,
  uint32_t rph = 0;       // and the parity of its full barrier's phase
  long long c = 0;        // layers so far, over all steps: the exchange's phases

  // The ring: wait for the next chunk (PHASE(ph) before, PHASE(1) after),
  // returning its stage; release a stage once this warp has read it.
  auto wait_chunk = [&](int ph) {
    PHASE(ph);
    mbar_spin(smem_u32(&full[rs]), rph);
    PHASE(1);
    const int s = rs;
    if (++rs == stages) {
      rs = 0;
      rph ^= 1;
    }
    return s;
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  };
  // The gate product over a layer's NC chunks of tap and cond rows (tapl:
  // the layer's taps; then cond) or of x rows (tapl null: xs), added into
  // acc[col][row][half].  Software-pipelined: chunk j + 1's weights and
  // inputs are loaded while chunk j's FMAs run.  Lane o's vectors of a
  // column are gv = o + LG v (v < VPL); weight e = 4h + i of vector gv is
  // row 4 (h kc / VW + gv) + i of the chunk (the packing's order), so the
  // lanes' 16-byte input reads cover consecutive addresses.
  float acc[2][R][2];
  struct GateOps {
    uint4 wt[D::VPL], ws[D::VPL];
    float4 in[R][D::VPL][VW / 4];
    int kc;
  };
  auto gate_fetch = [&](GateOps& g, int s, int j, const float* tapl) {
    const int kc = tapl && j + 1 == D::NTC ? D::KLAST : D::KCH;
    const float* in = !tapl ? xs + j * D::KCH : j * D::KCH < C ? tapl + j * D::KCH
                                                               : cs + (j * D::KCH - C);
    const int stride = tapl && j * D::KCH >= C ? D::MP : C;
    const W* ck = ring + s * D::CHUNK_E;
    g.kc = kc;
#pragma unroll
    for (int v = 0; v < D::VPL; ++v) {
      const int gv = o + LG * v;
      if (gv * VW < kc) {
        g.wt[v] = *reinterpret_cast<const uint4*>(ck + ct * kc + gv * VW);
        g.ws[v] = *reinterpret_cast<const uint4*>(ck + (ct + ZW) * kc + gv * VW);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int h = 0; h < VW / 4; ++h)
            g.in[r][v][h] =
                *reinterpret_cast<const float4*>(in + r * stride + 4 * (h * (kc / VW) + gv));
      }
    }
  };
  auto gate_fma = [&](const GateOps& g) {
#pragma unroll
    for (int v = 0; v < D::VPL; ++v)
      if ((o + LG * v) * VW < g.kc) {
        float wt[VW], wsg[VW];
        Vec<W>::to_f32(g.wt[v], wt);
        Vec<W>::to_f32(g.ws[v], wsg);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const float4 f = g.in[r][v][e / 4];
            const float x = e % 4 == 0 ? f.x : e % 4 == 1 ? f.y : e % 4 == 2 ? f.z : f.w;
            acc[0][r][e & 1] = fmaf(x, wt[e], acc[0][r][e & 1]);
            acc[1][r][e & 1] = fmaf(x, wsg[e], acc[1][r][e & 1]);
          }
      }
  };
  auto gate_chunks = [&](auto nc, const float* tapl, int ph) {
    constexpr int NC = decltype(nc)::value;
    GateOps g[2];
    int s = wait_chunk(ph);
    gate_fetch(g[0], s, 0, tapl);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      int s_next = 0;
      if (j + 1 < NC) {
        s_next = wait_chunk(ph);
        gate_fetch(g[(j + 1) & 1], s_next, j + 1, tapl);
      }
      gate_fma(g[j & 1]);
      release(s);
      s = s_next;
    }
  };
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[i][r][0] = acc[i][r][1] = 0.f;
  };

  for (int t = 0; t < T; ++t) {
    // -- step start: the queue slots, the front 1x1, layer 0's gate product
    //    over its tap and cond rows
    float u = 0.f;
    uint4 cond_next = make_uint4(0u, 0u, 0u, 0u);
    for (int l = tid; l < L; l += WT) {
      slot_now[l] = oo[l] + t % dd[l];
      slot_next[l] = oo[l] + (t + 1) % dd[l];
    }
    if (xo)
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float2*>(xs + r * C + 2 * tid) =
            make_float2(__fadd_rn(__fmul_rn(xprev[r], fk[0]), fb[0]),
                        __fadd_rn(__fmul_rn(xprev[r], fk[1]), fb[1]));
    PHASE(0);
    zero_acc();
    gate_chunks(std::integral_constant<int, D::NTC>{}, taps, 2);
    PHASE(2);
    named_sync(BAR_ALL, WT);

    for (int l = 0; l < L; ++l, ++c) {
      const bool last = l + 1 == L;
      // gate product over the x rows; the gated unit in lanes o < R of
      // each group (row o)
      gate_chunks(std::integral_constant<int, D::NX>{}, nullptr, 4);
      float g[2][R];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v = acc[i][r][0] + acc[i][r][1];
#pragma unroll
          for (int m = LG / 2; m > 0; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
          g[i][r] = v;
        }
      {
        const float bga = __ldg(b_rank + l * D::GC + zi);
        const float bgb = __ldg(b_rank + l * D::GC + D::GN + zi);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (o == r) {
            const float ga_ = bga + g[0][r], gb_ = bgb + g[1][r];
            zs[((c & 1) * R + r) * D::ZP + zi] = tanhf(ga_) * (1.f / (1.f + expf(-gb_)));
          }
      }
      PHASE(4);
      named_sync(BAR_ALL, WT);
      // the queue's writes of the step before are visible from here on
      if (l == 0 && t > 0) cluster_wait();
      // x pair owners: layer l's tap of step t+1 (its queue slot, landing by
      // the exchange's end, or x itself where d = 1); x_0 into its slot
      float2 pend[R];
      if (xo) {
        const bool mine = 2 * tid / (C / N) == rank;  // this rank's queue columns
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float2* tap = reinterpret_cast<float2*>(taps + (l * R + r) * C) + tid;
          const float2 x = reinterpret_cast<const float2*>(xs + r * C)[tid];
          if (dd[l] > 1) {
            if (valid[r])
              pend[r] = __ldcg(reinterpret_cast<const float2*>(queue_row[r] + (size_t)slot_next[l] * C) + tid);
            if (l == 0 && mine && valid[r])
              __stcg(reinterpret_cast<float2*>(queue_row[r] + (size_t)slot_now[0] * C) + tid, x);
          } else {
            *tap = x;
          }
        }
      }
      // out product: outputs 2 tid, 2 tid + 1 over this rank's z rows, ZR
      // rows a chunk, pipelined as the gate product
      float p[2][R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) p[0][r][0] = p[1][r][0] = p[0][r][1] = p[1][r][1] = 0.f;
      {
        constexpr int NV = D::ZR / RV;  // vectors a chunk
        uint4 w[2][NV];
        int s = wait_chunk(5);
#pragma unroll
        for (int gq = 0; gq < NV; ++gq)
          w[0][gq] = *reinterpret_cast<const uint4*>(ring + s * D::CHUNK_E + (gq * D::NP + tid) * VW);
#pragma unroll
        for (int j = 0; j < D::NOUT; ++j) {
          int s_next = 0;
          if (j + 1 < D::NOUT) {
            s_next = wait_chunk(5);
#pragma unroll
            for (int gq = 0; gq < NV; ++gq)
              w[(j + 1) & 1][gq] = *reinterpret_cast<const uint4*>(ring + s_next * D::CHUNK_E +
                                                                   (gq * D::NP + tid) * VW);
          }
#pragma unroll
          for (int gq = 0; gq < NV; ++gq) {
            float wf[VW];
            Vec<W>::to_f32(w[j & 1][gq], wf);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float z[RV];
              const float* zp = zs + ((c & 1) * R + r) * D::ZP + j * D::ZR + gq * RV;
              if constexpr (RV == 4) {
                const float4 f = *reinterpret_cast<const float4*>(zp);
                z[0] = f.x; z[1] = f.y; z[2] = f.z; z[3] = f.w;
              } else {
                const float2 f = *reinterpret_cast<const float2*>(zp);
                z[0] = f.x; z[1] = f.y;
              }
#pragma unroll
              for (int i = 0; i < RV; ++i) {
                p[0][r][gq & 1] = fmaf(z[i], wf[2 * i], p[0][r][gq & 1]);
                p[1][r][gq & 1] = fmaf(z[i], wf[2 * i + 1], p[1][r][gq & 1]);
              }
            }
          }
          release(s);
          s = s_next;
        }
      }
      PHASE(5);
      // the exchange, reduce-scatter then broadcast: each residual partial
      // (at the last layer the skip partials, summed over the layers) goes to
      // the rank that owns its columns; lanes 2m and 2m + 1 swap halves, so
      // that lane 2m + r holds row r of columns 4m .. 4m + 3, one st.async
      // a lane into the owner's part [source rank][row][CN]
      float ps[2][R];  // the halves summed
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ps[0][r] = p[0][r][0] + p[0][r][1];
        ps[1][r] = p[1][r][0] + p[1][r][1];
      }
      if (!xo)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          skip_part[0][r] += ps[0][r];
          skip_part[1][r] += ps[1][r];
        }
      if (last ? !xo : xo) {  // warp-uniform
        const int q = last ? qs : tid;  // pair q: columns 2q, 2q + 1
        float v[2][R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[0][r] = last ? skip_part[0][r] : ps[0][r];
          v[1][r] = last ? skip_part[1][r] : ps[1][r];
        }
        const int odd = lane & 1;
        const float g0 = __shfl_xor_sync(FULL, odd ? v[0][0] : v[0][1], 1);
        const float g1 = __shfl_xor_sync(FULL, odd ? v[1][0] : v[1][1], 1);
        const float4 f = odd ? make_float4(g0, g1, v[0][1], v[1][1])
                             : make_float4(v[0][0], v[1][0], g0, g1);
        const int col = 4 * (q >> 1), owner = col / D::CN;
        st_async(mapa(smem_u32(part + (rank * R + odd) * D::CN + col % D::CN), owner), f,
                 mapa(smem_u32(&pbar), owner));
      }
      if (last && !xo)
#pragma unroll
        for (int r = 0; r < R; ++r) skip_part[0][r] = skip_part[1][r] = 0.f;
      if (l == 0) {
        if (warp < R && lane < a.NZ)
          u = __ldg(a.noise + ((size_t)t * a.B + (valid[warp] ? b0 + warp : a.B - 1)) * a.NZ + lane);
        if (tid >= CP && tid < CP + R * D::CH && t + 1 < T) {
          const int r = (tid - CP) / D::CH;
          cond_next = __ldg(reinterpret_cast<const uint4*>(cond_row[r] + (size_t)(t + 1) * M * sizeof(CT)) +
                            (tid - CP) % D::CH);
        }
      }
      PHASE(6);
      if (warp == OWNER) {
        // this rank's columns: every rank's partials, summed in rank order;
        // x (at the last layer relu of the skip sum) to every rank
        float4 brs = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!last && lane < D::NV2) brs = __ldg(reinterpret_cast<const float4*>(a.b_rs + l * D::NO + ocol));
        mbar_spin_cluster(smem_u32(&pbar), (uint32_t)(c & 1));
        if (lane == 0 && c + 1 < n_layers) mbar_expect_tx(smem_u32(&pbar), D::XBYTES);
        PHASE(7);
        float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
        if (lane < D::NV2) {
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float4 v =
                *reinterpret_cast<const float4*>(part + (j * R + orow) * D::CN + ocol % D::CN);
            sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
          }
          if (!last) {
            const float4 x = *reinterpret_cast<const float4*>(xs + orow * C + ocol);
            res = make_float4(x.x + (brs.x + sum.x), x.y + (brs.y + sum.y), x.z + (brs.z + sum.z),
                              x.w + (brs.w + sum.w));
            if (dd[l + 1] > 1 && valid[orow])
              __stcg(reinterpret_cast<float4*>(queue_row[orow] + (size_t)slot_now[l + 1] * C + ocol), res);
          } else {
            res = make_float4(fmaxf(bsum[0] + sum.x, 0.f), fmaxf(bsum[1] + sum.y, 0.f),
                              fmaxf(bsum[2] + sum.z, 0.f), fmaxf(bsum[3] + sum.w, 0.f));
          }
        }
        // lane l sends float4 l % NV2 to ranks l / NV2 + (32 / NV2) i
        const int src = lane % D::NV2;
        const float4 f = make_float4(__shfl_sync(FULL, res.x, src), __shfl_sync(FULL, res.y, src),
                                     __shfl_sync(FULL, res.z, src), __shfl_sync(FULL, res.w, src));
        float* dst = (last ? hs : xs) + orow * C + ocol;
#pragma unroll
        for (int i = 0; i < D::NV2 * N / 32; ++i) {
          const int rk = lane / D::NV2 + 32 / D::NV2 * i;
          st_async(mapa(smem_u32(dst), rk), f, mapa(smem_u32(&xbar), rk));
        }
        PHASE(3);
      }
      // while the owners' sums land: the next layer's tap and cond rows
      if (!last) {
        zero_acc();
        gate_chunks(std::integral_constant<int, D::NTC>{}, taps + (l + 1) * R * C, 2);
        PHASE(2);
      }
      if (xo && dd[l] > 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
          reinterpret_cast<float2*>(taps + (l * R + r) * C)[tid] = valid[r] ? pend[r]
                                                                           : make_float2(0.f, 0.f);
      // x_{l+1} (or relu(skip)) is whole here
      mbar_spin_cluster(smem_u32(&xbar), (uint32_t)(c & 1));
      if (tid == 0 && c + 1 < n_layers) mbar_expect_tx(smem_u32(&xbar), D::XBYTES);
      PHASE(7);
    }

    // -- head: relu (above), 1x1, relu, 1x1, in every rank: rank j forms the
    //    hidden values [j SN, (j+1) SN) of each row and sends them to every
    //    rank, so every rank holds the same S values a row in hx
    {
      const int n = tid % D::SN, kp = tid / D::SN;
      float v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = 0.f;
#pragma unroll 8
      for (int k = kp * D::HK; k < (kp + 1) * D::HK; ++k) {
        const float w = to_f32(head1[k * D::SN + n]);
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = fmaf(hs[r * S + k], w, v[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) hpart[(r * D::NPART + kp) * D::SN + n] = v[r];
    }
    named_sync(BAR_ALL, WT);
    if (warp < R) {  // row warp; lane < SN: column rank SN + lane
      const int r = warp;
      float h = 0.f;
      if (lane < D::SN) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < D::NPART; ++k) v += hpart[(r * D::NPART + k) * D::SN + lane];
        h = fmaxf(a.head1_b[rank * D::SN + lane] + v, 0.f);
      }
      const int f = lane % D::FQ;
      const float4 hv = make_float4(__shfl_sync(FULL, h, 4 * f), __shfl_sync(FULL, h, 4 * f + 1),
                                    __shfl_sync(FULL, h, 4 * f + 2),
                                    __shfl_sync(FULL, h, 4 * f + 3));
      const uint32_t off = 4 * (r * S + rank * D::SN + 4 * f);
#pragma unroll
      for (int i = 0; i < D::HSEND; ++i) st_async(hx_at[i] + off, hv, hbar_at[i]);
    }
    // every rank's hidden values have landed here: arm the next step's
    mbar_spin_cluster(smem_u32(&hbar), (uint32_t)(t & 1));
    if (tid == 0 && t + 1 < T) mbar_expect_tx(smem_u32(&hbar), D::HXBYTES);
    {
      constexpr int NJ = MAX_HD / NWARPS;  // columns warp, warp + NWARPS, ...
      float v[NJ][R];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r) v[j][r] = 0.f;
#pragma unroll
      for (int k = lane; k < S; k += 32) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = warp + NWARPS * j;
          if (n < HD) {
            const float w = to_f32(head2[k * HD + n]);
#pragma unroll
            for (int r = 0; r < R; ++r) v[j][r] = fmaf(hx[r * S + k], w, v[j][r]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = warp + NWARPS * j;
        if (n < HD)  // warp-uniform
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float s = warp_sum(v[j][r]);
            if (lane == 0) hp[r * MAX_HD + n] = a.head2_b[n] + s;
          }
      }
    }
    named_sync(BAR_ALL, WT);

    // -- the sample of row r (warp r of every rank); cond(t+1) lands
    if (warp < R) {
      const int r = warp;
      const float* hq = hp + r * MAX_HD;
      float xt;
      if (a.gaussian) {
        const float eps = __shfl_sync(FULL, u, 0);
        const float ls = fmaxf(hq[1], a.log_scale_min);
        xt = hq[0] + expf(ls) * a.temperature * eps;
      } else {
        const float score = lane < K ? hq[lane] - logf(-logf(u)) : -INFINITY;
        const float best = warp_max(score);
        const bool pick = lane < K && score >= best;
        const int count = __popc(__ballot_sync(FULL, pick));
        const float wgt = pick ? 1.f / (float)count : 0.f;
        const float mean = warp_sum(lane < K ? hq[K + lane] * wgt : 0.f);
        const float ls = warp_sum(lane < K ? fmaxf(hq[2 * K + lane], a.log_scale_min) * wgt : 0.f);
        const float ul = __shfl_sync(FULL, u, K);
        xt = mean + expf(ls) * a.temperature * (logf(ul) - log1pf(-ul));
      }
      xt = fminf(fmaxf(xt, -1.f), 1.f);
      if (lane == 0) {
        xprev[r] = xt;
        if (rank == 0 && valid[r]) a.wav[(size_t)(b0 + r) * T + t] = xt;
#ifdef PWN_AR_SAMPLER_CHECK
        if (valid[r]) a.wav_ranks[((size_t)rank * a.B + b0 + r) * T + t] = xt;
#endif
      }
    }
    if (tid >= CP && tid < CP + R * D::CH) {
      const int r = (tid - CP) / D::CH, i = (tid - CP) % D::CH;
      Vec<CT>::to_f32(cond_next, cs + r * D::MP + i * Vec<CT>::N);
    }
    // this step's queue reads and writes are done (release)
    cluster_arrive();
    named_sync(BAR_ALL, WT);
    PHASE(8);
#ifdef PWN_AR_SAMPLER_PHASES
    if (phase_on) ++phase_acc[NPHASES];
#endif
  }
  cluster_wait();
#ifdef PWN_AR_SAMPLER_PHASES
  if (phase_on)
    for (int k = 0; k <= NPHASES; ++k) atomicAdd(&ar_phase_cycles[k], phase_acc[k]);
#endif
}

template <typename W, typename CT, int C, int G, int S, int M, int N>
cudaError_t launch_config(const Args& a, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes<W, CT, C, G, S, M, N>(a.L, a.HD);
  cudaError_t err = cudaFuncSetAttribute(ar_sampler_kernel<W, CT, C, G, S, M, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = N;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(a.B * N);
  cfg->blockDim = dim3(NTHREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// What a launch looks like: rows a cluster, blocks a cluster, ring stages
// and dynamic shared memory, and how many of its clusters the card holds
// at once.
struct Geometry {
  int rows, ranks, stages, smem, clusters;
};

// Launches the kernel, or only fills *geo (when geo is not null).
template <typename W, typename CT, int C, int G, int S, int M, int N>
int launch(const Args& a, const Dilations& dl, cudaStream_t stream, Geometry* geo) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = launch_config<W, CT, C, G, S, M, N>(a, &cfg, &attr, stream);
  if (err != cudaSuccess) return err;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, ar_sampler_kernel<W, CT, C, G, S, M, N>, &cfg);
  if (err != cudaSuccess) return err;
  if (geo) {
    *geo = {1, N, Dims<W, CT, C, G, S, M, N>::STAGES, (int)cfg.dynamicSmemBytes, fit};
    return cudaSuccess;
  }
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, ar_sampler_kernel<W, CT, C, G, S, M, N>, a, dl);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The wide kernel: as many ring stages as the shared memory left by the
// rest (its taps grow with L) holds, up to WIDE_STAGES; fewer than 2 is an
// error.
template <typename W, typename CT, int C, int G, int S, int M, int N, int R>
int launch_wide(const Args& a, const Dilations& dl, cudaStream_t stream, Geometry* geo) {
  auto kernel = ar_wide_kernel<W, CT, C, G, S, M, N, R>;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const long long rest = (long long)wide_rest_bytes<W, CT, C, G, S, M, N, R>(a.L, a.HD);
  const long long room = (long long)optin - (long long)fa.sharedSizeBytes - rest;
  constexpr int CB = WideDims<W, CT, C, G, S, M, N, R>::CHUNK_BYTES;
  const int stages = (int)(room / CB < WIDE_STAGES ? room / CB : WIDE_STAGES);
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = (size_t)stages * CB + (size_t)rest;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && N > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = N;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.B + R - 1) / R * N);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (geo) {
    *geo = {R, N, stages, (int)smem, fit};
    return cudaSuccess;
  }
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, a, dl, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C, int G, int S, int M, int N>
int launch_dims(const Args& a, const Dilations& dl, int weights_bf16, int cond_bf16,
                cudaStream_t st, Geometry* geo) {
  if (weights_bf16)
    return cond_bf16 ? launch<bf16, bf16, C, G, S, M, N>(a, dl, st, geo)
                     : launch<bf16, float, C, G, S, M, N>(a, dl, st, geo);
  return cond_bf16 ? launch<float, bf16, C, G, S, M, N>(a, dl, st, geo)
                   : launch<float, float, C, G, S, M, N>(a, dl, st, geo);
}

template <int C, int G, int S, int M, int N, int R>
int launch_wide_dims(const Args& a, const Dilations& dl, int weights_bf16, int cond_bf16,
                     cudaStream_t st, Geometry* geo) {
  if (weights_bf16)
    return cond_bf16 ? launch_wide<bf16, bf16, C, G, S, M, N, R>(a, dl, st, geo)
                     : launch_wide<bf16, float, C, G, S, M, N, R>(a, dl, st, geo);
  return cond_bf16 ? launch_wide<float, bf16, C, G, S, M, N, R>(a, dl, st, geo)
                   : launch_wide<float, float, C, G, S, M, N, R>(a, dl, st, geo);
}

constexpr int RANKS = 8;        // blocks per cluster
constexpr int WIDE_RANKS = 16;  // blocks per cluster of the wide kernel
constexpr int WIDE_ROWS = 2;    // batch rows per cluster of the wide kernel

int run(const Args& a, const int* dilations, int c, int g, int s, int m, int hd, int k,
        int gaussian, int weights_bf16, int cond_bf16, int n_ranks, cudaStream_t st,
        Geometry* geo) {
  const bool teacher_lj = c == 128 && g == 256 && s == 128 && m == 80;
  const bool tiny = c == 64 && g == 128 && s == 64 && m == 40;
  const bool wide = c == 256 && g == 512 && s == 256 && m == 80;
  if (!(teacher_lj || tiny || wide) || n_ranks != (wide ? WIDE_RANKS : RANKS) || a.B < 1 ||
      a.T < 1 || a.L < 1 || a.L > MAX_L)
    return cudaErrorInvalidValue;
  if (gaussian ? hd != 2 : (k < 1 || hd != 3 * k || hd > MAX_HD))
    return cudaErrorInvalidValue;
  Dilations dl;
  int sum_d = 0;
  for (int l = 0; l < MAX_L; ++l) {
    dl.d[l] = 1;
    dl.off[l] = 0;
  }
  for (int l = 0; l < a.L; ++l) {
    if (dilations[l] < 1) return cudaErrorInvalidValue;
    dl.d[l] = dilations[l];
    dl.off[l] = sum_d;
    sum_d += dilations[l];
  }
  Args args = a;
  args.sum_d = sum_d;
  if (teacher_lj)
    return launch_dims<128, 256, 128, 80, RANKS>(args, dl, weights_bf16, cond_bf16, st, geo);
  if (wide)
    return launch_wide_dims<256, 512, 256, 80, WIDE_RANKS, WIDE_ROWS>(args, dl, weights_bf16,
                                                                       cond_bf16, st, geo);
  return launch_dims<64, 128, 64, 40, RANKS>(args, dl, weights_bf16, cond_bf16, st, geo);
}

// ---------------------------------------------------------------------------
// The one-block body: any (C, G, S, M), head width HD and K, any number of
// layers, one block a batch row, the weights read from L2 every step.  It
// runs only the widths whose exchange buffer the cluster body below cannot
// hold (`ar_body` picks it on the widths alone: "block"; the design note at
// the top of this file, last item).

constexpr int BLK_THREADS = 512;  // 16 warps
constexpr int BLK_MAX_PARTS = 32;  // k parts of a product, at most
constexpr int BLK_VEC_MAX = 8;    // weights in one 16-byte load (bf16)

struct BlockArgs {
  const void* cond;      // (B, T, M) bf16 or fp32
  const float* noise;    // (T, B, NZ)
  const void* front_k;   // (1, C)
  const float* front_b;  // (1, C)
  const void* w_in;      // (L, 2C+M, G), `stack_teacher_weights`' layout
  const float* b_g;      // (L, G)
  const void* w_out;     // (L, G/2, C+S)
  const float* b_rs;     // (L, C+S)
  const void* head1_k;   // (S, S)
  const float* head1_b;  // (1, S)
  const void* head2_k;   // (S, HD)
  const float* head2_b;  // (1, HD)
  const int* dil;        // (2, L) on the card: the dilations, then the queue offsets
  float* queue;          // (B, sum(d), C), zero on entry
  float* wav;            // (B, T)
  int B, T, L, C, G, S, M, HD, K, NZ, sum_d, gaussian;
  float log_scale_min, temperature;
};

// Weights a thread loads at once from a row of n weights of `wbytes` bytes:
// a 16-byte vector where the row is whole vectors, else one.
__host__ __device__ inline int blk_vec(int n, int wbytes) {
  return n % (16 / wbytes) == 0 ? 16 / wbytes : 1;
}

// The k parts of a product with n output columns, v a load: the threads
// over the n / v column vectors, the rest of them over k.
__host__ __device__ inline int blk_parts(int n, int v) {
  const int nv = n / v;
  if (nv >= BLK_THREADS) return 1;
  return BLK_THREADS / nv < BLK_MAX_PARTS ? BLK_THREADS / nv : BLK_MAX_PARTS;
}

// Floats of shared memory: the fed-back sample, [x | tap | cond(t)], z,
// skip, relu(skip), the head's hidden, its output, and the products'
// partials (parts x columns, at most BLK_THREADS x BLK_VEC_MAX below
// BLK_THREADS vectors, else the columns themselves).
__host__ __device__ inline long long blk_smem_floats(int c, int g, int s, int m, int hd) {
  int n = g > c + s ? g : c + s;
  n = n > hd ? n : hd;
  const int part = n > BLK_THREADS * BLK_VEC_MAX ? n : BLK_THREADS * BLK_VEC_MAX;
  return 1 + (long long)(2 * c + m) + g / 2 + 3LL * s + hd + part;
}

template <typename W, int V>
__device__ __forceinline__ void load_w(const W* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(W) == 16, "one 16-byte vector");
    Vec<W>::to_f32(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
}

// The partials of y = x @ w (x: k_len floats in shared memory; w: (k_len,
// n) row-major, read from global memory through L2) into part[kp * n + col]
// for kp < blk_parts(n, V): thread t takes column vector t % (n / V) and
// rows kp, kp + P, ... (kp = t / (n / V)), or, with as many vectors as
// threads, vectors t, t + BLK_THREADS, ... over every row.
template <typename W, int V>
__device__ __forceinline__ void blk_product_v(const float* x, int k_len, int n, const W* w,
                                              float* part) {
  const int nv = n / V, tid = threadIdx.x, P = blk_parts(n, V);
  const bool wide = nv >= BLK_THREADS;
  const int kp = wide ? 0 : tid / nv;
  if (kp >= P) return;
  for (int cv = wide ? tid : tid % nv; cv < nv; cv += BLK_THREADS) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    const W* col = w + (size_t)cv * V;
#pragma unroll 4
    for (int k = kp; k < k_len; k += P) {
      float wv[V];
      load_w<W, V>(col + (size_t)k * n, wv);
      const float xk = x[k];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(xk, wv[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) part[kp * n + cv * V + e] = acc[e];
  }
}

template <typename W>
__device__ __forceinline__ int blk_product(const float* x, int k_len, int n, const W* w,
                                           float* part) {
  constexpr int VW = 16 / sizeof(W);
  if (blk_vec(n, sizeof(W)) == VW) {
    blk_product_v<W, VW>(x, k_len, n, w, part);
    return blk_parts(n, VW);
  }
  blk_product_v<W, 1>(x, k_len, n, w, part);
  return blk_parts(n, 1);
}

// Column j of a product's partials, summed in part order.
__device__ __forceinline__ float blk_sum(const float* part, int n, int parts, int j) {
  float v = part[j];
  for (int p = 1; p < parts; ++p) v += part[p * n + j];
  return v;
}

template <typename W, typename CT>
__global__ void __launch_bounds__(BLK_THREADS, 1) ar_block_kernel(const BlockArgs a) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int C = a.C, G = a.G, S = a.S, M = a.M, HD = a.HD, K = a.K, L = a.L, T = a.T;
  const int GH = G / 2, KIN = 2 * C + M, NO = C + S;
  const W* w_in = static_cast<const W*>(a.w_in);
  const W* w_out = static_cast<const W*>(a.w_out);
  const W* front_k = static_cast<const W*>(a.front_k);
  const CT* cond = static_cast<const CT*>(a.cond) + (size_t)b * T * M;
  float* queue = a.queue + (size_t)b * a.sum_d * C;

  // all of it dynamic, so a block takes the whole opt-in size
  extern __shared__ __align__(16) float bsm[];
  float* x_prev = bsm;     // the fed-back sample
  float* cat = bsm + 1;    // [x | tap | cond(t)]
  float* z = cat + KIN;    // G/2
  float* skip = z + GH;    // S
  float* hs = skip + S;    // relu(skip), S
  float* h1 = hs + S;      // the head's hidden, S
  float* hp = h1 + S;      // the head's output, HD
  float* part = hp + HD;   // the products' partials
  if (tid == 0) *x_prev = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // the front 1x1 (no FMA, as the plain version), cond(t), a zero skip
    const float xp = *x_prev;
    for (int i = tid; i < C; i += BLK_THREADS)
      cat[i] = __fadd_rn(__fmul_rn(xp, to_f32(front_k[i])), a.front_b[i]);
    for (int m = tid; m < M; m += BLK_THREADS) cat[2 * C + m] = to_f32(cond[(size_t)t * M + m]);
    for (int s = tid; s < S; s += BLK_THREADS) skip[s] = 0.f;
    for (int l = 0; l < L; ++l) {
      // the tap, read before its slot takes x (thread i owns element i of
      // every slot, so the queue needs no barrier of its own)
      const int slot = __ldg(a.dil + L + l) + t % __ldg(a.dil + l);
      float* q = queue + (size_t)slot * C;
      for (int i = tid; i < C; i += BLK_THREADS) {
        cat[C + i] = q[i];
        q[i] = cat[i];
      }
      __syncthreads();
      const float* bg = a.b_g + (size_t)l * G;
      const int pg = blk_product<W>(cat, KIN, G, w_in + (size_t)l * KIN * G, part);
      __syncthreads();
      for (int j = tid; j < GH; j += BLK_THREADS) {
        const float ga = blk_sum(part, G, pg, j) + bg[j];
        const float gb = blk_sum(part, G, pg, GH + j) + bg[GH + j];
        z[j] = tanhf(ga) * (1.f / (1.f + expf(-gb)));
      }
      __syncthreads();
      const float* brs = a.b_rs + (size_t)l * NO;
      const int po = blk_product<W>(z, GH, NO, w_out + (size_t)l * GH * NO, part);
      __syncthreads();
      for (int n = tid; n < NO; n += BLK_THREADS) {
        const float o = blk_sum(part, NO, po, n) + brs[n];
        if (n < C)
          cat[n] = cat[n] + o;
        else
          skip[n - C] = skip[n - C] + o;
      }
      __syncthreads();
    }

    // the head: relu, 1x1, relu, 1x1
    for (int s = tid; s < S; s += BLK_THREADS) hs[s] = fmaxf(skip[s], 0.f);
    __syncthreads();
    const int p1 = blk_product<W>(hs, S, S, static_cast<const W*>(a.head1_k), part);
    __syncthreads();
    for (int n = tid; n < S; n += BLK_THREADS)
      h1[n] = fmaxf(blk_sum(part, S, p1, n) + a.head1_b[n], 0.f);
    __syncthreads();
    const int p2 = blk_product<W>(h1, S, HD, static_cast<const W*>(a.head2_k), part);
    __syncthreads();
    for (int n = tid; n < HD; n += BLK_THREADS) hp[n] = blk_sum(part, HD, p2, n) + a.head2_b[n];
    __syncthreads();

    // the draw (warp 0), as the ring kernel's but over any K
    if (warp == 0) {
      const float* u = a.noise + ((size_t)t * a.B + b) * a.NZ;
      float xt;
      if (a.gaussian) {
        const float ls = fmaxf(hp[1], a.log_scale_min);
        xt = hp[0] + expf(ls) * a.temperature * __ldg(u);
      } else {
        float best = -INFINITY;
        for (int k = lane; k < K; k += 32) best = fmaxf(best, hp[k] - logf(-logf(__ldg(u + k))));
        best = warp_max(best);
        int count = 0;
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          const bool pick = k < K && hp[k] - logf(-logf(__ldg(u + k))) >= best;
          count += __popc(__ballot_sync(FULL, pick));
        }
        const float wgt = 1.f / (float)count;
        float mean = 0.f, lsum = 0.f;
        for (int k = lane; k < K; k += 32)
          if (hp[k] - logf(-logf(__ldg(u + k))) >= best) {
            mean += hp[K + k] * wgt;
            lsum += fmaxf(hp[2 * K + k], a.log_scale_min) * wgt;
          }
        mean = warp_sum(mean);
        const float ls = warp_sum(lsum);
        const float ul = __ldg(u + K);
        xt = mean + expf(ls) * a.temperature * (logf(ul) - log1pf(-ul));
      }
      xt = fminf(fmaxf(xt, -1.f), 1.f);
      if (lane == 0) {
        *x_prev = xt;
        a.wav[(size_t)b * T + t] = xt;
      }
    }
    __syncthreads();
  }
}

template <typename W, typename CT>
int launch_block(const BlockArgs& a, cudaStream_t stream, int* geo) {
  auto kernel = ar_block_kernel<W, CT>;
  const long long smem = 4 * blk_smem_floats(a.C, a.G, a.S, a.M, a.HD);
  int dev = 0, optin = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (geo) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLK_THREADS, (size_t)smem);
    if (err != cudaSuccess) return err;
    geo[0] = BLK_THREADS;
    geo[1] = (int)smem;
    geo[2] = per_sm * n_sm;
    return cudaSuccess;
  }
  kernel<<<a.B, BLK_THREADS, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

int run_block(const BlockArgs& a, int weights_bf16, int cond_bf16, cudaStream_t st, int* geo) {
  if (a.B < 1 || a.T < 1 || a.L < 1 || a.C < 1 || a.S < 1 || a.M < 1 || a.G < 2 || a.G % 2 ||
      (a.gaussian ? a.HD != 2 : (a.K < 1 || a.HD != 3 * a.K)))
    return cudaErrorInvalidValue;
  if (weights_bf16)
    return cond_bf16 ? launch_block<bf16, bf16>(a, st, geo)
                     : launch_block<bf16, float>(a, st, geo);
  return cond_bf16 ? launch_block<float, bf16>(a, st, geo)
                   : launch_block<float, float>(a, st, geo);
}

// ---------------------------------------------------------------------------
// The general-width cluster body: any (C, G, S, M) with G even, any head width
// and any depth, one batch row a cluster of GEN_RANKS blocks (the design in
// the comment at the top of this file, the general-width item).

constexpr int GEN_RANKS = 8;                // blocks a cluster: one batch row
constexpr int GEN_WARPS = 8;                // consumer warps
constexpr int GEN_CT = 32 * GEN_WARPS;      // consumer threads
constexpr int GEN_THREADS = GEN_CT + 32;    // and one producer warp
constexpr int GEN_ZW = 2;                   // z values a warp a pass
constexpr int GEN_ZP = GEN_ZW * GEN_WARPS;  // z values a pass
constexpr int GEN_OQ = GEN_CT;              // out columns a pass
constexpr int GEN_MAX_STAGES = 8;
constexpr int GEN_BAR_BYTES = 8 * (2 * GEN_MAX_STAGES + 2);  // full, empty, xbar[2]
constexpr int GEN_PREF = 2;                 // cond values a thread fetches a step ahead
static_assert(GEN_RANKS % 4 == 0 && GEN_BAR_BYTES % 16 == 0, "exchange lanes, alignment");
static_assert(GEN_ZW == 1 || GEN_ZW == 2 || GEN_ZW == 4 || GEN_ZW == 8, "the sums' butterfly");

// What `ops/ar_sampler.py::generic_ar_plan` chose for these widths, in its
// order: z values a rank (gn, G/2 padded to GEN_RANKS), rows a k-block of
// the tap and cond segments and of the x segment (whole 16-byte vectors of
// weights), z rows a block of W_out, weights a unit of the stream (ue),
// units a layer, whether a unit is a whole layer (else one tile), ring
// stages, whether the taps and the head's weights are held in shared memory.
struct GenPlan {
  int gn, kb_tc, kb_x, rb, ue, units, whole, stages, taps, head;
};

GenPlan gen_plan(const int* p) {
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9]};
}

struct GenArgs {
  const void* cond;      // (B, T, M) bf16 or fp32
  const float* noise;    // (T, B, NZ)
  const void* front_k;   // (1, C)
  const float* front_b;  // (1, C)
  const void* w_rank;    // (N, L, units, ue): `pack_ar_generic`'s tiles
  const float* b_rank;   // (N, L, 2 gn): the rank's tanh biases, then sigmoid
  const float* b_rs;     // (L, C+S)
  const void* head1_k;   // (S, S)
  const float* head1_b;  // (1, S)
  const void* head2_k;   // (S, HD)
  const float* head2_b;  // (1, HD)
  const int* dil;        // (2, L) on the card: the dilations, then the queue offsets
  float* queue;          // (B, sum(d + 1), round8(C)), zero on entry
  float* wav;            // (B, T)
  float* wav_ranks;      // (N, B, T), written by the PWN_AR_SAMPLER_CHECK build only
  int B, T, L, C, G, S, M, HD, K, NZ, sum_q, gaussian;
  float log_scale_min, temperature;
};

__host__ __device__ inline int gen_round(int n, int m) { return (n + m - 1) / m * m; }

// The tiles of a layer's run, in stream order: for each pass of GEN_ZP z
// values, W_in's tap rows [C, 2C) and its cond rows [2C, 2C+M) in k-blocks
// of kb_tc; the same for its x rows [0, C) in k-blocks of kb_x; then W_out,
// for each pass of GEN_OQ columns, in blocks of rb z rows.  A gate tile
// holds its pass's tanh and sigmoid columns, each of its rows rounded up to
// whole 16-byte vectors (zero rows past the block).
__host__ __device__ inline int gen_tiles(int C, int S, int M, const GenPlan& p) {
  const int np = (p.gn + GEN_ZP - 1) / GEN_ZP, nq = (C + S + GEN_OQ - 1) / GEN_OQ;
  return np * ((C + p.kb_tc - 1) / p.kb_tc + (M + p.kb_tc - 1) / p.kb_tc +
               (C + p.kb_x - 1) / p.kb_x) +
         nq * ((p.gn + p.rb - 1) / p.rb);
}

// Dynamic shared memory (all of it): the barriers, then fp32 the exchange
// (2 parities x N ranks x CX), x (CQ), cond(t), the tap-and-cond sums (2
// gn), z (2 parities), the skip partials and bias sums, relu(skip), the
// head's hidden and output, the fed-back sample; then the taps (L x CQ)
// where the plan holds them, each layer's dilation, queue offset and this
// step's two slots (4 L ints), the head's weights where the plan holds
// them, the ring.  x, a tap and cond are padded with zeros to whole 8-float
// vectors.  `generic_ar_smem_bytes` mirrors it.
struct GenLayout {
  int CQ, CX, ZQ;
  int XBUF, X, CS, GTC, Z, SKP, BSUM, HS, H1, HP, XPREV, NF;  // fp32 offsets
  long long taps_b, dl_b, head_b, ring_b;
  __host__ __device__ GenLayout(int C, int S, int M, int HD, int L, int wb, const GenPlan& p) {
    CQ = gen_round(C, 8);
    CX = gen_round(C > S ? C : S, 4);
    ZQ = gen_round(p.gn, 4);
    XBUF = 0;
    X = XBUF + 2 * GEN_RANKS * CX;
    CS = X + CQ;
    GTC = CS + gen_round(M, 8);
    Z = GTC + gen_round(2 * p.gn, 4);
    SKP = Z + 2 * ZQ;
    BSUM = SKP + gen_round(S, 4);
    HS = BSUM + gen_round(S, 4);
    H1 = HS + gen_round(S, 4);
    HP = H1 + gen_round(S, 4);
    XPREV = HP + gen_round(HD, 4);
    NF = XPREV + 4;
    taps_b = p.taps ? 4LL * L * CQ : 0;
    dl_b = 16LL * L;
    head_b = p.head ? ((long long)wb * S * (S + HD) + 15) / 16 * 16 : 0;
    ring_b = (long long)p.stages * p.ue * wb;
  }
  __host__ __device__ long long bytes() const {
    return GEN_BAR_BYTES + 4LL * NF + taps_b + dl_b + head_b + ring_b;
  }
};

// Whether the kernel can walk plan `p` at these widths: k-blocks of whole
// vectors, the tiles fit their units, a unit is a whole layer or one tile.
bool gen_plan_ok(int C, int G, int S, int M, int wb, const GenPlan& p) {
  const int NO = C + S, gn = (G / 2 + GEN_RANKS - 1) / GEN_RANKS, vw = 16 / wb;
  if (p.gn != gn || p.kb_tc < 1 || p.kb_x < 1 || p.rb < 1 || p.ue < 1 || p.kb_tc % vw ||
      p.kb_x % vw || (long long)p.ue * wb % 16 || p.stages < 2 || p.stages > GEN_MAX_STAGES)
    return false;
  if (p.whole)
    return p.units == 1 && p.kb_tc >= C && p.kb_tc >= M && p.kb_x >= C && p.rb == gn &&
           2LL * gn * (2 * gen_round(C, vw) + gen_round(M, vw)) + (long long)gn * NO <= p.ue;
  const long long zmax = gn < GEN_ZP ? gn : GEN_ZP, omax = NO < GEN_OQ ? NO : GEN_OQ;
  return p.units == gen_tiles(C, S, M, p) && 2 * zmax * p.kb_tc <= p.ue &&
         2 * zmax * p.kb_x <= p.ue && p.rb * omax <= p.ue;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The consumers' side of the weight ring, which the producer warp fills in
// stream order: the next tile, of its own unit (a stage) or at its place in
// its layer's unit.  Every consumer warp walks the same tiles and releases
// every unit (the empty barrier counts GEN_WARPS arrivals).
template <typename W>
struct GenRing {
  const W* base;
  uint64_t* full;
  uint64_t* empty;
  int ue, stages, whole, lane;
  int rs = 0;          // the stage of the next unit,
  uint32_t rph = 0;    // and the parity of its full barrier's phase
  const W* lw = nullptr;  // a whole-layer unit: its stage,
  int loff = 0;           // and the next tile's place in it
  long long waited = 0;   // cycles spent waiting (the phase counters' build)
  __device__ __forceinline__ const W* acquire() {
#ifdef PWN_AR_SAMPLER_PHASES
    const long long t0 = clock64();
#endif
    mbar_spin(smem_u32(&full[rs]), rph);
#ifdef PWN_AR_SAMPLER_PHASES
    waited += clock64() - t0;
#endif
    return base + (size_t)rs * ue;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[rs]));
    if (++rs == stages) {
      rs = 0;
      rph ^= 1;
    }
  }
  __device__ __forceinline__ const W* tile(int elems) {
    if (!whole) return acquire();
    const W* p = lw + loff;
    loff += elems;
    return p;
  }
  __device__ __forceinline__ void tile_done() {
    if (!whole) release();
  }
  __device__ __forceinline__ void layer_begin() {
    if (whole) {
      lw = acquire();
      loff = 0;
    }
  }
  __device__ __forceinline__ void layer_end() {
    if (whole) release();
  }
};

// One pass's gate product over one segment of W_in's rows (nk rows of
// input `in`, in shared memory or, GL, a queue slot in global memory read
// by ld.global.cg), k-blocks of kb rows: lane v takes 16-byte vector v of
// each column, VW rows, with the VW inputs of those rows; two partial sums
// a column (even and odd rows).  (One load path a copy: a run-time choice
// between the two in the loop cost 4.4 us a step at the CLI's widths.)
template <bool GL, typename W>
__device__ __forceinline__ void gen_gate_seg(float (&acc)[GEN_ZW][2][2], GenRing<W>& ring,
                                             const float* in, int nk, int kb, int zc, int warp,
                                             int lane) {
  constexpr int VW = 16 / (int)sizeof(W);
  for (int k0 = 0; k0 < nk; k0 += kb) {
    const int nv = (min(kb, nk - k0) + VW - 1) / VW, krp = nv * VW;
    const W* tl = ring.tile(2 * zc * krp);
    for (int v = lane; v < nv; v += 32) {
      float f[VW];
      const float4* ip = reinterpret_cast<const float4*>(in + k0 + v * VW);
#pragma unroll
      for (int q = 0; q < VW / 4; ++q) {
        const float4 t = GL ? __ldcg(ip + q) : ip[q];
        f[4 * q] = t.x;
        f[4 * q + 1] = t.y;
        f[4 * q + 2] = t.z;
        f[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < GEN_ZW; ++i) {
        const int zi = warp + GEN_WARPS * i;
        if (zi < zc) {  // warp-uniform
          float wa[VW], wg[VW];
          Vec<W>::to_f32(*reinterpret_cast<const uint4*>(tl + (2 * zi) * krp + v * VW), wa);
          Vec<W>::to_f32(*reinterpret_cast<const uint4*>(tl + (2 * zi + 1) * krp + v * VW), wg);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            acc[i][0][e & 1] = fmaf(f[e], wa[e], acc[i][0][e & 1]);
            acc[i][1][e & 1] = fmaf(f[e], wg[e], acc[i][1][e & 1]);
          }
        }
      }
    }
    ring.tile_done();
  }
}

// A pass's column sums, all 2 GEN_ZW of a warp's (its z values' tanh and
// sigmoid columns) in one transposed butterfly: halving steps leave lane q
// with value q / GEN_SL summed over 32 / GEN_SL lanes, full steps over all
// 32 (at GEN_ZW = 4: 10 shuffles, 6 deep, where eight shuffle sums take
// 40).  Lane 2 GEN_SL i gets z value warp + GEN_WARPS i's tanh sum in ga
// and its sigmoid sum in gb.
constexpr int GEN_SL = 32 / (2 * GEN_ZW);  // lanes that end with the same value
__device__ __forceinline__ void gen_gate_sums(const float (&acc)[GEN_ZW][2][2], int lane,
                                              float& ga, float& gb) {
  float v[2 * GEN_ZW];
#pragma unroll
  for (int k = 0; k < 2 * GEN_ZW; ++k) v[k] = acc[k >> 1][k & 1][0] + acc[k >> 1][k & 1][1];
#pragma unroll
  for (int w = GEN_ZW, o = 16; w >= 1; w >>= 1, o >>= 1) {
    const bool up = lane & o;  // keep values [w, 2w) of the 2w, send [0, w)
#pragma unroll
    for (int k = 0; k < w; ++k) {
      const float keep = up ? v[w + k] : v[k], send = up ? v[k] : v[w + k];
      v[k] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
#pragma unroll
  for (int o = GEN_SL / 2; o >= 1; o >>= 1) v[0] += __shfl_xor_sync(FULL, v[0], o);
  ga = v[0];
  gb = __shfl_down_sync(FULL, v[0], GEN_SL);
}

// Layer l's gate product over its tap and cond rows for every pass (the
// tap in shared memory, or its queue slot where `gl`), plus the biases
// (bg: the rank's tanh biases, then sigmoid), into gtc.
template <typename W>
__device__ __forceinline__ void gen_gate_tc(GenRing<W>& ring, float* gtc, const float* tap,
                                            bool gl, const float* cs, const float* bg, int C,
                                            int M, int gn, int kb, int warp, int lane) {
  for (int p0 = 0; p0 < gn; p0 += GEN_ZP) {
    const int zc = min(GEN_ZP, gn - p0), zi = warp + GEN_WARPS * (lane / (2 * GEN_SL));
    const int j = p0 + zi;
    const bool mine = lane % (2 * GEN_SL) == 0 && zi < zc;
    float bga = 0.f, bgb = 0.f;
    if (mine) {
      bga = __ldg(bg + j);
      bgb = __ldg(bg + gn + j);
    }
    float acc[GEN_ZW][2][2] = {};
    if (gl)
      gen_gate_seg<true>(acc, ring, tap, C, kb, zc, warp, lane);
    else
      gen_gate_seg<false>(acc, ring, tap, C, kb, zc, warp, lane);
    gen_gate_seg<false>(acc, ring, cs, M, kb, zc, warp, lane);
    float ga, gb;
    gen_gate_sums(acc, lane, ga, gb);
    if (mine) {
      gtc[2 * j] = bga + ga;
      gtc[2 * j + 1] = bgb + gb;
    }
  }
}

// Layer l's gate product over its x rows for every pass, with gtc, and the
// gated unit (IEEE tanhf, sigmoid as 1/(1+exp(-x))): z.
template <typename W>
__device__ __forceinline__ void gen_gate_x(GenRing<W>& ring, float* z, const float* gtc,
                                           const float* x, int C, int gn, int kb, int warp,
                                           int lane) {
  for (int p0 = 0; p0 < gn; p0 += GEN_ZP) {
    const int zc = min(GEN_ZP, gn - p0), zi = warp + GEN_WARPS * (lane / (2 * GEN_SL));
    const int j = p0 + zi;
    float acc[GEN_ZW][2][2] = {};
    gen_gate_seg<false>(acc, ring, x, C, kb, zc, warp, lane);
    float ga, gb;
    gen_gate_sums(acc, lane, ga, gb);
    if (lane % (2 * GEN_SL) == 0 && zi < zc) {
      const float av = gtc[2 * j] + ga, bv = gtc[2 * j + 1] + gb;
      z[j] = tanhf(av) * (1.f / (1.f + expf(-bv)));
    }
  }
}

// One pass of the out product: this thread's column (tid < ncq) over the
// rank's z rows, blocks of rb rows (row-major tiles of ncq columns), four
// partial sums.
template <typename W>
__device__ __forceinline__ float gen_out_pass(GenRing<W>& ring, const float* z, int gn, int rb,
                                              int ncq, int tid) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int r0 = 0; r0 < gn; r0 += rb) {
    const int rr = min(rb, gn - r0);
    const W* tl = ring.tile(rr * ncq) + tid;
    if (tid < ncq) {
      const float* zr = z + r0;
      int r = 0;
      for (; r + 4 <= rr; r += 4) {
        a0 = fmaf(zr[r], to_f32(tl[r * ncq]), a0);
        a1 = fmaf(zr[r + 1], to_f32(tl[(r + 1) * ncq]), a1);
        a2 = fmaf(zr[r + 2], to_f32(tl[(r + 2) * ncq]), a2);
        a3 = fmaf(zr[r + 3], to_f32(tl[(r + 3) * ncq]), a3);
      }
      for (; r < rr; ++r) a0 = fmaf(zr[r], to_f32(tl[r * ncq]), a0);
    }
    ring.tile_done();
  }
  return (a0 + a1) + (a2 + a3);
}

// The phase counters' marker of the cluster body: the time since the last
// marker to phase k, but what the ring spent waiting for weights to phase 1.
#ifdef PWN_AR_SAMPLER_PHASES
#define GPHASE(k)                                                              \
  do {                                                                         \
    if (phase_on) {                                                            \
      const long long now = clock64();                                         \
      phase_acc[1] += static_cast<unsigned long long>(ring.waited);            \
      phase_acc[k] += static_cast<unsigned long long>(now - phase_t - ring.waited); \
      phase_t = now;                                                           \
    }                                                                          \
    ring.waited = 0;                                                           \
  } while (0)
#else
#define GPHASE(k)
#endif

template <typename W, typename CT>
__global__ void __launch_bounds__(GEN_THREADS, 1)
ar_generic_kernel(const GenArgs a, const GenPlan pl) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = static_cast<int>(cluster_ctarank());
  const int b = blockIdx.x / GEN_RANKS;
  const int C = a.C, S = a.S, M = a.M, HD = a.HD, K = a.K, L = a.L, T = a.T;
  const int NO = C + S, gn = pl.gn;
  const GenLayout ly(C, S, M, HD, L, (int)sizeof(W), pl);
  const int CQ = ly.CQ, CX = ly.CX;

  extern __shared__ __align__(128) unsigned char gsm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(gsm);
  uint64_t* empty = full + GEN_MAX_STAGES;
  uint64_t* xbar = empty + GEN_MAX_STAGES;  // the exchange's arrivals, by parity
  float* fs = reinterpret_cast<float*>(gsm + GEN_BAR_BYTES);
  float* xbuf = fs + ly.XBUF;
  float* x = fs + ly.X;
  float* cs = fs + ly.CS;
  float* gtc = fs + ly.GTC;
  float* zs = fs + ly.Z;
  float* skp = fs + ly.SKP;
  float* bsum = fs + ly.BSUM;
  float* hs = fs + ly.HS;
  float* h1 = fs + ly.H1;
  float* hp = fs + ly.HP;
  float* xprev = fs + ly.XPREV;
  float* taps = fs + ly.NF;  // L x CQ where the plan holds them
  unsigned char* past = reinterpret_cast<unsigned char*>(taps) + ly.taps_b;
  int* dls = reinterpret_cast<int*>(past);  // d, offset, this step's slots: L each
  W* hw = reinterpret_cast<W*>(past + ly.dl_b);  // head1 (S x S), head2 (S x HD)
  const W* ring_base = reinterpret_cast<const W*>(past + ly.dl_b + ly.head_b);
  const W* head1 = pl.head ? hw : static_cast<const W*>(a.head1_k);
  const W* head2 = pl.head ? hw + (size_t)S * S : static_cast<const W*>(a.head2_k);
  const size_t run = (size_t)pl.units * pl.ue;  // a layer's run of weights
  const W* w_rank = static_cast<const W*>(a.w_rank) + (size_t)rank * L * run;
  const float* b_rank = a.b_rank + (size_t)rank * L * 2 * gn;
  const W* front_k = static_cast<const W*>(a.front_k);
  const CT* cond = static_cast<const CT*>(a.cond) + (size_t)b * T * M;
  float* queue = a.queue + (size_t)b * a.sum_q * CQ;

  // -- once: the barriers, zeroed floats and taps, the head's weights, the
  //    skip biases summed over the layers, cond(0)
  const long long n_layers = (long long)T * L;  // layers over all steps
  const uint32_t res_bytes = 16u * GEN_RANKS * ((C + 3) / 4);
  const uint32_t skip_bytes = 16u * GEN_RANKS * ((S + 3) / 4);
  if (tid == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), GEN_WARPS);
    }
    for (int p = 0; p < 2; ++p) {
      mbar_init(smem_u32(&xbar[p]), 1);
      // the bytes that land here at layer p: the skip partials at a step's
      // last layer, else the residual partials
      if (p < n_layers) mbar_expect_tx(smem_u32(&xbar[p]), p % L == L - 1 ? skip_bytes : res_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < ly.NF; i += GEN_THREADS) fs[i] = 0.f;
  if (pl.taps)
    for (int i = tid; i < L * CQ; i += GEN_THREADS) taps[i] = 0.f;
  __syncthreads();
  if (pl.head) {
    const W* h1k = static_cast<const W*>(a.head1_k);
    const W* h2k = static_cast<const W*>(a.head2_k);
    for (int i = tid; i < S * S; i += GEN_THREADS) hw[i] = h1k[i];
    for (int i = tid; i < S * HD; i += GEN_THREADS) hw[S * S + i] = h2k[i];
  }
  for (int s = tid; s < S; s += GEN_THREADS) {
    float v = 0.f;
    for (int l = 0; l < L; ++l) v += a.b_rs[(size_t)l * NO + C + s];
    bsum[s] = v;
  }
  for (int m = tid; m < M; m += GEN_THREADS) cs[m] = to_f32(cond[m]);
  for (int l = tid; l < 2 * L; l += GEN_THREADS) dls[l] = a.dil[l];
  __syncthreads();
  // every block of the cluster has started before any writes into another's
  // shared memory
  cluster_arrive();
  cluster_wait();

  if (warp == GEN_WARPS) {
    // -- the producer warp: lane 0 streams every layer's units through the
    //    ring, each into a stage its consumer warps have released; every lane
    //    takes its part in the step's cluster barrier
    int s = 0;
    uint32_t ph = 0;
    bool first = true;
    const uint32_t ub = (uint32_t)(pl.ue * sizeof(W));
    for (int t = 0; t < T; ++t) {
      if (lane == 0)
        for (int l = 0; l < L; ++l)
          for (int u = 0; u < pl.units; ++u) {
            if (!first) mbar_wait(smem_u32(&empty[s]), ph);
            mbar_expect_tx(smem_u32(&full[s]), ub);
            bulk_load(smem_u32(ring_base + (size_t)s * pl.ue),
                      w_rank + (size_t)l * run + (size_t)u * pl.ue, ub, smem_u32(&full[s]));
            if (++s == pl.stages) {
              s = 0;
              if (!first) ph ^= 1;
              first = false;
            }
          }
      __syncwarp();
      if (t > 0) cluster_wait();
      cluster_arrive();
    }
    cluster_wait();
    return;
  }

  // -- the consumers
  GenRing<W> ring{ring_base, full, empty, pl.ue, pl.stages, pl.whole, lane};
#ifdef PWN_AR_SAMPLER_PHASES
  const bool phase_on = blockIdx.x == 0 && tid == 0;
  unsigned long long phase_acc[NPHASES + 1] = {};
  long long phase_t = clock64();
#endif
  const int nq = (NO + GEN_OQ - 1) / GEN_OQ;
  const int CQR = (C + GEN_RANKS - 1) / GEN_RANKS;  // queue columns a rank writes
  const int q0 = rank * CQR, q1 = min(C, q0 + CQR);
  int* slot_w = dls + 2 * L;  // this step's slot of each layer's x,
  int* slot_r = dls + 3 * L;  // and the slot its tap is read from
  // the exchange buffer and its barrier in ranks lane / 8 + 4i, where this
  // lane's residual partials go
  uint32_t xbuf_at[GEN_RANKS / 4], xbar_at[GEN_RANKS / 4];
#pragma unroll
  for (int i = 0; i < GEN_RANKS / 4; ++i) {
    xbuf_at[i] = mapa(smem_u32(xbuf), (lane >> 3) + 4 * i);
    xbar_at[i] = mapa(smem_u32(xbar), (lane >> 3) + 4 * i);
  }
  long long c = 0;          // layers so far, over all steps: the exchange's phases
  int par = 0;              // its buffer and barrier
  float u0 = 0.f;           // warp 0: noise value `lane` of the step
  float cn[GEN_PREF] = {};  // cond(t + 1) values tid + GEN_CT i

  // layer l's tap at step t: held in shared memory, or its queue slot
  // (slot_r: written at step t - d; a layer's d + 1 slots keep it apart from
  // the slot this step writes)
  auto tap_of = [&](int l) -> const float* {
    return pl.taps ? taps + (size_t)l * CQ : queue + (size_t)slot_r[l] * CQ;
  };

  for (int t = 0; t < T; ++t) {
    // -- step start: the front 1x1 (no FMA, as the plain version), layer 0's
    //    gate product over its tap and cond rows
    if (!pl.taps && t > 0) cluster_wait();  // the queue's writes of the step before
    {
      const float xp = *xprev;
      for (int n = tid; n < C; n += GEN_CT)
        x[n] = __fadd_rn(__fmul_rn(xp, to_f32(front_k[n])), __ldg(a.front_b + n));
      // the slots: x_l of step t into t % (d + 1); the tap read (held: for
      // step t + 1, from (t + 2) % (d + 1); else for step t, (t + 1) % (d + 1))
      for (int l = tid; l < L; l += GEN_CT) {
        const int d1 = dls[l] + 1, o = dls[L + l];
        slot_w[l] = o + t % d1;
        slot_r[l] = o + (t + (pl.taps ? 2 : 1)) % d1;
      }
    }
    named_sync(BAR_ALL, GEN_CT);
    GPHASE(0);
    ring.layer_begin();
    gen_gate_tc(ring, gtc, tap_of(0), !pl.taps, cs, b_rank, C, M, gn, pl.kb_tc, warp, lane);
    GPHASE(2);
    named_sync(BAR_ALL, GEN_CT);

    for (int l = 0; l < L; ++l, ++c) {
      const bool last = l + 1 == L;
      float* z = zs + par * ly.ZQ;
      gen_gate_x(ring, z, gtc, x, C, gn, pl.kb_x, warp, lane);
      GPHASE(4);
      named_sync(BAR_ALL, GEN_CT);
      // the queue's writes of the step before are visible from here on
      if (l == 0 && t > 0 && pl.taps) cluster_wait();
      {
        // x_l into its slot (this rank's columns; with taps held, only where
        // d > 1), and the held tap of step t+1: x_l itself where d = 1, else
        // its slot, written at step t+1-d, copied by cp.async (done by the
        // step's end)
        const int d = dls[l];
        float* wq = queue + (size_t)slot_w[l] * CQ;
        const bool store = !pl.taps || d > 1;
        for (int n = tid; n < C; n += GEN_CT) {
          if (store && n >= q0 && n < q1) __stcg(wq + n, x[n]);
          if (pl.taps && d == 1) taps[(size_t)l * CQ + n] = x[n];
        }
        if (pl.taps && d > 1) {
          const float* rq = queue + (size_t)slot_r[l] * CQ;
          for (int v = tid; v < CQ / 4; v += GEN_CT)
            cp_async16(taps + (size_t)l * CQ + 4 * v, rq + 4 * v);
          cp_async_commit();
        }
      }
      // the out product: output n's partial over this rank's z rows; a skip
      // output's adds to its skp entry (this thread's alone), a residual
      // output's goes to every rank by st.async (not at the last layer), 4
      // columns a lane, gathered by shuffles
      for (int q = 0; q < nq; ++q) {
        const int n0 = q * GEN_OQ, ncq = min(GEN_OQ, NO - n0), n = n0 + tid;
        const float o = gen_out_pass(ring, z, gn, pl.rb, ncq, tid);
        if (tid < ncq && n >= C) skp[n - C] = (l == 0 ? 0.f : skp[n - C]) + o;
        if (!last && n0 + 32 * warp < C) {  // warp-uniform
          const float val = n < C ? o : 0.f;
          const int f = lane & 7, col = n0 + 32 * warp + 4 * f;
          const float4 v = make_float4(__shfl_sync(FULL, val, 4 * f), __shfl_sync(FULL, val, 4 * f + 1),
                                       __shfl_sync(FULL, val, 4 * f + 2),
                                       __shfl_sync(FULL, val, 4 * f + 3));
          if (col < C) {
            const uint32_t off = 4u * ((par * GEN_RANKS + rank) * CX + col);
#pragma unroll
            for (int i = 0; i < GEN_RANKS / 4; ++i) st_async(xbuf_at[i] + off, v, xbar_at[i] + 8 * par);
          }
        }
      }
      ring.layer_end();
      GPHASE(5);
      if (last) {
        // the skip partials, summed over the layers, to every rank
        named_sync(BAR_ALL, GEN_CT);
        const int SV = (S + 3) / 4;
        for (int i = tid; i < SV * GEN_RANKS; i += GEN_CT) {
          const int v = i % SV, r = i / SV;
          st_async(mapa(smem_u32(xbuf + (par * GEN_RANKS + rank) * CX + 4 * v), r),
                   *reinterpret_cast<const float4*>(skp + 4 * v), mapa(smem_u32(&xbar[par]), r));
        }
      }
      if (l == 0) {
        if (warp == 0 && lane < a.NZ) u0 = __ldg(a.noise + ((size_t)t * a.B + b) * a.NZ + lane);
        if (t + 1 < T)
#pragma unroll
          for (int i = 0; i < GEN_PREF; ++i) {
            const int m = tid + GEN_CT * i;
            if (m < M) cn[i] = to_f32(cond[(size_t)(t + 1) * M + m]);
          }
      }
      GPHASE(6);
      // while the other ranks catch up: the next layer's tap and cond rows
      if (!last) {
        ring.layer_begin();
        gen_gate_tc(ring, gtc, tap_of(l + 1), !pl.taps, cs, b_rank + (size_t)(l + 1) * 2 * gn, C,
                    M, gn, pl.kb_tc, warp, lane);
        GPHASE(2);
      }
      const float brs = !last && tid < C ? __ldg(a.b_rs + (size_t)l * NO + tid) : 0.f;
      // every rank's partials have landed here: arm this parity's next use
      mbar_spin_cluster(smem_u32(&xbar[par]), (uint32_t)((c >> 1) & 1));
      if (tid == 0 && c + 2 < n_layers)
        mbar_expect_tx(smem_u32(&xbar[par]), (c + 2) % L == L - 1 ? skip_bytes : res_bytes);
      GPHASE(7);
      // every rank sums the N partials in rank order: the same bits in all
      const float* xb = xbuf + par * GEN_RANKS * CX;
      par ^= 1;
      for (int n = tid; n < (last ? S : C); n += GEN_CT) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < GEN_RANKS; ++r) s += xb[r * CX + n];
        if (last)
          hs[n] = fmaxf(bsum[n] + s, 0.f);
        else
          x[n] = x[n] + ((n == tid ? brs : __ldg(a.b_rs + (size_t)l * NO + n)) + s);
      }
      named_sync(BAR_ALL, GEN_CT);
      GPHASE(3);
    }

    // -- head: relu (above), 1x1, relu, 1x1, in every rank
    for (int n = tid; n < S; n += GEN_CT) {
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
      int k = 0;
      for (; k + 4 <= S; k += 4) {
        v0 = fmaf(hs[k], to_f32(head1[(size_t)k * S + n]), v0);
        v1 = fmaf(hs[k + 1], to_f32(head1[(size_t)(k + 1) * S + n]), v1);
        v2 = fmaf(hs[k + 2], to_f32(head1[(size_t)(k + 2) * S + n]), v2);
        v3 = fmaf(hs[k + 3], to_f32(head1[(size_t)(k + 3) * S + n]), v3);
      }
      for (; k < S; ++k) v0 = fmaf(hs[k], to_f32(head1[(size_t)k * S + n]), v0);
      h1[n] = fmaxf(__ldg(a.head1_b + n) + ((v0 + v1) + (v2 + v3)), 0.f);
    }
    named_sync(BAR_ALL, GEN_CT);
    for (int j = warp; j < HD; j += GEN_WARPS) {  // warp-uniform
      float v = 0.f;
      for (int k = lane; k < S; k += 32) v = fmaf(h1[k], to_f32(head2[(size_t)k * HD + j]), v);
      v = warp_sum(v);
      if (lane == 0) hp[j] = __ldg(a.head2_b + j) + v;
    }
    named_sync(BAR_ALL, GEN_CT);

    // -- the sample (warp 0 of every rank), as the ring kernel's over any K
    if (warp == 0) {
      const float* u = a.noise + ((size_t)t * a.B + b) * a.NZ;
      float xt;
      if (a.gaussian) {
        const float eps = __shfl_sync(FULL, u0, 0);
        xt = hp[0] + expf(fmaxf(hp[1], a.log_scale_min)) * a.temperature * eps;
      } else {
        const float s0 = lane < K ? hp[lane] - logf(-logf(u0)) : -INFINITY;
        float best = s0;
        for (int k = lane + 32; k < K; k += 32) best = fmaxf(best, hp[k] - logf(-logf(__ldg(u + k))));
        best = warp_max(best);
        const bool pick0 = lane < K && s0 >= best;
        int count = __popc(__ballot_sync(FULL, pick0));
        for (int k0 = 32; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          count += __popc(__ballot_sync(FULL, k < K && hp[k] - logf(-logf(__ldg(u + k))) >= best));
        }
        const float wgt = 1.f / (float)count;
        float mean = 0.f, ls = 0.f;
        if (pick0) {
          mean = hp[K + lane] * wgt;
          ls = fmaxf(hp[2 * K + lane], a.log_scale_min) * wgt;
        }
        for (int k = lane + 32; k < K; k += 32)
          if (hp[k] - logf(-logf(__ldg(u + k))) >= best) {
            mean += hp[K + k] * wgt;
            ls += fmaxf(hp[2 * K + k], a.log_scale_min) * wgt;
          }
        mean = warp_sum(mean);
        ls = warp_sum(ls);
        const float ul = K < 32 ? __shfl_sync(FULL, u0, K) : __ldg(u + K);
        xt = mean + expf(ls) * a.temperature * (logf(ul) - log1pf(-ul));
      }
      xt = fminf(fmaxf(xt, -1.f), 1.f);
      if (lane == 0) {
        *xprev = xt;
        if (rank == 0) a.wav[(size_t)b * T + t] = xt;
#ifdef PWN_AR_SAMPLER_CHECK
        a.wav_ranks[((size_t)rank * a.B + b) * T + t] = xt;
#endif
      }
    }
    // cond(t+1) lands (the step's last read of cond was layer L-1's gate
    // product); the held taps' copies are done
    if (t + 1 < T) {
#pragma unroll
      for (int i = 0; i < GEN_PREF; ++i) {
        const int m = tid + GEN_CT * i;
        if (m < M) cs[m] = cn[i];
      }
      for (int m = tid + GEN_CT * GEN_PREF; m < M; m += GEN_CT)
        cs[m] = to_f32(cond[(size_t)(t + 1) * M + m]);
    }
    if (pl.taps) cp_async_wait_all();
    // this step's queue reads and writes are done (release)
    cluster_arrive();
    named_sync(BAR_ALL, GEN_CT);
    GPHASE(8);
#ifdef PWN_AR_SAMPLER_PHASES
    if (phase_on) ++phase_acc[NPHASES];
#endif
  }
  cluster_wait();
#ifdef PWN_AR_SAMPLER_PHASES
  if (phase_on)
    for (int k = 0; k <= NPHASES; ++k) atomicAdd(&ar_phase_cycles[k], phase_acc[k]);
#endif
}

template <typename W, typename CT>
int launch_generic(const GenArgs& a, const GenPlan& p, cudaStream_t stream, int* geo) {
  auto kernel = ar_generic_kernel<W, CT>;
  if (!gen_plan_ok(a.C, a.G, a.S, a.M, (int)sizeof(W), p)) return cudaErrorInvalidValue;
  const long long smem = GenLayout(a.C, a.S, a.M, a.HD, a.L, (int)sizeof(W), p).bytes();
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = GEN_RANKS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * GEN_RANKS);
  cfg.blockDim = dim3(GEN_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (geo) {
    geo[0] = 1;
    geo[1] = GEN_RANKS;
    geo[2] = p.stages;
    geo[3] = (int)smem;
    geo[4] = fit;
    return cudaSuccess;
  }
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, a, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int run_generic(const GenArgs& a, const GenPlan& p, int weights_bf16, int cond_bf16,
                cudaStream_t st, int* geo) {
  if (a.B < 1 || a.T < 1 || a.L < 1 || a.C < 1 || a.S < 1 || a.M < 1 || a.G < 2 || a.G % 2 ||
      (a.gaussian ? a.HD != 2 : (a.K < 1 || a.HD != 3 * a.K)))
    return cudaErrorInvalidValue;
  if (weights_bf16)
    return cond_bf16 ? launch_generic<bf16, bf16>(a, p, st, geo)
                     : launch_generic<bf16, float>(a, p, st, geo);
  return cond_bf16 ? launch_generic<float, bf16>(a, p, st, geo)
                   : launch_generic<float, float>(a, p, st, geo);
}

}  // namespace

extern "C" {

#ifdef PWN_AR_SAMPLER_PHASES
// The phases' names, separated by ';'.
const char* pwn_ar_sampler_phase_names() { return PHASE_NAMES; }

// Copies the phase cycles since the last call, then the count of steps, into
// out[NPHASES + 1] and clears them.
int pwn_ar_sampler_phases(unsigned long long* out) {
  const unsigned long long zero[NPHASES + 1] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, ar_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(ar_phase_cycles, zero, sizeof(zero));
  return err;
}
#endif

// Runs the sampler on `stream`; returns a cudaError_t (0 on success).
// weights_bf16 / cond_bf16 select the storage type (else fp32) of the
// weights (front_k, w_rank, head1_k, head2_k) and of cond.  w_rank / b_rank
// are `pack_ar_ranks`' layout for n_ranks blocks per cluster (8).  wav_ranks
// may be null; only a PWN_AR_SAMPLER_CHECK build writes it.
int pwn_ar_sample(const void* cond, const void* noise, const void* front_k,
                  const void* front_b, const void* w_rank, const void* b_rank,
                  const void* b_rs, const void* head1_k, const void* head1_b,
                  const void* head2_k, const void* head2_b, void* queue, void* wav,
                  void* wav_ranks, int B, int T, int L, int c, int g, int s, int m, int hd,
                  int k, int gaussian, const int* dilations, float log_scale_min,
                  float temperature, int weights_bf16, int cond_bf16, int n_ranks,
                  void* stream) {
  Args a;
  a.cond = cond;
  a.noise = static_cast<const float*>(noise);
  a.front_k = front_k;
  a.front_b = static_cast<const float*>(front_b);
  a.w_rank = w_rank;
  a.b_rank = static_cast<const float*>(b_rank);
  a.b_rs = static_cast<const float*>(b_rs);
  a.head1_k = head1_k;
  a.head1_b = static_cast<const float*>(head1_b);
  a.head2_k = head2_k;
  a.head2_b = static_cast<const float*>(head2_b);
  a.queue = static_cast<float*>(queue);
  a.wav = static_cast<float*>(wav);
  a.wav_ranks = static_cast<float*>(wav_ranks);
  a.B = B; a.T = T; a.L = L;
  a.HD = hd; a.K = gaussian ? 0 : k; a.NZ = gaussian ? 1 : k + 1;
  a.sum_d = 0; a.gaussian = gaussian;
  a.log_scale_min = log_scale_min;
  a.temperature = temperature;
  return run(a, dilations, c, g, s, m, hd, k, gaussian, weights_bf16, cond_bf16, n_ranks,
             static_cast<cudaStream_t>(stream), nullptr);
}

// The launch for these widths, types and layers, into out[5]: batch rows a
// cluster, blocks a cluster, ring stages, dynamic shared memory in bytes,
// and how many clusters the card holds at once (a batch with more runs in
// waves); returns a cudaError_t.
int pwn_ar_sample_geometry(int L, int c, int g, int s, int m, int hd, int k, int gaussian,
                           int weights_bf16, int cond_bf16, int n_ranks, int* out) {
  Args a = {};
  a.B = 1; a.T = 1; a.L = L; a.HD = hd;
  int dil[MAX_L];
  for (int l = 0; l < MAX_L; ++l) dil[l] = 1;
  if (L < 1 || L > MAX_L) return cudaErrorInvalidValue;
  Geometry geo;
  const int err = run(a, dil, c, g, s, m, hd, k, gaussian, weights_bf16, cond_bf16, n_ranks,
                      nullptr, &geo);
  if (err == cudaSuccess) {
    out[0] = geo.rows; out[1] = geo.ranks; out[2] = geo.stages; out[3] = geo.smem;
    out[4] = geo.clusters;
  }
  return err;
}

// The one-block body on `stream`: the same math as pwn_ar_sample over the
// weights in `stack_teacher_weights`' layout (no rank packing), any widths
// and layer count; dil is (2, L) int32 on the card (the dilations, then the
// queue offsets), sum_d the queue's slots.  Returns a cudaError_t.
int pwn_ar_sample_block(const void* cond, const void* noise, const void* front_k,
                        const void* front_b, const void* w_in, const void* b_g,
                        const void* w_out, const void* b_rs, const void* head1_k,
                        const void* head1_b, const void* head2_k, const void* head2_b,
                        const void* dil, void* queue, void* wav, int B, int T, int L, int c,
                        int g, int s, int m, int hd, int k, int gaussian, int sum_d,
                        float log_scale_min, float temperature, int weights_bf16,
                        int cond_bf16, void* stream) {
  BlockArgs a;
  a.cond = cond;
  a.noise = static_cast<const float*>(noise);
  a.front_k = front_k;
  a.front_b = static_cast<const float*>(front_b);
  a.w_in = w_in;
  a.b_g = static_cast<const float*>(b_g);
  a.w_out = w_out;
  a.b_rs = static_cast<const float*>(b_rs);
  a.head1_k = head1_k;
  a.head1_b = static_cast<const float*>(head1_b);
  a.head2_k = head2_k;
  a.head2_b = static_cast<const float*>(head2_b);
  a.dil = static_cast<const int*>(dil);
  a.queue = static_cast<float*>(queue);
  a.wav = static_cast<float*>(wav);
  a.B = B; a.T = T; a.L = L; a.C = c; a.G = g; a.S = s; a.M = m; a.HD = hd;
  a.K = gaussian ? 0 : k; a.NZ = gaussian ? 1 : k + 1;
  a.sum_d = sum_d; a.gaussian = gaussian;
  a.log_scale_min = log_scale_min;
  a.temperature = temperature;
  return run_block(a, weights_bf16, cond_bf16, static_cast<cudaStream_t>(stream), nullptr);
}

// The one-block body's launch for these widths and types, into out[3]:
// threads a block (one block a batch row), dynamic shared memory in bytes,
// and how many of its blocks the card holds at once (a larger batch runs in
// waves); returns a cudaError_t.
int pwn_ar_sample_block_geometry(int c, int g, int s, int m, int hd, int k, int gaussian,
                                 int weights_bf16, int cond_bf16, int* out) {
  BlockArgs a = {};
  a.B = 1; a.T = 1; a.L = 1; a.C = c; a.G = g; a.S = s; a.M = m; a.HD = hd;
  a.K = gaussian ? 0 : k; a.gaussian = gaussian;
  return run_block(a, weights_bf16, cond_bf16, nullptr, out);
}

// The general-width cluster body on `stream`: w_rank / b_rank are
// `pack_ar_generic`'s layout for `plan` (GEN_PLAN_INTS ints from
// ops/ar_sampler.py::generic_ar_plan, in GenPlan's order); dil is (2, L)
// int32 on the card (the dilations, then the queue offsets, d + 1 slots a
// layer), sum_q the queue's slots, each of round4(c) floats.  wav_ranks may
// be null; only a PWN_AR_SAMPLER_CHECK build writes it.  Returns a
// cudaError_t.
int pwn_ar_sample_generic(const void* cond, const void* noise, const void* front_k,
                          const void* front_b, const void* w_rank, const void* b_rank,
                          const void* b_rs, const void* head1_k, const void* head1_b,
                          const void* head2_k, const void* head2_b, const void* dil,
                          void* queue, void* wav, void* wav_ranks, int B, int T, int L, int c,
                          int g, int s, int m, int hd, int k, int gaussian, int sum_q,
                          const int* plan, float log_scale_min, float temperature,
                          int weights_bf16, int cond_bf16, void* stream) {
  GenArgs a;
  a.cond = cond;
  a.noise = static_cast<const float*>(noise);
  a.front_k = front_k;
  a.front_b = static_cast<const float*>(front_b);
  a.w_rank = w_rank;
  a.b_rank = static_cast<const float*>(b_rank);
  a.b_rs = static_cast<const float*>(b_rs);
  a.head1_k = head1_k;
  a.head1_b = static_cast<const float*>(head1_b);
  a.head2_k = head2_k;
  a.head2_b = static_cast<const float*>(head2_b);
  a.dil = static_cast<const int*>(dil);
  a.queue = static_cast<float*>(queue);
  a.wav = static_cast<float*>(wav);
  a.wav_ranks = static_cast<float*>(wav_ranks);
  a.B = B; a.T = T; a.L = L; a.C = c; a.G = g; a.S = s; a.M = m; a.HD = hd;
  a.K = gaussian ? 0 : k; a.NZ = gaussian ? 1 : k + 1;
  a.sum_q = sum_q; a.gaussian = gaussian;
  a.log_scale_min = log_scale_min;
  a.temperature = temperature;
  return run_generic(a, gen_plan(plan), weights_bf16, cond_bf16,
                     static_cast<cudaStream_t>(stream), nullptr);
}

// The cluster body's launch for these widths, types and plan, into out[5]:
// batch rows a cluster (1), blocks a cluster, ring stages, dynamic shared
// memory in bytes, and how many clusters the card holds at once (a larger
// batch runs in waves); returns a cudaError_t.
int pwn_ar_sample_generic_geometry(int L, int c, int g, int s, int m, int hd, int k,
                                   int gaussian, int weights_bf16, int cond_bf16,
                                   const int* plan, int* out) {
  GenArgs a = {};
  a.B = 1; a.T = 1; a.L = L; a.C = c; a.G = g; a.S = s; a.M = m; a.HD = hd;
  a.K = gaussian ? 0 : k; a.NZ = gaussian ? 1 : k + 1; a.gaussian = gaussian;
  return run_generic(a, gen_plan(plan), weights_bf16, cond_bf16, nullptr, out);
}

}  // extern "C"
