// Whole-loop teacher autoregressive sampler for Hopper (sm_90a): Fast
// WaveNet with per-layer conv queues, all T steps in one launch, each batch
// row on one cluster of N = 8 thread blocks.
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
//   "wide (24 x 256ch)"), keeps this structure; what its widths break is
//   sized by `Dims` from the widths and the weights' type:
//   - A rank's layer slice is 108,544 B in bf16 (217,088 in fp32): no ring
//     of whole slices fits a block (RING false, RING_MAX).  The products read
//     the slice where it lies, in L2 (20.8 MB of bf16 weights, 41.7 MB of
//     fp32, against 50 MB), by the same loads as from the ring; the tap and
//     cond part still runs while the exchange lands.
//   - C + S = 512 outputs over 256 threads: thread tid owns outputs tid and
//     tid + 256 (OPT), the residual one and the skip one.
//   - head1 (S x S: 128 KB in bf16, 256 KB in fp32) is split (SPLIT_HEAD):
//     rank j holds its 32 columns (S x 32), forms those hidden values and
//     sends them to every rank by st.async, counted on one more mbarrier;
//     every rank then holds the same S values and runs head2 and the draw
//     as before.  The buffer is written again only in the next step, after
//     the cluster barrier that every rank reaches after reading it.
//   - cond(t+1) rides on threads [256 - CH, 256) (CB).
//   Shared memory: 76 KB in bf16, 108 KB in fp32 (the taps 24 KB, the
//   exchange 16 KB, head1's slice and head2).  teacher_lj's and the tiny
//   teacher's instantiations compile to the same arithmetic as before
//   (tools/torch_ar_compare_trees.py).  At batch 8 a step is 902.6 GFLOP /
//   5,376 in fp32 (2.5 us at 67 TFLOP/s) over 8 x 20.8 MB of bf16 weight
//   reads from L2; it took 81.2 us on the H100 (chip_smoke.py phase 8g):
//   2.0 TB/s from L2 in all, with each layer's two products waiting on
//   their loads in turn.
//
// With PWN_AR_SAMPLER_PHASES defined (tools/torch_ar_sampler_phases.py builds
// it so), thread 0 of block 0 adds the clock cycles of each phase of each step
// into ar_phase_cycles (PHASE_NAMES below), then counts the steps.  With
// PWN_AR_SAMPLER_CHECK defined, every rank writes its samples to wav_ranks
// (N, B, T), so that a tool can hold the ranks equal bit for bit.

#include <math.h>
#include <stdint.h>

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
    "step start;waiting for a slice;tap and cond product;x update;"
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

constexpr int RING_MAX = 128 * 1024;  // the ring's share of shared memory
constexpr int HEAD1_MAX = 64 * 1024;  // head1 whole in every rank up to this

// The widths, the rank split, the thread maps and the shared memory.
template <typename W, typename CT, int C, int G, int S, int M, int N>
struct Dims {
  static constexpr int GH = G / 2, GN = GH / N, GC = 2 * GN, KIN = 2 * C + M, NO = C + S;
  static constexpr int WIN_E = GC * KIN, LAYER_E = WIN_E + GN * NO;
  static constexpr int LAYER_BYTES = LAYER_E * sizeof(W);
  static constexpr int STAGES = sizeof(W) == 2 ? 4 : 2;
  // the layer slices stream through a ring of whole slices where STAGES of
  // them fit RING_MAX; else (the wide teacher) the products read them from
  // L2 where they lie
  static constexpr bool RING = STAGES * LAYER_BYTES <= RING_MAX;
  // head1 (S x S) whole in every rank, or split: rank j holds its columns
  // [j SN, (j+1) SN) and the ranks exchange their SN hidden values
  static constexpr bool SPLIT_HEAD = S * S * (int)sizeof(W) > HEAD1_MAX;
  static constexpr int SN = SPLIT_HEAD ? S / N : S;
  // out product: thread tid owns outputs tid + NTHREADS o, o < OPT
  static constexpr int OPT = (NO + NTHREADS - 1) / NTHREADS;
  // gate: warp w owns z values [w ZW, (w+1) ZW), so 2 ZW columns; lanes
  // over k pairs: XP pairs a lane over x (k < C), RP over tap and cond
  static constexpr int ZW = GN / NWARPS, ZC = 2 * ZW;
  static constexpr int KP = KIN / 2, XP = C / 64, RP = (KP - C / 2 + 31) / 32;
  static constexpr int HP = NTHREADS / S;                  // k parts of head1's product
  static constexpr int CH = M * (int)sizeof(CT) / 16;      // 16-byte chunks of cond(t)
  // threads [CB, CB + CH) carry cond(t+1) through a step
  static constexpr int CB = C + CH <= NTHREADS ? C : NTHREADS - CH;
  // shared memory, in bytes: the ring, then floats, then the head's weights
  static constexpr int RING_OFF = 0;
  static constexpr int F0 = RING ? STAGES * LAYER_BYTES : 0;  // floats from here
  static constexpr int XBUF = 0;    // the exchange: 2 parities x N ranks x C (= S)
  static constexpr int CS = XBUF + 2 * N * C;      // cond(t) (M)
  static constexpr int ZP = round4(GN);
  static constexpr int ZS = CS + round4(M);        // z (GN), 2 parities
  static constexpr int HS = ZS + 2 * ZP;           // the head's hidden (S)
  static constexpr int HPART = HS + S;             // head1 partials, HP x S
  static constexpr int HPO = HPART + HP * S;       // head outputs (MAX_HD)
  static constexpr int HX = HPO + MAX_HD;          // split head: every rank's hidden (S)
  static constexpr int TAPS = HX + (SPLIT_HEAD ? S : 0);  // then the taps, L x C
  // then head1 (S x SN) and head2 (S x HD) in the weights' type
  static_assert(GH % N == 0 && C % N == 0 && GN % NWARPS == 0, "gate split");
  static_assert(C % 64 == 0 && M % 2 == 0 && NO % 32 == 0 &&
                    (NO <= NTHREADS || NO % NTHREADS == 0),
                "thread maps");
  static_assert(S == C && NTHREADS % S == 0 && (S / HP) % 2 == 0, "head split");
  static_assert(!SPLIT_HEAD || (SN == 32 && (S / (NTHREADS / SN)) % 2 == 0 &&
                                SN * sizeof(W) % 16 == 0),
                "split head: a warp's lanes over a rank's columns");
  static_assert(M * sizeof(CT) % 16 == 0 && CH <= NTHREADS, "cond chunks");
  static_assert(LAYER_BYTES % 16 == 0 && F0 % 16 == 0, "16-byte bulk copies");
};

template <typename W, typename CT, int C, int G, int S, int M, int N>
size_t smem_bytes(int L, int HD) {
  using D = Dims<W, CT, C, G, S, M, N>;
  return D::F0 + sizeof(float) * (size_t)(D::TAPS + L * C) + sizeof(W) * (size_t)S * (D::SN + HD);
}

// Layer l's slice (global layer counter c): its ring stage, or where the
// slices do not stream through shared memory, the slice itself in L2.
template <class D, typename W>
__device__ __forceinline__ const W* layer_slice(const W* ring, const W* w_rank, long long c,
                                                int l) {
  if constexpr (D::RING)
    return ring + (c % D::STAGES) * D::LAYER_E;
  else
    return w_rank + (size_t)l * D::LAYER_E;
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
  const W* ring = reinterpret_cast<const W*>(smem + D::RING_OFF);
  float* fsm = reinterpret_cast<float*>(smem + D::F0);
  float* xbuf = fsm + D::XBUF;
  float* cs = fsm + D::CS;
  float* zs = fsm + D::ZS;
  float* hs = fsm + D::HS;
  float* hpart = fsm + D::HPART;
  float* hp = fsm + D::HPO;
  float* hx = fsm + D::HX;
  float* taps = fsm + D::TAPS;
  W* head1 = reinterpret_cast<W*>(taps + L * C);  // S x SN: this rank's columns
  W* head2 = head1 + S * D::SN;
  __shared__ int dd[MAX_L], oo[MAX_L], slot_now[MAX_L], slot_next[MAX_L];
  __shared__ float x_prev;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t xbar[2];  // the exchange's arrivals, by parity
  __shared__ __align__(8) uint64_t hbar;     // the split head's arrivals

#ifdef PWN_AR_SAMPLER_PHASES
  const bool phase_on = blockIdx.x == 0 && tid == 0;
  unsigned long long phase_acc[NPHASES + 1] = {};
  long long phase_t = clock64();
#endif

  // -- once: the ring's first layers, the dilations, the head's weights,
  //    zero taps, cond(0), per-thread constants
  const long long n_layers = (long long)T * L;  // layers over all steps
  constexpr uint32_t XBYTES = N * C * sizeof(float);  // one layer's exchange
  constexpr uint32_t HXBYTES = S * sizeof(float);     // one step's split head
  if (tid == REFILL) {
    if constexpr (D::RING)
      for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    for (int p = 0; p < 2; ++p) {
      mbar_init(smem_u32(&xbar[p]), 1);
      mbar_expect_tx(smem_u32(&xbar[p]), XBYTES);
    }
    if constexpr (D::SPLIT_HEAD) {
      mbar_init(smem_u32(&hbar), 1);
      mbar_expect_tx(smem_u32(&hbar), HXBYTES);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (D::RING)
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
    // head1's columns [rank SN, (rank+1) SN) of every row (all of it unless
    // split): RC 16-byte chunks a row out of the row's S * sizeof(W) / 16
    constexpr int RC = D::SN * (int)sizeof(W) / 16, RS = S * (int)sizeof(W) / 16;
    const uint4* src1 = static_cast<const uint4*>(a.head1_k) + (D::SPLIT_HEAD ? rank * RC : 0);
    const uint4* src2 = static_cast<const uint4*>(a.head2_k);
    uint4* dst1 = reinterpret_cast<uint4*>(head1);
    uint4* dst2 = reinterpret_cast<uint4*>(head2);
    const int n1 = S * RC, n2 = S * HD * (int)sizeof(W) / 16;
    for (int i = tid; i < n1; i += NTHREADS) dst1[i] = __ldg(src1 + (i / RC) * RS + i % RC);
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

  constexpr int OPT = D::OPT;
  // the exchange buffer and its barriers in ranks lane / 8 + 4i, where this
  // lane's pushes go (and the split head's)
  uint32_t xbuf_at[N / 4], xbar_at[N / 4];
  uint32_t hx_at[D::SPLIT_HEAD ? N / 4 : 1], hbar_at[D::SPLIT_HEAD ? N / 4 : 1];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    xbuf_at[i] = mapa(smem_u32(xbuf), (lane >> 3) + 4 * i);
    xbar_at[i] = mapa(smem_u32(&xbar[0]), (lane >> 3) + 4 * i);
    if constexpr (D::SPLIT_HEAD) {
      hx_at[i] = mapa(smem_u32(hx), (lane >> 3) + 4 * i);
      hbar_at[i] = mapa(smem_u32(&hbar), (lane >> 3) + 4 * i);
    }
  }
  // this rank's skip partials of outputs tid + NTHREADS o (those in [C, C+S))
  float skip_part[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) skip_part[o] = 0.f;
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
    if constexpr (D::RING) mbar_spin(smem_u32(&full[c % STAGES]), (uint32_t)((c / STAGES) & 1));
    PHASE(1);
    gate_tap_cond<W, CT, C, G, S, M, N>(acc, layer_slice<D>(ring, w_rank, c, 0), taps, cs, warp,
                                        lane);
    PHASE(2);

    for (int l = 0; l < L; ++l, ++c) {
      const W* stage = layer_slice<D>(ring, w_rank, c, l);
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
      if constexpr (D::RING)
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
      // out product: outputs tid + NTHREADS o, partials over this rank's z rows
      float p[OPT];
      {
        const W* wout = stage + D::WIN_E;
#pragma unroll
        for (int o = 0; o < OPT; ++o) {
          const int n = tid + NTHREADS * o;
          p[o] = 0.f;
          if (n < NO)
#pragma unroll
            for (int i = 0; i < GN; ++i) p[o] = fmaf(z[i], to_f32(wout[i * NO + n]), p[o]);
        }
      }
      PHASE(5);
      // the residual partials to every rank (the skip partials, summed over
      // the layers, at the last layer): 4 columns a lane, gathered by shuffles
#pragma unroll
      for (int o = 0; o < OPT; ++o) {
        const int n0 = 32 * warp + NTHREADS * o;  // this warp's first output
        const bool res_out = n0 < C, skip_out = !res_out && n0 < NO;
        if (skip_out) skip_part[o] += p[o];
        if (last ? skip_out : res_out) {
          const float val = last ? skip_part[o] : p[o];
          const int f = lane & 7;
          const float4 v = make_float4(__shfl_sync(FULL, val, 4 * f), __shfl_sync(FULL, val, 4 * f + 1),
                                       __shfl_sync(FULL, val, 4 * f + 2),
                                       __shfl_sync(FULL, val, 4 * f + 3));
          const int col = n0 - (last ? C : 0) + 4 * f;
          const uint32_t off = 4 * ((par * N + rank) * C + col);
#pragma unroll
          for (int i = 0; i < N / 4; ++i) st_async(xbuf_at[i] + off, v, xbar_at[i] + 8 * par);
        }
        if (last && skip_out) skip_part[o] = 0.f;
      }
      if (warp == 0 && pending)
#pragma unroll
        for (int m = 0; m < XP; ++m)
          pend[m] = __ldcg(reinterpret_cast<const float2*>(queue + (size_t)slot_next[l] * C) +
                           lane + 32 * m);
      if (l == 0) {
        if (warp == 0 && lane < a.NZ) u = __ldg(a.noise + ((size_t)t * a.B + b) * a.NZ + lane);
        if (tid >= D::CB && tid < D::CB + D::CH && t + 1 < T)
          cond_next = __ldg(reinterpret_cast<const uint4*>(cond + (size_t)(t + 1) * M * sizeof(CT)) +
                            (tid - D::CB));
      }
      PHASE(6);
      // while the other ranks catch up: the next layer's tap and cond rows
      if (!last) {
        if constexpr (D::RING)
          mbar_spin(smem_u32(&full[(c + 1) % STAGES]), (uint32_t)(((c + 1) / STAGES) & 1));
        PHASE(1);
        gate_tap_cond<W, CT, C, G, S, M, N>(acc, layer_slice<D>(ring, w_rank, c + 1, l + 1),
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

    // -- head: relu (above), 1x1, relu, 1x1, in every rank; where head1 is
    //    split, rank j forms hidden values [j SN, (j+1) SN) and sends them to
    //    every rank, so every rank holds the same S values in hx
    {
      constexpr int SN = D::SN, KP = NTHREADS / SN, KH = S / KP;
      const int n = tid % SN, part = tid / SN;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll 8
      for (int k = part * KH; k < (part + 1) * KH; k += 2) {
        v0 = fmaf(hs[k], to_f32(head1[k * SN + n]), v0);
        v1 = fmaf(hs[k + 1], to_f32(head1[(k + 1) * SN + n]), v1);
      }
      hpart[part * SN + n] = v0 + v1;
    }
    __syncthreads();
    if constexpr (D::SPLIT_HEAD) {
      constexpr int SN = D::SN, KP = NTHREADS / SN;
      if (warp == 0) {  // lane: column rank SN + lane
        float v = 0.f;
#pragma unroll
        for (int part = 0; part < KP; ++part) v += hpart[part * SN + lane];
        const float h = fmaxf(a.head1_b[rank * SN + lane] + v, 0.f);
        const int f = lane & 7;
        const float4 hv = make_float4(__shfl_sync(FULL, h, 4 * f), __shfl_sync(FULL, h, 4 * f + 1),
                                      __shfl_sync(FULL, h, 4 * f + 2),
                                      __shfl_sync(FULL, h, 4 * f + 3));
        const uint32_t off = 4 * (rank * SN + 4 * f);
#pragma unroll
        for (int i = 0; i < N / 4; ++i) st_async(hx_at[i] + off, hv, hbar_at[i]);
      }
      // every rank's hidden values have landed here: arm the next step's
      mbar_spin_cluster(smem_u32(&hbar), (uint32_t)(t & 1));
      if (tid == REFILL && t + 1 < T) mbar_expect_tx(smem_u32(&hbar), HXBYTES);
    } else {
      if (tid < S) {
        float v = 0.f;
#pragma unroll
        for (int part = 0; part < D::HP; ++part) v += hpart[part * S + tid];
        hs[tid] = fmaxf(a.head1_b[tid] + v, 0.f);
      }
      __syncthreads();
    }
    {
      const float* hid = D::SPLIT_HEAD ? hx : hs;  // head1's output
      constexpr int NJ = MAX_HD / NWARPS;  // columns warp, warp + NWARPS, ...
      float v[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) v[j] = 0.f;
#pragma unroll
      for (int k = lane; k < S; k += 32) {
        const float h = hid[k];
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
    if (tid >= D::CB && tid < D::CB + D::CH)
      Vec<CT>::to_f32(cond_next, cs + (tid - D::CB) * Vec<CT>::N);
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

// Launches the kernel, or only reports in *clusters how many of its clusters
// the card holds at once (when clusters is not null).
template <typename W, typename CT, int C, int G, int S, int M, int N>
int launch(const Args& a, const Dilations& dl, cudaStream_t stream, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = launch_config<W, CT, C, G, S, M, N>(a, &cfg, &attr, stream);
  if (err != cudaSuccess) return err;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, ar_sampler_kernel<W, CT, C, G, S, M, N>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters) {
    *clusters = fit;
    return cudaSuccess;
  }
  if (fit < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, ar_sampler_kernel<W, CT, C, G, S, M, N>, a, dl);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C, int G, int S, int M, int N>
int launch_dims(const Args& a, const Dilations& dl, int weights_bf16, int cond_bf16,
                cudaStream_t st, int* clusters) {
  if (weights_bf16)
    return cond_bf16 ? launch<bf16, bf16, C, G, S, M, N>(a, dl, st, clusters)
                     : launch<bf16, float, C, G, S, M, N>(a, dl, st, clusters);
  return cond_bf16 ? launch<float, bf16, C, G, S, M, N>(a, dl, st, clusters)
                   : launch<float, float, C, G, S, M, N>(a, dl, st, clusters);
}

constexpr int RANKS = 8;  // blocks per cluster

int run(const Args& a, const int* dilations, int c, int g, int s, int m, int hd, int k,
        int gaussian, int weights_bf16, int cond_bf16, int n_ranks, cudaStream_t st,
        int* clusters) {
  const bool teacher_lj = c == 128 && g == 256 && s == 128 && m == 80;
  const bool tiny = c == 64 && g == 128 && s == 64 && m == 40;
  const bool wide = c == 256 && g == 512 && s == 256 && m == 80;
  if (!(teacher_lj || tiny || wide) || n_ranks != RANKS || a.B < 1 || a.T < 1 || a.L < 1 ||
      a.L > MAX_L)
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
    return launch_dims<128, 256, 128, 80, RANKS>(args, dl, weights_bf16, cond_bf16, st,
                                                 clusters);
  if (wide)
    return launch_dims<256, 512, 256, 80, RANKS>(args, dl, weights_bf16, cond_bf16, st,
                                                 clusters);
  return launch_dims<64, 128, 64, 40, RANKS>(args, dl, weights_bf16, cond_bf16, st,
                                             clusters);
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

// How many of the sampler's clusters (one per batch row) the card holds at
// once for these widths and types; returns a cudaError_t.
int pwn_ar_sample_max_clusters(int L, int c, int g, int s, int m, int hd, int k,
                               int gaussian, int weights_bf16, int cond_bf16, int n_ranks,
                               int* clusters) {
  Args a = {};
  a.B = 1; a.T = 1; a.L = L; a.HD = hd;
  int dil[MAX_L];
  for (int l = 0; l < MAX_L; ++l) dil[l] = 1;
  if (L < 1 || L > MAX_L) return cudaErrorInvalidValue;
  return run(a, dil, c, g, s, m, hd, k, gaussian, weights_bf16, cond_bf16, n_ranks, nullptr,
             clusters);
}

}  // extern "C"
