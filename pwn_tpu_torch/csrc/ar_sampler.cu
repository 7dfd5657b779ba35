// Whole-loop teacher autoregressive sampler for Hopper (sm_90a): Fast
// WaveNet with per-layer conv queues, all T steps in one launch.
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
// S=128, M=80, L=24) that is 5.9 MFLOP per row per step over 5.7 MB of bf16
// weights: by the roofline (67 TFLOP/s fp32, 3.35 TB/s), about 0.7 us per
// step at batch 8.  But the chain is serial: every step streams all the
// weights into one SM, so the real limit is one SM's read rate from L2
// (the weights stay in the 50 MB L2 across steps) plus the block barriers
// between the products.
//
// Design, and what it does about the TPU kernel's assumptions:
// * Grid order.  The TPU grid runs T steps in order on one core and carries
//   the queues and x_prev in VMEM scratch.  Here one block owns one batch
//   row and loops over all T steps itself: rows are independent, so blocks
//   never synchronise with each other, and a row cannot leak into another.
// * The queues (sum(d) x C fp32: 392 KB per row at teacher_lj) do not fit
//   in shared memory.  They live in device memory, (B, sum(d), C), zeroed by
//   the caller, and stay L2-resident.  At the start of a step the block
//   reads every layer's tap into shared memory at once (a tap was written at
//   least one step earlier, and layers use disjoint slots), so the L tap
//   reads cost one latency, not L; the writes of this step go out as the
//   layers run.  __syncthreads() orders a block's global writes before its
//   later reads.
// * The weights (5.7 MB bf16, 11.4 MB fp32) do not fit in one SM.  They are
//   read from L2 every step, W_in[l] as (K, G) row-major: thread (column
//   group, k slice) loads 16 bytes of a row (8 bf16 or 4 fp32 columns) for
//   every NS-th row, up to 8 rows in flight, and keeps fp32 partial sums;
//   neighbouring threads read neighbouring addresses.  The k slices are
//   summed through shared memory in a fixed order.
// * Numerics are the reference's: fp32 FMAs on the CUDA cores, IEEE
//   tanhf/expf/logf/log1pf (no fast-math), sigmoid as 1/(1+exp(-x)).
//   Splitting one row's layers over a cluster of SMs, with the weights in
//   distributed shared memory, is the redesign that lifts the L2 limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 512;  // 16 warps
constexpr int MAX_L = 64;      // layers
constexpr int MAX_HD = 32;     // head width: one warp per output column
constexpr int UNROLL = 8;      // weight rows in flight per thread

struct Dilations {
  int d[MAX_L];    // dilation of layer l
  int off[MAX_L];  // first queue slot of layer l
};

struct Args {
  const void* cond;      // (B, T, M) bf16 or fp32
  const float* noise;    // (T, B, NZ): K+1 uniforms (MoL) or 1 normal
  const void* front_k;   // (1, C)
  const float* front_b;  // (1, C)
  const void* w_in;      // (L, 2C+M, G)
  const float* b_g;      // (L, G)
  const void* w_out;     // (L, G/2, C+S)
  const float* b_rs;     // (L, C+S)
  const void* head1_k;   // (S, S)
  const float* head1_b;  // (1, S)
  const void* head2_k;   // (S, HD)
  const float* head2_b;  // (1, HD)
  float* queue;          // (B, sum(d), C), zero on entry
  float* wav;            // (B, T)
  int B, T, L, HD, K, NZ, sum_d, gaussian;
  float log_scale_min, temperature;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// 16 bytes of weights: 8 bf16 or 4 fp32 columns.
template <typename W> struct Vec;
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static void to_f32(const Raw& r, float (&f)[N]) {
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
  using Raw = float4;
  __device__ static void to_f32(const Raw& r, float (&f)[N]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};

// part[s][n] = sum over rows k = s, s + NS, ... < K of in[k] * w[k][n], for
// the NS = NTHREADS / (N / V) k slices; w is (K, N) row-major.
template <typename W, int K, int N>
__device__ __forceinline__ void gemv_partial(const float* __restrict__ in,
                                             const W* __restrict__ w,
                                             float* __restrict__ part) {
  constexpr int V = Vec<W>::N;
  constexpr int NG = N / V;
  constexpr int NS = NTHREADS / NG;
  static_assert(N % V == 0 && NTHREADS % NG == 0, "column groups");
  using Raw = typename Vec<W>::Raw;
  const int cg = threadIdx.x % NG;
  const int s = threadIdx.x / NG;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  const W* wp = w + cg * V;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += UNROLL * NS) {
    Raw r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * NS + s;
      if (k0 + u * NS < K && k < K)
        r[u] = __ldg(reinterpret_cast<const Raw*>(wp + (size_t)k * N));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * NS + s;
      if (k0 + u * NS < K && k < K) {
        float f[V];
        Vec<W>::to_f32(r[u], f);
        const float a = in[k];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(a, f[i], acc[i]);
      }
    }
  }
  float* dst = part + s * N + cg * V;
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i] = acc[i];
}

// Column n of the partial sums, over the k slices in order.
template <typename W, int N>
__device__ __forceinline__ float reduce_col(const float* __restrict__ part, int n) {
  constexpr int NS = NTHREADS / (N / Vec<W>::N);
  float v[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) v[s] = part[s * N + n];
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s) sum += v[s];
  return sum;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The stack widths (C, G, S, M) are compile-time, so the products unroll.
template <typename W, typename CT, int C, int G, int S, int M>
__global__ void __launch_bounds__(NTHREADS, 1)
ar_sampler_kernel(const Args a, const Dilations dl) {
  constexpr int GH = G / 2, KIN = 2 * C + M, NO = C + S;
  static_assert(C <= NTHREADS && NO <= NTHREADS && GH <= NTHREADS, "one pass");
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = a.L, HD = a.HD, K = a.K;
  const CT* cond = static_cast<const CT*>(a.cond) + (size_t)b * a.T * M;
  const W* front_k = static_cast<const W*>(a.front_k);
  const W* w_in = static_cast<const W*>(a.w_in);
  const W* w_out = static_cast<const W*>(a.w_out);
  const W* head1_k = static_cast<const W*>(a.head1_k);
  const W* head2_k = static_cast<const W*>(a.head2_k);
  float* queue = a.queue + (size_t)b * a.sum_d * C;

  extern __shared__ float smem[];
  float* cat = smem;                   // [x | tap | cond(t)], KIN
  float* z = cat + KIN;                // GH
  float* skip = z + GH;                // S
  float* h = skip + S;                 // S
  float* hp = h + S;                   // MAX_HD head outputs
  float* part = hp + MAX_HD;           // k-slice partial sums, NTHREADS * 8
  float* taps = part + NTHREADS * 8;   // this step's taps, L x C
  __shared__ int slot[MAX_L];
  __shared__ float x_prev;

  if (tid == 0) x_prev = 0.f;
  for (int t = 0; t < a.T; ++t) {
    // -- step start: queue slots, every layer's tap, cond(t), the front 1x1
    if (tid < L) slot[tid] = dl.off[tid] + t % dl.d[tid];
    __syncthreads();
    for (int i = tid; i < L * C; i += NTHREADS) {
      const int l = i / C;
      taps[i] = queue[(size_t)slot[l] * C + (i - l * C)];
    }
    for (int m = tid; m < M; m += NTHREADS) cat[2 * C + m] = to_f32(cond[(size_t)t * M + m]);
    for (int n = tid; n < S; n += NTHREADS) skip[n] = 0.f;
    __syncthreads();
    if (tid < C) {
      const float x = __fadd_rn(__fmul_rn(x_prev, to_f32(front_k[tid])), a.front_b[tid]);
      cat[tid] = x;
      cat[C + tid] = taps[tid];
      queue[(size_t)slot[0] * C + tid] = x;
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      // gate GEMM and gated unit
      gemv_partial<W, KIN, G>(cat, w_in + (size_t)l * KIN * G, part);
      __syncthreads();
      if (tid < GH) {
        const float ga = a.b_g[l * G + tid] + reduce_col<W, G>(part, tid);
        const float gb = a.b_g[l * G + GH + tid] + reduce_col<W, G>(part, GH + tid);
        z[tid] = tanhf(ga) * (1.f / (1.f + expf(-gb)));
      }
      __syncthreads();
      // out GEMM; the residual update also stages the next layer's input
      gemv_partial<W, GH, NO>(z, w_out + (size_t)l * GH * NO, part);
      __syncthreads();
      if (tid < NO) {
        const float o = a.b_rs[l * NO + tid] + reduce_col<W, NO>(part, tid);
        if (tid < C) {
          const float x = cat[tid] + o;
          cat[tid] = x;
          if (l + 1 < L) {
            cat[C + tid] = taps[(l + 1) * C + tid];
            queue[(size_t)slot[l + 1] * C + tid] = x;
          }
        } else {
          skip[tid - C] += o;
        }
      }
      __syncthreads();
    }

    // -- head: relu, 1x1, relu, 1x1
    if (tid < S) h[tid] = fmaxf(skip[tid], 0.f);
    __syncthreads();
    gemv_partial<W, S, S>(h, head1_k, part);
    __syncthreads();
    if (tid < S) h[tid] = fmaxf(a.head1_b[tid] + reduce_col<W, S>(part, tid), 0.f);
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    for (int n = warp; n < HD; n += NTHREADS / 32) {
      float v = 0.f;
#pragma unroll
      for (int k = lane; k < S; k += 32) v = fmaf(h[k], to_f32(head2_k[k * HD + n]), v);
      v = warp_sum(v);
      if (lane == 0) hp[n] = a.head2_b[n] + v;
    }
    __syncthreads();

    // -- the sample (warp 0)
    if (warp == 0) {
      const float* u = a.noise + ((size_t)t * a.B + b) * a.NZ;
      float xt;
      if (a.gaussian) {
        const float ls = fmaxf(hp[1], a.log_scale_min);
        xt = hp[0] + expf(ls) * a.temperature * u[0];
      } else {
        const float score = lane < K ? hp[lane] - logf(-logf(u[lane])) : -INFINITY;
        const float best = warp_max(score);
        const bool pick = lane < K && score >= best;
        const int count = __popc(__ballot_sync(0xffffffffu, pick));
        const float wgt = pick ? 1.f / (float)count : 0.f;
        const float mean = warp_sum(lane < K ? hp[K + lane] * wgt : 0.f);
        const float ls = warp_sum(lane < K ? fmaxf(hp[2 * K + lane], a.log_scale_min) * wgt : 0.f);
        const float ul = u[K];
        xt = mean + expf(ls) * a.temperature * (logf(ul) - log1pf(-ul));
      }
      xt = fminf(fmaxf(xt, -1.f), 1.f);
      if (lane == 0) {
        a.wav[(size_t)b * a.T + t] = xt;
        x_prev = xt;
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int C, int G, int S, int M, int L) {
  return sizeof(float) *
         (size_t)((2 * C + M) + G / 2 + 2 * S + MAX_HD + NTHREADS * 8 + L * C);
}

template <typename W, typename CT, int C, int G, int S, int M>
int launch(const Args& a, const Dilations& dl, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, G, S, M, a.L);
  auto kernel = ar_sampler_kernel<W, CT, C, G, S, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.B, NTHREADS, smem, stream>>>(a, dl);
  return cudaGetLastError();
}

template <int C, int G, int S, int M>
int launch_dims(const Args& a, const Dilations& dl, int weights_bf16, int cond_bf16,
                cudaStream_t st) {
  if (weights_bf16)
    return cond_bf16 ? launch<bf16, bf16, C, G, S, M>(a, dl, st)
                     : launch<bf16, float, C, G, S, M>(a, dl, st);
  return cond_bf16 ? launch<float, bf16, C, G, S, M>(a, dl, st)
                   : launch<float, float, C, G, S, M>(a, dl, st);
}

}  // namespace

extern "C" {

// Runs the sampler on `stream`; returns a cudaError_t (0 on success).
// weights_bf16 / cond_bf16 select the storage type (else fp32) of the
// weights (front_k, w_in, w_out, head1_k, head2_k) and of cond.
int pwn_ar_sample(const void* cond, const void* noise, const void* front_k,
                  const void* front_b, const void* w_in, const void* b_g,
                  const void* w_out, const void* b_rs, const void* head1_k,
                  const void* head1_b, const void* head2_k, const void* head2_b,
                  void* queue, void* wav, int B, int T, int L, int c, int g, int s,
                  int m, int hd, int k, int gaussian, const int* dilations,
                  float log_scale_min, float temperature, int weights_bf16,
                  int cond_bf16, void* stream) {
  const bool teacher_lj = c == 128 && g == 256 && s == 128 && m == 80;
  const bool tiny = c == 64 && g == 128 && s == 64 && m == 40;
  if (!(teacher_lj || tiny) || B < 1 || T < 1 || L < 1 || L > MAX_L)
    return cudaErrorInvalidValue;
  if (gaussian ? hd != 2 : (k < 1 || hd != 3 * k || hd > MAX_HD))
    return cudaErrorInvalidValue;
  Dilations dl;
  int sum_d = 0;
  for (int l = 0; l < MAX_L; ++l) {
    dl.d[l] = 1;
    dl.off[l] = 0;
  }
  for (int l = 0; l < L; ++l) {
    if (dilations[l] < 1) return cudaErrorInvalidValue;
    dl.d[l] = dilations[l];
    dl.off[l] = sum_d;
    sum_d += dilations[l];
  }
  Args a;
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
  a.queue = static_cast<float*>(queue);
  a.wav = static_cast<float*>(wav);
  a.B = B; a.T = T; a.L = L;
  a.HD = hd; a.K = gaussian ? 0 : k; a.NZ = gaussian ? 1 : k + 1;
  a.sum_d = sum_d; a.gaussian = gaussian;
  a.log_scale_min = log_scale_min;
  a.temperature = temperature;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (teacher_lj) return launch_dims<128, 256, 128, 80>(a, dl, weights_bf16, cond_bf16, st);
  return launch_dims<64, 128, 64, 40>(a, dl, weights_bf16, cond_bf16, st);
}

}  // extern "C"
