// An ASTGCN block's tail for Hopper (sm_90a), C ABI for ctypes: the
// elementwise part of
//
//   z = relu(pre + b_time + b_res)
//   y = (z - mean) * (rsqrt(var + eps) * gamma) + beta,
//   mean = E[z], var = max(E[z^2] - mean^2, 0) over a row's C channels
//
// where pre = xt @ W_res + sum_k shift_k(xh) @ W_time[k] is the time and
// residual convolutions' sum, which plain GEMMs write beforehand
// (ops/block_tail.py; models/attention/astgcn.py _BlockTail).  A row is
// one (b, t, n) of the (B, T, N, C) tensors, its C channels contiguous.
//
// It replaces no TPU kernel: the JAX package's block tail is flax's Conv
// and LayerNorm, which XLA fuses on its own.  It was added because PyTorch
// ran the tail as ~9 elementwise passes forward and ~17 backward over
// (B, T, N, C) tensors, most of them strided (the convolutions' NCHW output
// put the channels N * T apart), plus the copies into cuDNN's layout: ~58 S
// a block at S = one such tensor, 1.1 GB at the benchmark cell's B = 32,
// N = 11,160, T = 12, C = 64.
//
// What bounds it on an H100: bytes.  The forward reads pre and writes y
// and two floats a row: ~2 S; the backward reads the gradient and pre and
// writes the gradient of pre: ~3 S (~0.7 and ~1.0 ms at 3.35 TB/s).  A row
// takes a few dozen FLOPs a value.  What the design does about it:
//  - A group of L lanes (L the power of two with 4 L >= C) owns a row,
//    each lane one float4 of it: one 16-byte load of each operand and one
//    store, the row's sums over a butterfly of shuffles in the group, so
//    every lane ends with the same bits.  A warp takes 32 / L rows at a
//    time; the grid strides over the rows.
//  - The forward keeps each row's (mean, variance before the clip) for the
//    backward, which recomputes z and x-hat from pre: nothing else is kept.
//  - The backward writes g_pre, the gradient of both convolutions'
//    outputs, once, and sums g * x-hat (gamma's gradient), g (beta's) and
//    g_pre (each bias's) over its rows in registers, then over a CTA's
//    rows through shared memory, into per-CTA partial sums that a second
//    launch adds in a fixed order: no atomics, so two runs give the same
//    bits.  The gradient's rows are read where they lie (row strides by
//    b, t and n, channels contiguous): the ASTGCN head's gradient puts a
//    row's channels together but not the rows in (b, t, n) order.
//
// f32 only, C a multiple of 4 up to 128 (the wrapper refuses the rest);
// sums in f32.  Every entry point launches on the given stream, allocates
// nothing, does not synchronise and returns cudaGetLastError() (0 on
// success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int SUM_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// the sum over a group of L lanes, the same bits in each of them
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// lane l of a group holds channels 4l .. 4l + 3 (none where 4l >= C):
// both biases summed, gamma and beta
struct Channels {
  float bias[4], gamma[4], beta[4];
  bool on;
};

__device__ __forceinline__ Channels channels(int c0, int C, const float* bt,
                                             const float* br,
                                             const float* gamma,
                                             const float* beta) {
  Channels ch;
  ch.on = c0 < C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ch.bias[i] = ch.on ? __ldg(bt + c0 + i) + __ldg(br + c0 + i) : 0.f;
    ch.gamma[i] = ch.on ? __ldg(gamma + c0 + i) : 0.f;
    ch.beta[i] = ch.on && beta ? __ldg(beta + c0 + i) : 0.f;
  }
  return ch;
}

// Forward.  Warp w takes rows (w + k * warps) * (32 / L) + lane / L.
template <int L>
__global__ void __launch_bounds__(THREADS)
block_tail_fwd_kernel(const float* __restrict__ pre,
                      const float* __restrict__ bt,
                      const float* __restrict__ br,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ y,
                      float2* __restrict__ stats, int rows, int C,
                      float eps) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31, c0 = 4 * (lane % L);
  const Channels ch = channels(c0, C, bt, br, gamma, beta);
  const int warps = gridDim.x * (THREADS / 32);
  const float fc = static_cast<float>(C);
  for (int r0 = (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * G;
       r0 < rows; r0 += warps * G) {
    const int r = r0 + lane / L;
    const bool live = ch.on && r < rows;
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      load4(pre + static_cast<int64_t>(r) * C + c0, z);
#pragma unroll
      for (int i = 0; i < 4; ++i) z[i] = fmaxf(z[i] + ch.bias[i], 0.f);
    }
    float s1 = (z[0] + z[1]) + (z[2] + z[3]);
    float s2 = fmaf(z[0], z[0], z[1] * z[1]) + fmaf(z[2], z[2], z[3] * z[3]);
    s1 = group_sum<L>(s1);
    s2 = group_sum<L>(s2);
    const float mean = s1 / fc;
    const float var = s2 / fc - mean * mean;
    const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
    if (live) {
      float out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[i] = (z[i] - mean) * (rstd * ch.gamma[i]) + ch.beta[i];
      store4(y + static_cast<int64_t>(r) * C + c0, out);
      if (c0 == 0) stats[r] = make_float2(mean, var);
    }
  }
}

// Backward.  Rows as the forward's; row r = (b * T + t) * N + n of the
// gradient at g + b * gsb + t * gst + n * gsn.  Writes g_pre and the CTA's
// sums of g * x-hat, g and g_pre by channel to partial[blockIdx.x].
template <int L>
__global__ void __launch_bounds__(THREADS)
block_tail_bwd_kernel(const float* __restrict__ g, int64_t gsb, int64_t gst,
                      int64_t gsn, int T, int N,
                      const float* __restrict__ pre,
                      const float2* __restrict__ stats,
                      const float* __restrict__ bt,
                      const float* __restrict__ br,
                      const float* __restrict__ gamma,
                      float* __restrict__ gpre, float* __restrict__ partial,
                      int rows, int C, float eps) {
  constexpr int G = 32 / L, GROUPS = THREADS / L;
  __shared__ float red[3 * GROUPS * 4 * L];
  const int lane = threadIdx.x & 31, c0 = 4 * (lane % L);
  const Channels ch = channels(c0, C, bt, br, gamma, nullptr);
  const int warps = gridDim.x * (THREADS / 32);
  const float fc = static_cast<float>(C);
  float acc[3][4] = {};
  for (int r0 = (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * G;
       r0 < rows; r0 += warps * G) {
    const int r = r0 + lane / L;
    const bool live = ch.on && r < rows;
    float gv[4] = {0.f, 0.f, 0.f, 0.f}, a[4] = {0.f, 0.f, 0.f, 0.f};
    float2 st = make_float2(0.f, 0.f);
    if (live) {
      const int n = r % N, q = r / N;
      load4(g + (q / T) * gsb + (q % T) * gst + n * gsn + c0, gv);
      load4(pre + static_cast<int64_t>(r) * C + c0, a);
      st = stats[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] += ch.bias[i];
    }
    const float rstd = rsqrtf(fmaxf(st.y, 0.f) + eps);
    float xhat[4], dy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xhat[i] = live ? (fmaxf(a[i], 0.f) - st.x) * rstd : 0.f;
      dy[i] = gv[i] * ch.gamma[i];
    }
    float s1 = (dy[0] + dy[1]) + (dy[2] + dy[3]);
    float s2 = fmaf(dy[0], xhat[0], dy[1] * xhat[1]) +
               fmaf(dy[2], xhat[2], dy[3] * xhat[3]);
    s1 = group_sum<L>(s1);
    s2 = group_sum<L>(s2);
    const float m_dy = s1 / fc;
    // the clip's gradient: none where E[z^2] - E[z]^2 fell below 0
    const float m_dyx = st.y >= 0.f ? s2 / fc : 0.f;
    if (live) {
      float gp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gp[i] = a[i] > 0.f ? rstd * (dy[i] - m_dy - xhat[i] * m_dyx) : 0.f;
        acc[0][i] = fmaf(gv[i], xhat[i], acc[0][i]);
        acc[1][i] += gv[i];
        acc[2][i] += gp[i];
      }
      store4(gpre + static_cast<int64_t>(r) * C + c0, gp);
    }
  }
  // the CTA's groups' sums, added in group order
  const int grp = threadIdx.x / L;
  if (ch.on) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[(k * GROUPS + grp) * C + c0 + i] =
          acc[k][i];
  }
  __syncthreads();
  for (int kc = threadIdx.x; kc < 3 * C; kc += THREADS) {
    const int k = kc / C, c = kc % C;
    float s = 0.f;
    for (int j = 0; j < GROUPS; ++j) s += red[(k * GROUPS + j) * C + c];
    partial[static_cast<int64_t>(blockIdx.x) * 3 * C + kc] = s;
  }
}

// sums[kc] = sum over the CTAs j of partial[j][kc], in a fixed order: a
// CTA a (k, c), each thread a stride of CTAs, then a butterfly in each
// warp and the warps in order.
__global__ void __launch_bounds__(SUM_THREADS)
block_tail_sum_kernel(const float* __restrict__ partial, int ctas, int KC,
                      float* __restrict__ sums) {
  __shared__ float warp_sums[SUM_THREADS / 32];
  const int kc = blockIdx.x;
  float s = 0.f;
  for (int j = threadIdx.x; j < ctas; j += SUM_THREADS)
    s += partial[static_cast<int64_t>(j) * KC + kc];
  s = group_sum<32>(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < SUM_THREADS / 32; ++w) t += warp_sums[w];
    sums[kc] = t;
  }
}

int grid(int rows, int lanes, int ctas) {
  const int per = THREADS / lanes;  // rows a CTA takes at a time
  const int need = (rows + per - 1) / per;
  return need < ctas ? need : ctas;
}

template <int L>
int fwd(const float* pre, const float* bt, const float* br,
        const float* gamma, const float* beta, float* y, float* stats,
        int rows, int C, float eps, int ctas, cudaStream_t s) {
  block_tail_fwd_kernel<L><<<grid(rows, L, ctas), THREADS, 0, s>>>(
      pre, bt, br, gamma, beta, y, reinterpret_cast<float2*>(stats), rows, C,
      eps);
  return (int)cudaGetLastError();
}

template <int L>
int bwd(const float* g, int64_t gsb, int64_t gst, int64_t gsn, int T, int N,
        const float* pre, const float* stats, const float* bt,
        const float* br, const float* gamma, float* gpre, float* partial,
        float* sums, int rows, int C, float eps, int ctas, cudaStream_t s) {
  const int blocks = grid(rows, L, ctas);
  block_tail_bwd_kernel<L><<<blocks, THREADS, 0, s>>>(
      g, gsb, gst, gsn, T, N, pre, reinterpret_cast<const float2*>(stats), bt,
      br, gamma, gpre, partial, rows, C, eps);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  block_tail_sum_kernel<<<3 * C, SUM_THREADS, 0, s>>>(partial, blocks, 3 * C,
                                                      sums);
  return (int)cudaGetLastError();
}

// lanes a row: the power of two with 4 * lanes >= C
#define PGTT_TAIL_DISPATCH(FN, ...)                                    \
  if (C <= 0 || C > 128 || C % 4) return (int)cudaErrorInvalidValue;   \
  if (C <= 4) return FN<1>(__VA_ARGS__);                               \
  if (C <= 8) return FN<2>(__VA_ARGS__);                               \
  if (C <= 16) return FN<4>(__VA_ARGS__);                              \
  if (C <= 32) return FN<8>(__VA_ARGS__);                              \
  if (C <= 64) return FN<16>(__VA_ARGS__);                             \
  return FN<32>(__VA_ARGS__);

}  // namespace

extern "C" {

// Forward: y and stats (rows, 2: mean, variance before the clip) from
// pre, each (rows, C) contiguous; bias_t, bias_r, gamma, beta (C,); at most
// ctas CTAs.
int pgtt_block_tail_fwd(const float* pre, const float* bias_t,
                        const float* bias_r, const float* gamma,
                        const float* beta, float* y, float* stats, int rows,
                        int C, float eps, int ctas, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PGTT_TAIL_DISPATCH(fwd, pre, bias_t, bias_r, gamma, beta, y, stats, rows,
                     C, eps, ctas, s)
}

// Backward: g_pre (rows, C) contiguous and sums (3, C: gamma's, beta's and
// each bias's gradient) from the gradient g, whose row (b, t, n) of C
// contiguous channels lies at g + b * gsb + t * gst + n * gsn (rows =
// B * T * N), pre and the forward's stats; partial holds ctas * 3 * C
// floats.
int pgtt_block_tail_bwd(const float* g, int64_t gsb, int64_t gst,
                        int64_t gsn, int T, int N, const float* pre,
                        const float* stats, const float* bias_t,
                        const float* bias_r, const float* gamma, float* g_pre,
                        float* partial, float* sums, int rows, int C,
                        float eps, int ctas, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PGTT_TAIL_DISPATCH(bwd, g, gsb, gst, gsn, T, N, pre, stats, bias_t, bias_r,
                     gamma, g_pre, partial, sums, rows, C, eps, ctas, s)
}

}  // extern "C"
