// Edge-mode ASTGCN's hop 1 for Hopper (sm_90a), C ABI for ctypes.
//
//   out[b, r] = sum over the entries e: s_e -> r of w[b, e] * x[b, s_e]
//
// over the entries of the reversed scaled Laplacian (E + 2N of them and
// their padding), with a weight per batch and entry (the attention-scaled
// norm, models/attention/astgcn.py ChebConvAttention) and rows of
// P = T * F values: a (b, node) row of the (B, T, N, F) tensor.
//
// It replaces no TPU kernel: the JAX package computes hop 1 with XLA's
// gather and segment sum and has no Pallas kernel for weights per batch and
// entry.  It was added because PyTorch's generic path formed per-edge
// messages: an index_select into (B, t, E', F), a multiply and index_add_
// with atomics forward, two more gathers, a multiply and a sum backward,
// ~25 GiB of messages written and read back a train step at B = 32,
// N = 11,160, P = 768.
//
// What bounds it on an H100: bytes.  A train step needs x read and out
// written forward, g and x read, g_x and g_w (B, E') written backward:
// ~5.7 GB at those shapes, ~1.7 ms at 3.35 TB/s.  Each product is one FMA
// a gathered value, far under the card's FMA rate.  What the design does
// about it:
//  - Forward is a segment sum by receiver over a CSR order of the entries
//    (row pointers, the sender of each entry and its index in the entry
//    list, built on the device once per graph instance): one warp owns one
//    (batch, receiver) row, walks its entries, reads w[b, entry] where it
//    lies and gathers the sender rows with 16-byte loads, sums them in
//    registers in the CSR's order and writes the row once.  No message is
//    formed, nothing is zero-filled first and nothing is added atomically,
//    so two runs give the same bits.
//  - Backward is one pass by sender over the CSR order by sender: a warp
//    loads x[b, u] once, walks u's entries gathering g[b, r_e], sums
//    g_x[b, u] = sum w[b, e] g[b, r_e] in registers and writes
//    g_w[b, e] = sum_p g[b, r_e, p] x[b, u, p], reduced across the warp by
//    shuffles in a fixed order.  Each entry has one sender, so each g_w is
//    written by one warp.
//  - Each (b, node) row is P contiguous values, t-major (T runs of F),
//    read and written with 16-byte loads and stores where P and the
//    strides allow; the wrapper copies an operand whose rows lie
//    otherwise (a block's T_0: runs of T or F with gaps) and counts the
//    bytes: block 2's T_0 costs a read and a write, ~2.2 GB a forward,
//    outside the bound above.  The output is written into an (N, B, T, F) buffer, which the
//    Chebyshev combination's batched GEMM and the fused kernel's
//    flattening read without a copy.
//  - A block takes WARPS x ROWS consecutive rows of one batch and the next
//    block the next ones, so the rows a banded graph gathers are read from
//    L2 by their neighbours.
//  - A row longer than a warp's registers hold (32 lanes x 8 units) is
//    walked in chunks; backward sums g_w over the chunks in the same warp.
//
// f32 only (the wrapper refuses other types); sums in f32.  Every entry
// point launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// A block's shape, the best of those timed at the benchmark cell's shapes
// on an H100 (4, 8, 16 or 32 warps a block, 1 to 64 rows a warp): more
// rows a block keep fewer of the gathered rows in L2 and gain nothing
// from L1.
constexpr int WARPS = 4;  // warps a block
constexpr int ROWS = 2;   // rows a warp, WARPS apart
constexpr unsigned FULL = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Forward.  Grid (ceil(N / (WARPS x ROWS)), B); warp w of block i owns
// receiver rows (i * ROWS + j) * WARPS + w of batch blockIdx.y and walks
// each row's chunks of CH values in turn; lane l holds values
// (u * 32 + l) * VEC .. + VEC of a chunk.
template <int VEC, int UNITS>
__global__ void __launch_bounds__(WARPS * 32)
weighted_hop_fwd_kernel(const float* __restrict__ x, int64_t xsb, int64_t xsn,
                        const float* __restrict__ w, int64_t wsb,
                        int64_t wse, const int* __restrict__ ptr,
                        const int* __restrict__ col,
                        const int* __restrict__ ent, float* __restrict__ out,
                        int64_t osb, int64_t osn, int N, int P, int CH,
                        int nch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const float* xb = x + b * xsb;
  const float* wb = w + b * wsb;
  for (int j = 0; j < ROWS; ++j) {
  const int r = (blockIdx.x * ROWS + j) * WARPS + warp;
  if (r >= N) break;
  float* orow = out + b * osb + r * osn;
  const int beg = ptr[r], end = ptr[r + 1];
  for (int c = 0; c < nch; ++c) {
    const int start = c * CH, len = min(CH, P - start);
    float acc[UNITS][VEC];
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;
    for (int k0 = beg; k0 < end; k0 += 32) {
      const int n = min(32, end - k0);
      int s_l = 0;
      float w_l = 0.f;
      if (lane < n) {
        s_l = col[k0 + lane];
        w_l = wb[ent[k0 + lane] * wse];
      }
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const int s = __shfl_sync(FULL, s_l, j);
        const float we = __shfl_sync(FULL, w_l, j);
        const float* xr = xb + s * xsn + start;
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
          const int i = (u * 32 + lane) * VEC;
          if (i < len) {
            float v[VEC];
            load<VEC>(xr + i, v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[u][e] = fmaf(we, v[e], acc[u][e]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int i = (u * 32 + lane) * VEC;
      if (i < len) store<VEC>(orow + start + i, acc[u]);
    }
  }
  }
}

// Backward.  Grid as the forward's; warp w of block i owns sender rows u
// of batch blockIdx.y, chunked as the forward's.  gx or gw null: that
// output is not needed.
template <int VEC, int UNITS>
__global__ void __launch_bounds__(WARPS * 32)
weighted_hop_bwd_kernel(const float* __restrict__ g, int64_t gsb, int64_t gsn,
                        const float* __restrict__ x, int64_t xsb,
                        int64_t xsn, const float* __restrict__ w,
                        int64_t wsb, int64_t wse, const int* __restrict__ ptr,
                        const int* __restrict__ col,
                        const int* __restrict__ ent, float* __restrict__ gx,
                        int64_t gxsb, int64_t gxsn, float* __restrict__ gw,
                        int64_t gwsb, int N, int P, int CH, int nch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const float* gb = g + b * gsb;
  const float* wb = w + b * wsb;
  float* gwb = gw ? gw + b * gwsb : nullptr;
  for (int j = 0; j < ROWS; ++j) {
  const int u0 = (blockIdx.x * ROWS + j) * WARPS + warp;
  if (u0 >= N) break;
  const float* xrow = x + b * xsb + u0 * xsn;
  const int beg = ptr[u0], end = ptr[u0 + 1];
  for (int c = 0; c < nch; ++c) {
    const int start = c * CH, len = min(CH, P - start);
    float xv[UNITS][VEC];
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int i = (u * 32 + lane) * VEC;
      if (gwb && i < len) {
        load<VEC>(xrow + start + i, xv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv[u][e] = 0.f;
      }
    }
    float acc[UNITS][VEC];
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;
    for (int k0 = beg; k0 < end; k0 += 32) {
      const int n = min(32, end - k0);
      int r_l = 0, e_l = 0;
      float w_l = 0.f;
      if (lane < n) {
        r_l = col[k0 + lane];
        e_l = ent[k0 + lane];
        if (gx) w_l = wb[e_l * wse];
      }
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const int r = __shfl_sync(FULL, r_l, j);
        const float we = __shfl_sync(FULL, w_l, j);
        const float* gr = gb + r * gsn + start;
        float d = 0.f;
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
          const int i = (u * 32 + lane) * VEC;
          if (i < len) {
            float v[VEC];
            load<VEC>(gr + i, v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              acc[u][e] = fmaf(we, v[e], acc[u][e]);
              d = fmaf(v[e], xv[u][e], d);
            }
          }
        }
        if (gwb) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
          const int e = __shfl_sync(FULL, e_l, j);
          if (lane == 0) gwb[e] = c == 0 ? d : gwb[e] + d;
        }
      }
    }
    if (gx) {
      float* grow = gx + b * gxsb + u0 * gxsn + start;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int i = (u * 32 + lane) * VEC;
        if (i < len) store<VEC>(grow + i, acc[u]);
      }
    }
  }
  }
}

dim3 grid(int N, int B) {
  return dim3((N + WARPS * ROWS - 1) / (WARPS * ROWS), B);
}

template <int VEC, int UNITS>
int fwd(const float* x, int64_t xsb, int64_t xsn, const float* w,
        int64_t wsb, int64_t wse, const int* ptr, const int* col,
        const int* ent, float* out, int64_t osb, int64_t osn, int B, int N,
        int P, int CH, int nch, cudaStream_t s) {
  weighted_hop_fwd_kernel<VEC, UNITS><<<grid(N, B), WARPS * 32, 0, s>>>(
      x, xsb, xsn, w, wsb, wse, ptr, col, ent, out, osb, osn, N, P, CH, nch);
  return (int)cudaGetLastError();
}

template <int VEC, int UNITS>
int bwd(const float* g, int64_t gsb, int64_t gsn, const float* x,
        int64_t xsb, int64_t xsn, const float* w, int64_t wsb, int64_t wse,
        const int* ptr, const int* col, const int* ent, float* gx,
        int64_t gxsb, int64_t gxsn, float* gw, int64_t gwsb, int B, int N,
        int P, int CH, int nch, cudaStream_t s) {
  weighted_hop_bwd_kernel<VEC, UNITS><<<grid(N, B), WARPS * 32, 0, s>>>(
      g, gsb, gsn, x, xsb, xsn, w, wsb, wse, ptr, col, ent, gx, gxsb, gxsn,
      gw, gwsb, N, P, CH, nch);
  return (int)cudaGetLastError();
}

// the (VEC, UNITS) pairs built: 16-byte units, 1 to 8 a lane, or single
// values 8 a lane (rows off the 16-byte grid)
#define PGTT_HOP_DISPATCH(FN, ...)                                     \
  switch (vec * 16 + units) {                                          \
    case 4 * 16 + 1: return FN<4, 1>(__VA_ARGS__);                     \
    case 4 * 16 + 2: return FN<4, 2>(__VA_ARGS__);                     \
    case 4 * 16 + 4: return FN<4, 4>(__VA_ARGS__);                     \
    case 4 * 16 + 6: return FN<4, 6>(__VA_ARGS__);                     \
    case 4 * 16 + 8: return FN<4, 8>(__VA_ARGS__);                     \
    case 1 * 16 + 8: return FN<1, 8>(__VA_ARGS__);                     \
    default: return (int)cudaErrorInvalidValue;                        \
  }

}  // namespace

extern "C" {

// Forward: out rows (b, r), r < N, from x rows (b, s).  Row (b, n) of x
// is P contiguous values at x + b * xsb + n * xsn, and of out at
// out + b * osb + n * osn; w[b, e] at w + b * wsb + e * wse; (ptr, col,
// ent): the CSR order by receiver; nch chunks of CH values a row.
int pgtt_weighted_hop_fwd(const float* x, int64_t xsb, int64_t xsn,
                          const float* w, int64_t wsb, int64_t wse,
                          const int* ptr, const int* col, const int* ent,
                          float* out, int64_t osb, int64_t osn, int B, int N,
                          int P, int CH, int nch, int vec, int units,
                          void* stream) {
  if (B == 0 || N == 0 || P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PGTT_HOP_DISPATCH(fwd, x, xsb, xsn, w, wsb, wse, ptr, col, ent, out, osb,
                    osn, B, N, P, CH, nch, s)
}

// Backward: g_x rows (b, u), u < N (senders), and g_w (B, E') at
// gw + b * gwsb + e, from g's rows (b, r) and x's rows (b, u), each P
// contiguous values; (ptr, col, ent): the CSR order by sender.  gx or gw
// may be null.
int pgtt_weighted_hop_bwd(const float* g, int64_t gsb, int64_t gsn,
                          const float* x, int64_t xsb, int64_t xsn,
                          const float* w, int64_t wsb, int64_t wse,
                          const int* ptr, const int* col, const int* ent,
                          float* gx, int64_t gxsb, int64_t gxsn, float* gw,
                          int64_t gwsb, int B, int N, int P, int CH, int nch,
                          int vec, int units, void* stream) {
  if (B == 0 || N == 0 || P == 0 || (!gx && !gw)) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PGTT_HOP_DISPATCH(bwd, g, gsb, gsn, x, xsb, xsn, w, wsb, wse, ptr, col, ent,
                    gx, gxsb, gxsn, gw, gwsb, B, N, P, CH, nch, s)
}

}  // extern "C"
