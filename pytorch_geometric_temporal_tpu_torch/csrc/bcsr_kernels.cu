// Hybrid block-sparse SpMM kernels for Hopper (sm_90a), C ABI for ctypes.
//
// Two kernels carry every large-graph aggregation of the port
// (ops/bcsr.py: bcsr_matmul), forward and, on the transposed half, backward:
//
// K1  pgtt_tile_spmm — replaces the Pallas tile kernel
//     pytorch_geometric_temporal_tpu/ops/bcsr.py:_tile_kernel_call (:546).
//     out[rb] = sum over the stored 128x128 tiles t of row block rb of
//     blocks[t] @ x[block_cols[t]], accumulated in f32, written as f32.
//
// K2  pgtt_rem_scatter — replaces the Pallas remainder kernel
//     pytorch_geometric_temporal_tpu/ops/bcsr.py:_rem_scatter_call (:612)
//     together with its XLA row gather x[rem_cols] (:685-686).
//     out[rb*128 + lrow] += val * x[col] over the COO remainder edges of each
//     row block, IN PLACE on K1's output (the Pallas kernel aliases that
//     output with input_output_aliases; here the same buffer is updated).
//     The edges come without the Pallas layout's 128-edge chunk padding.
//
// What bounds them on an H100: bytes.  At the DCRNN slice (N=50k, F=96,
// bf16 tiles at ~10% occupancy) K1 moves ~38 MB of tiles for ~3.7 GFLOP,
// about 100 flop/byte, under the ~295 flop/byte at which bf16 tensor cores
// would bind; K2 is a gather of ~100k scattered rows.  What the design does
// about it:
//  - The TPU grid ran steps in order and carried the output block across
//    same-row steps (zeroed on a row's first step).  Blocks run in no order
//    here, so one CTA owns one (row block, feature tile) and loops over that
//    row's tiles (K1) or remainder edges (K2) itself, from host-built row
//    pointers over the row-sorted tile / edge lists: no atomics, no
//    cross-CTA carry, deterministic sums.  K1 is launched over EVERY row
//    block, so rows without tiles are written as zeros (the dummy slots and
//    the `pack` layout of the TPU step lists are not needed).
//  - Each tile and each x column block is read once per feature tile; the
//    feature tile is 64 or 128 wide, so at F <= 128 every byte is read once.
//  - K2 reads x[rem_cols] inside the kernel (no materialized gather buffer)
//    with the 32 lanes of a warp on 32 neighbouring features of one row, and
//    accumulates in a shared-memory block that each lane indexes only in its
//    own column: conflict-free and without atomics.
//  - bf16 tiles multiply on the tensor cores with warp-level mma.sync
//    (m16n8k16, f32 accumulate) over shared-memory chunks; f32 tiles use
//    plain FMA on CUDA cores, which keeps f32 products exact (TF32 would
//    round them).  No double buffering yet: wgmma/TMA is later work.
//
// Numerics follow the Pallas kernels: bf16 tiles take bf16 x (the wrapper
// casts), products are exact in f32 and summed in f32; in the bf16 path the
// remainder values are rounded to bf16 (the Pallas one-hot is cast to the
// activation dtype, ops/bcsr.py:642).  No F padding: any F, ragged edge
// masked.
//
// Every entry point launches on the given stream, allocates nothing, does
// not synchronise and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLK = 128;      // tile edge (ops/bcsr.py BLOCK)
constexpr int KC = 32;        // K1 f32: K chunk staged in smem
constexpr int K1_THREADS = 256;
constexpr int RFT = 32;       // K2: features per CTA (one warp)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// remainder value in the activation dtype (bf16 path rounds, f32 keeps)
__device__ __forceinline__ float rem_val(float v, const float*) { return v; }
__device__ __forceinline__ float rem_val(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// K1, f32 tiles.  Grid (num_row_blocks, ceil(F / FT)); 256 threads as a
// 16x16 grid, thread (ty, tx) owns rows ty + 16 i (i < 8) and features
// tx + 16 j (j < FT / 16) of the 128 x FT output block, accumulated in
// registers with FMA over 32-wide K chunks staged in shared memory.
template <int FT>
__global__ void __launch_bounds__(K1_THREADS)
tile_spmm_f32_kernel(const float* __restrict__ blocks,
                     const int* __restrict__ tile_ptr,
                     const int* __restrict__ block_cols,
                     const float* __restrict__ x, float* __restrict__ out,
                     int F) {
  constexpr int TN = FT / 16;
  __shared__ float As[KC][BLK + 1];  // As[k][r] = tile[r][k0 + k]
  __shared__ float Bs[KC][FT];       // Bs[k][f] = x[col0 + k0 + k][f0 + f]
  const int rb = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int t_end = tile_ptr[rb + 1];
  for (int t = tile_ptr[rb]; t < t_end; ++t) {
    const float* tile = blocks + (size_t)t * BLK * BLK;
    const size_t xrow0 = (size_t)block_cols[t] * BLK;
    for (int k0 = 0; k0 < BLK; k0 += KC) {
      for (int i = threadIdx.x; i < BLK * KC; i += K1_THREADS) {
        const int r = i / KC, k = i % KC;
        As[k][r] = tile[r * BLK + k0 + k];
      }
      for (int i = threadIdx.x; i < KC * FT; i += K1_THREADS) {
        const int k = i / FT, f = i % FT;
        Bs[k][f] = (f0 + f < F) ? x[(xrow0 + k0 + k) * (size_t)F + f0 + f]
                                : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[8], b[TN];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = (size_t)rb * BLK + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f < F) out[row * F + f] = acc[i][j];
    }
  }
}

// K1, bf16 tiles.  Grid (num_row_blocks, ceil(F / FT)); 8 warps, warp w
// owns output rows 16 w .. 16 w + 15 and all FT features as FT / 8 mma
// n-tiles held in registers.  Per tile, 64-wide K chunks of the tile (A,
// 128 x 64) and of the x column block (B, 64 x FT) are staged in shared
// memory; fragments follow the PTX layout of mma.m16n8k16 .row.col:
// A regs hold (row g | g+8, cols 2t, 2t+1 | +8), B regs (rows 2t, 2t+1 |
// +8, col g), C (row g | g+8, cols 2t, 2t+1), g = lane / 4, t = lane % 4.
constexpr int MKC = 64;       // K chunk of the mma kernel
constexpr int APAD = 8;       // row padding (bf16) against bank conflicts

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int FT>
__global__ void __launch_bounds__(K1_THREADS)
tile_spmm_mma_kernel(const __nv_bfloat16* __restrict__ blocks,
                     const int* __restrict__ tile_ptr,
                     const int* __restrict__ block_cols,
                     const __nv_bfloat16* __restrict__ x,
                     float* __restrict__ out, int F) {
  constexpr int NT = FT / 8;  // mma n-tiles per warp
  __shared__ __align__(16) uint16_t As[BLK][MKC + APAD];
  __shared__ __align__(16) uint16_t Bs[MKC][FT + APAD];
  const int rb = blockIdx.x;
  const int f0 = blockIdx.y * FT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  const int t_end = tile_ptr[rb + 1];
  for (int tile_i = tile_ptr[rb]; tile_i < t_end; ++tile_i) {
    const uint4* tile = reinterpret_cast<const uint4*>(
        blocks + (size_t)tile_i * BLK * BLK);
    const size_t xrow0 = (size_t)block_cols[tile_i] * BLK;
    for (int k0 = 0; k0 < BLK; k0 += MKC) {
      // A chunk: 128 rows x 64 bf16 = 8 x 16-byte segments per row
      for (int i = threadIdx.x; i < BLK * (MKC / 8); i += K1_THREADS) {
        const int r = i / (MKC / 8), seg = i % (MKC / 8);
        *reinterpret_cast<uint4*>(&As[r][seg * 8]) =
            tile[(r * BLK + k0 + seg * 8) / 8];
      }
      // B chunk: 64 rows of x, FT features (zero past F)
      for (int i = threadIdx.x; i < MKC * FT; i += K1_THREADS) {
        const int k = i / FT, f = i % FT;
        Bs[k][f] = (f0 + f < F) ? xb[(xrow0 + k0 + k) * (size_t)F + f0 + f]
                                : uint16_t(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < MKC; kk += 16) {
        const uint32_t a0 =
            *reinterpret_cast<const uint32_t*>(&As[r0 + g][kk + 2 * t]);
        const uint32_t a1 =
            *reinterpret_cast<const uint32_t*>(&As[r0 + g + 8][kk + 2 * t]);
        const uint32_t a2 =
            *reinterpret_cast<const uint32_t*>(&As[r0 + g][kk + 2 * t + 8]);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(
            &As[r0 + g + 8][kk + 2 * t + 8]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = j * 8 + g;
          const uint32_t b0 = uint32_t(Bs[kk + 2 * t][n]) |
                              (uint32_t(Bs[kk + 2 * t + 1][n]) << 16);
          const uint32_t b1 = uint32_t(Bs[kk + 2 * t + 8][n]) |
                              (uint32_t(Bs[kk + 2 * t + 9][n]) << 16);
          mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
        }
      }
      __syncthreads();
    }
  }
  const size_t row_a = (size_t)rb * BLK + r0 + g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int f = f0 + j * 8 + 2 * t;
    if (f < F) {
      out[row_a * F + f] = acc[j][0];
      out[(row_a + 8) * F + f] = acc[j][2];
    }
    if (f + 1 < F) {
      out[row_a * F + f + 1] = acc[j][1];
      out[(row_a + 8) * F + f + 1] = acc[j][3];
    }
  }
}

// K2.  Grid (number of row blocks with remainder edges, ceil(F / 32));
// one warp, lane = feature.  The 128 x 32 output block lives in shared
// memory (the whole block is read and written back, rows without an edge
// included); lane l only ever touches column l, so no barrier is needed.
template <typename T>
__global__ void __launch_bounds__(32)
rem_scatter_kernel(const int* __restrict__ rem_rbs,
                   const int* __restrict__ rem_ptr,
                   const int* __restrict__ rem_cols,
                   const float* __restrict__ rem_vals,
                   const int* __restrict__ rem_lrows,
                   const T* __restrict__ x, float* __restrict__ out, int F) {
  __shared__ float acc[BLK][RFT];
  const int lane = threadIdx.x;
  const int f = blockIdx.y * RFT + lane;
  const bool live = f < F;
  float* orow = out + (size_t)rem_rbs[blockIdx.x] * BLK * F;
  for (int r = 0; r < BLK; ++r)
    acc[r][lane] = live ? orow[(size_t)r * F + f] : 0.f;

  const int e_begin = rem_ptr[blockIdx.x];
  const int e_end = rem_ptr[blockIdx.x + 1];
  for (int e0 = e_begin; e0 < e_end; e0 += 32) {
    const int e = e0 + lane;
    int col = 0, lrow = 0;
    float val = 0.f;
    if (e < e_end) {
      col = rem_cols[e];
      lrow = rem_lrows[e];
      val = rem_val(rem_vals[e], x);
    }
    const int n = min(32, e_end - e0);
#pragma unroll 8
    for (int u = 0; u < 32; ++u) {
      const int cu = __shfl_sync(0xffffffffu, col, u);
      const int lu = __shfl_sync(0xffffffffu, lrow, u);
      const float vu = __shfl_sync(0xffffffffu, val, u);
      if (u < n && live)
        acc[lu][lane] = fmaf(vu, to_f(x[(size_t)cu * F + f]), acc[lu][lane]);
    }
  }
  if (live)
    for (int r = 0; r < BLK; ++r) orow[(size_t)r * F + f] = acc[r][lane];
}

template <typename T, typename Kernel64, typename Kernel128>
int launch_tile(Kernel64 k64, Kernel128 k128, const void* blocks,
                const int* tile_ptr, const int* block_cols, const void* x,
                float* out, int num_row_blocks, int F, cudaStream_t s) {
  const T* b = static_cast<const T*>(blocks);
  const T* xx = static_cast<const T*>(x);
  if (F <= 64) {
    dim3 grid(num_row_blocks, (F + 63) / 64);
    k64<<<grid, K1_THREADS, 0, s>>>(b, tile_ptr, block_cols, xx, out, F);
  } else {
    dim3 grid(num_row_blocks, (F + 127) / 128);
    k128<<<grid, K1_THREADS, 0, s>>>(b, tile_ptr, block_cols, xx, out, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  blocks (>= nnzb, 128, 128) f32 or bf16 (is_bf16); tile_ptr
// (num_row_blocks + 1) int32 row pointers over the row-sorted tiles;
// block_cols (nnzb) int32; x (num_cols, F) in the tiles' dtype; out
// (num_row_blocks * 128, F) f32, fully written.
int pgtt_tile_spmm(const void* blocks, int is_bf16, const int* tile_ptr,
                   const int* block_cols, const void* x, float* out,
                   int num_row_blocks, int F, void* stream) {
  if (num_row_blocks == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tile<__nv_bfloat16>(
        tile_spmm_mma_kernel<64>, tile_spmm_mma_kernel<128>, blocks,
        tile_ptr, block_cols, x, out, num_row_blocks, F, s);
  return launch_tile<float>(tile_spmm_f32_kernel<64>,
                            tile_spmm_f32_kernel<128>, blocks, tile_ptr,
                            block_cols, x, out, num_row_blocks, F, s);
}

// K2.  rem_rbs (num_rbs) int32 row blocks that own remainder edges,
// ascending; rem_ptr (num_rbs + 1) int32 edge pointers; rem_cols,
// rem_vals (f32), rem_lrows: (num_rem) per-edge arrays grouped by row
// block; x (num_cols, F) f32 or bf16 (is_bf16); out (num_rows, F) f32,
// updated in place.
int pgtt_rem_scatter(const int* rem_rbs, const int* rem_ptr,
                     const int* rem_cols, const float* rem_vals,
                     const int* rem_lrows, const void* x, int is_bf16,
                     float* out, int num_rbs, int F, void* stream) {
  if (num_rbs == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(num_rbs, (F + RFT - 1) / RFT);
  if (is_bf16) {
    rem_scatter_kernel<__nv_bfloat16><<<grid, 32, 0, s>>>(
        rem_rbs, rem_ptr, rem_cols, rem_vals, rem_lrows,
        static_cast<const __nv_bfloat16*>(x), out, F);
  } else {
    rem_scatter_kernel<float><<<grid, 32, 0, s>>>(
        rem_rbs, rem_ptr, rem_cols, rem_vals, rem_lrows,
        static_cast<const float*>(x), out, F);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
