// Fused hybrid block-sparse SpMM for Hopper (sm_90a), C ABI for ctypes.
//
// pgtt_hybrid_spmm computes one half of the BCSR aggregation operator in one
// launch:  out (num_rows, F) f32 = tiles @ x + remainder, written once.  It
// replaces both Pallas kernels of the JAX package's ops/bcsr.py:
//   - the tile kernel _tile_kernel_call (:546, pallas_call :602), and
//   - the remainder kernel _rem_scatter_call (:612, pallas_call :663) with
//     its XLA row gather x[rem_cols] (:685-686),
// which the port first carried over as two kernels (bcsr_kernels.cu, K1 and
// K2; they stay there as the baseline, off the main path).
//
// Numerics are those of that pair: bf16 tiles take bf16 x, products are
// exact in f32 and summed in f32; in the bf16 path the remainder values are
// rounded to bf16 (the Pallas one-hot is cast to the activation dtype,
// ops/bcsr.py:642).  For each output row the tile products come first, then
// the row's remainder edges one by one in ascending column order.
//
// What bounds it on an H100: bytes.  At the DCRNN slice (N=50k, F=96, bf16
// tiles) it moves ~68 MB (38 MB of tiles, 10 MB of x, 19 MB of f32 output)
// for ~3.7 GFLOP, ~55 flop/byte, far under the ~295 flop/byte at which the
// bf16 tensor cores would bind.  What the design does about it:
//  - Persistent CTAs, one per SM (as many as fit), each walking work items
//    item = blockIdx.x, += gridDim.x over a static list the builder makes
//    (ops/bcsr.py _kernel_items, one 32-byte descriptor a row range):
//    first the (row block, feature tile) items of the row blocks that keep
//    tiles (and of those with neither tiles nor remainder edges, which come
//    out zero), then the (remainder-only task, feature tile) items, where a
//    task is a range of rows of a row block that keeps no tile, cut so that
//    tasks hold about equal remainder edges (a row is never split; a longer
//    row is a task of its own).  Each warp copies the next item's
//    descriptor (cp.async) while the current one runs.  No tail wave; the
//    load pipeline runs on across item boundaries, so one item's epilogue
//    overlaps the next one's loads.
//  - Warp specialisation and TMA: a producer thread keeps a ring of up to
//    six ~33 KB stages (as many as shared memory holds beside the epilogue
//    block: five at F=96) full with 2-D tensor-map copies
//    (cp.async.bulk.tensor, 128-byte swizzle): per stage one 16 KB box of a
//    tile (a 128-byte-wide K chunk of its 128 rows) and the boxes of the 64
//    matching x rows (64 features each; features past F come in as zeros).
//    A stage costs a handful of instructions; 16-byte cp.async, or one
//    bulk copy per row, issued by producer warps were bound by the
//    producers' instruction issue.  The producers arrive on the stage's
//    "full" mbarrier with the bytes they expect (mbarrier.arrive.expect_tx)
//    and the copies complete it; the consumers hand a stage back through
//    an "empty" mbarrier.
//  - Eight consumer warps (two warpgroups), warp w owning rows 16w..16w+15
//    of the 128-row block: bf16 tiles multiply on the tensor cores with
//    mma.sync m16n8k16 (f32 accumulate) fed by ldmatrix (x by
//    ldmatrix.trans) from the ring, addressed through the same 128-byte
//    swizzle, so ldmatrix is free of bank conflicts.  mma.sync rather than
//    wgmma: the kernel is byte bound (3.7 GFLOP is ~6-12 us at mma.sync
//    rates against a ~20 us byte bound), so the tensor-core rate is not
//    what limits it.  The feature tile is F rounded up to 8 (no padding of
//    F to 128), F > 128 takes several feature tiles.
//  - f32 tiles multiply with FFMA on the CUDA cores: TF32, even 3xTF32,
//    would round the products.  Above F ~ 32 what bounds them is not bytes
//    but the CUDA cores (F=768 on the 50k operator: 29.6 GFLOP, 0.44 ms at
//    67 TFLOP/s, against 0.12 ms for its bytes), and next to them the
//    shared loads that feed them: a lane that holds R x C outputs loads
//    R + C floats a k for R C FMAs.  So a lane owns an R x 4U register tile
//    of its warp's 16 rows x FT (F32Tile: 8 x 8 at FT=128, 4 x 12 at FT=96,
//    the FT / 2 accumulators the 168 registers of __launch_bounds__(384, 1)
//    hold with no spill) and per k-group of 4 loads R + 4U float4s for
//    16 R U FMAs, where the first version loaded one float a FMA.  Lanes
//    map to (rows, units) so that each quarter-warp's 16-byte loads hit 8
//    distinct swizzle slots of B and one broadcast row of A.  Each output
//    is still one fmaf chain, k ascending over the row block's tiles, then
//    its remainder edges: the outputs equal the first version's bit for
//    bit.  Measured on an H100 80GB HBM3 at 700 W (cold L2, one half),
//    F=768 on the 50k operator: 0.80-0.88 ms at FT=128, 0.50-0.55 of the
//    FFMA rate (first version 1.97-2.13 ms).  A build with the FMAs and few
//    loads takes 0.72 ms (0.61 of the rate), one with the loads and no FMA
//    0.35-0.36 ms: eight FFMA warps at 168 registers top out near 0.6 of
//    the rate and the loads add the rest; loading a k-group ahead measured
//    no faster.
//    The widest f32 feature tile is 96 (PGTT_F32_MAX_FT): at F=256 on the
//    11,160-node PeMS operator its 264 items fill the 132 SMs twice, where
//    FT=128's 176 leave 88 idle in the second round (0.0359-0.0386 against
//    0.0404-0.0408 ms); FT=128 is faster at F=768 (0.80-0.88 against
//    0.89-1.00 ms).  96 keeps more device time a step on the paths the
//    port drives: 94 launches at F=256 a DCRNN step, 2 at F=768 an ASTGCN
//    one.
//  - Walked f32 tiles.  The dense FFMA loop multiplies every zero of a
//    tile, and graphs such as a road network's band fill their tiles to
//    4-5%.  A tile of at most F32_WALK_MAX_NNZ nonzeros (ops/bcsr.py, 22%
//    full) comes as lists (ops/bcsr.py _walk_lists): for each K chunk the
//    producer bulk-copies the chunk's 129 row pointers and (column, value)
//    pairs into the stage's tile slot in place of the tile box, and stages
//    the x rows as for a dense tile; each lane walks its rows' nonzeros in
//    turn into the same accumulators, a pair and U float4s of x for 4U
//    FMAs each.  Each output's fmaf chain is the dense one less its zero
//    terms, which leave it unchanged for finite x: the outputs are the
//    dense path's bit for bit.  What bounds a walked tile is the shared
//    loads a nonzero (one pair, U float4s), ~2.1 us a launch of 88 tiles
//    at F=96 for each 1,024 nonzeros a tile; the cut is where that meets
//    the dense loop's flat cost (tools/walk_cut_sweep.py, H100 80GB HBM3,
//    700 W: crossings at 3,950-4,760 nonzeros).  On the PeMS stand-in's
//    operator (88 tiles of ~750 nonzeros) the kernel went from 0.0358 to
//    0.0195 ms at F=256 and from 0.418 to 0.172 ms at F=4,224, where the
//    rest of an item (x staged through the ring, the epilogue's writes)
//    now takes most of its time.
//  - Remainder in the epilogue, spread over all 256 consumer threads.  The
//    accumulator goes to a shared-memory block (128 x FT f32) and the
//    item's row pointers to shared memory (cp.async, issued before the
//    tiles).  The x rows the remainder edges gather travel through the same
//    ring: after an item's tile stages the producer warps fill remainder
//    stages of up to 128 edges, the values after the rows, from the edges'
//    indices a batch of EDGE_BATCH at a time (the item's first loaded
//    before its tiles), so the gathers are in flight while the consumers
//    still multiply.  A row of 192 bytes or more comes by one bulk copy, a
//    narrower one by 16-byte cp.async copies that the stage's "full"
//    barrier waits for (cp.async.mbarrier.arrive): each measured ahead of
//    the other at those widths.  Consumer thread t owns 16-byte feature
//    unit u = t % nu of the rows t / nu, + 256 / nu, ... (nu units a row):
//    consecutive rows land on different warps, every warp works every
//    stage, and each output has one owner for the whole item, which adds
//    its row's edges in edge order, four edges' loads ahead of their FMAs,
//    from the tile products (or 0), and writes the output once its last
//    edge is in: no atomics, deterministic sums, no second pass.  (The
//    first design gave a stage's rows to the one warp that owned them,
//    ~1.2 us a stage, and walked 128-row blocks; gathering x straight from
//    global memory, each owner a window of loads ahead, measured slower
//    still: its latency chains bound it, not bytes.)
//  - A ragged F (x rows not 16-byte aligned, which a tensor map cannot
//    describe) has the producer warps store x element by element into the
//    same swizzled layout, zero past F; nothing is copied to pad F.
//
// The entry point launches on the given stream, allocates nothing, does not
// synchronise and returns a CUDA error code (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BLK = 128;          // tile edge (ops/bcsr.py BLOCK)
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int MAX_STAGES = 6;     // ring depth, where shared memory allows
constexpr int CONSUMER_WARPS = 8; // warp w: rows 16w .. 16w + 15 of a tile
constexpr int CT = CONSUMER_WARPS * 32;  // consumer threads
// producer threads: thread 0 issues the tensor-map copies, all of them the
// remainder's row copies (four warps measured faster than one or two)
constexpr int NP = 4 * 32;
constexpr int THREADS = CT + NP;
constexpr int UNIT = 16;          // bytes per vector access
constexpr int SW = 128;           // bytes per swizzled row (TMA box width)
// remainder edges whose indices a producer thread holds at once
constexpr int EDGE_BATCH = 512;
constexpr int EDGE_SLOTS = EDGE_BATCH / NP;
// a walked f32 K chunk's list in the stage's tile slot (ops/bcsr.py
// _walk_lists): 129 u16 row pointers in WALK_HEAD bytes, then (column in
// the chunk, f32 bits) int32 pairs
constexpr int WALK_HEAD = 272;
static_assert(2 * (BLK + 1) <= WALK_HEAD && WALK_HEAD % UNIT == 0,
              "row pointers, then 16-byte aligned pairs");

constexpr int pow2_floor(int v) {
  int p = 1;
  while (2 * p <= v) p *= 2;
  return p;
}

template <typename T, int NT>
struct Cfg {
  static constexpr int FT = NT * 8;                   // feature tile
  static constexpr int VEC = UNIT / (int)sizeof(T);   // x elements per unit
  static constexpr int KC = SW / (int)sizeof(T);      // K chunk: one 128 B row
  static constexpr int CHUNKS = BLK / KC;             // stages per tile
  static constexpr int NBOX = (FT * (int)sizeof(T) + SW - 1) / SW;  // x boxes
  static constexpr int A_BYTES = BLK * SW;            // one tile box
  static constexpr int B_BOX = KC * SW;               // one x box
  static constexpr int B_BYTES = NBOX * B_BOX;
  // a remainder stage: RE gathered x rows of RROW bytes over the tile and
  // x boxes' space, then their RE values
  static constexpr int RROW = (FT * (int)sizeof(T) + UNIT - 1) / UNIT * UNIT;
  static constexpr int RE =
      pow2_floor((A_BYTES + B_BYTES) / RROW < 128 ? (A_BYTES + B_BYTES) / RROW
                                                  : 128);
  static constexpr int V_BYTES = RE * 4;
  // the remainder's x rows by TMA bulk copies from 192 bytes a row, by
  // 16-byte cp.async below (measured: bulk ahead at 192 and 384 bytes,
  // cp.async at 128)
  static constexpr bool BULK = RROW >= 192;
  static constexpr int STAGE_BYTES =
      (A_BYTES + B_BYTES + V_BYTES + 1023) / 1024 * 1024;  // swizzle atoms
  static constexpr int CS = FT + 8;                   // f32 stride of the epilogue block
  static constexpr int C_BYTES = BLK * CS * 4;
  static constexpr int FIXED = 1024 /* alignment */ + C_BYTES +
                               2 * MAX_STAGES * 8 /* barriers */ +
                               2 * CONSUMER_WARPS * 32 /* item slots */ +
                               2 * (BLK + 1) * 4 /* row pointers */;
  // as deep a ring as shared memory holds
  static constexpr int STAGES =
      (SMEM_MAX - FIXED) / STAGE_BYTES < MAX_STAGES
          ? (SMEM_MAX - FIXED) / STAGE_BYTES
          : MAX_STAGES;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(EDGE_BATCH % RE == 0, "a stage never straddles two batches");
};

// byte offset of (row, byte) in rows of 128 B under the 128-byte swizzle
// (16-byte unit u of row r sits at unit u ^ (r % 8)); 1024-byte aligned base
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  return row * SW + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 2-D tensor-map copy of one box at (c0 inner, c1 outer) into shared memory
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}

// four f32 from a 16-byte-aligned shared address
__device__ __forceinline__ void lds128(uint32_t addr, float (&v)[4]) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr));
}

// lanes per feature group of the f32 micro-tile: the power of two that
// divides the tile's 16-byte units and loads the fewest float4s a k-group
// (R rows of A plus 4 U units of B, R = fg / 2, U = units / fg)
constexpr int f32_feature_groups(int units) {
  int best = 0, cost = 1 << 30;
  for (int fg = 2; fg <= 32; fg *= 2)
    if (units % fg == 0 && fg / 2 + 4 * (units / fg) < cost) {
      best = fg;
      cost = fg / 2 + 4 * (units / fg);
    }
  return best;
}

// the f32 consumer's register tile over a warp's 16 rows x FT features:
// lane = rg * FG + fg owns rows rg + RG i (i < R) and the 16-byte feature
// units fg + FG m (m < U), R x 4U accumulators
template <int FT>
struct F32Tile {
  static constexpr int UNITS = FT / 4;
  static constexpr int FG = f32_feature_groups(UNITS);
  static constexpr int RG = 32 / FG;
  static constexpr int R = 16 / RG;
  static constexpr int U = UNITS / FG;
  static_assert(FG >= 2 && R * U * 4 == FT / 2, "16 x FT over 32 lanes");
};

// d[0..4) += A (16x16, a0..a3) @ B (16x8, b0, b1)
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// remainder value in the activation dtype (bf16 path rounds, f32 keeps)
__device__ __forceinline__ float rem_val(float v, const float*) { return v; }
__device__ __forceinline__ float rem_val(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a[0..VEC) += v * (16 bytes of x)
__device__ __forceinline__ void fma_unit(float (&a)[8], float v, uint4 q,
                                         const __nv_bfloat16*) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 p = __bfloat1622float2(h);
    a[2 * i] = fmaf(v, p.x, a[2 * i]);
    a[2 * i + 1] = fmaf(v, p.y, a[2 * i + 1]);
  }
}
__device__ __forceinline__ void fma_unit(float (&a)[8], float v, uint4 q,
                                         const float*) {
  a[0] = fmaf(v, __uint_as_float(q.x), a[0]);
  a[1] = fmaf(v, __uint_as_float(q.y), a[1]);
  a[2] = fmaf(v, __uint_as_float(q.z), a[2]);
  a[3] = fmaf(v, __uint_as_float(q.w), a[3]);
}

// the consumer warps' own barrier (the producers never wait on it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
}

// 16 bytes global -> shared, asynchronously (cp.async, L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes global -> shared through L1 (cp.async.ca)
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared (cp.async.ca)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one more pending arrival on `bar`, made when this thread's cp.async
// copies so far have landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// an item's descriptor (ops/bcsr.py _kernel_items): rows [row0, row0 +
// nrows), tiles [t0, t1), remainder edges [p0, p1)
struct Item {
  int row0, nrows, t0, t1, p0, p1, pad0, pad1;
};

// item i of the list: the row blocks' items for each feature tile, then the
// tasks' (num_block of the num_base descriptors are row blocks)
__device__ __forceinline__ int item_base(int i, int num_block, int num_base,
                                         int nft, int& ft) {
  const int nb = num_block * nft;
  if (i < nb) {
    ft = i / num_block;
    return i - ft * num_block;
  }
  const int nk = num_base - num_block;
  ft = (i - nb) / nk;
  return num_block + (i - nb - ft * nk);
}

template <typename T, int NT>
__device__ __forceinline__ void produce(
    unsigned char* smem, uint32_t full0, uint32_t empty0,
    const CUtensorMap* map_a, const CUtensorMap* map_x,
    const int* __restrict__ block_cols, const int* __restrict__ walk_ptr,
    const unsigned char* __restrict__ walk_data,
    const Item* __restrict__ items, int num_block, int num_base,
    const int* __restrict__ rem_cols,
    const float* __restrict__ rem_vals, const T* __restrict__ x, int F,
    int x_vec) {
  using C = Cfg<T, NT>;
  // raw bits of one element: zero bits are +0.0 in both dtypes
  using Raw = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
  const int pt = threadIdx.x - CT;  // producer thread
  const uint32_t smem0 = smem_u32(smem);
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  const int nft = (F + C::FT - 1) / C::FT;
  const int num_items = num_base * nft;
  int ft;
  // the next item's descriptor, loaded one item ahead
  Item next{};
  if (blockIdx.x < num_items)
    next = items[item_base(blockIdx.x, num_block, num_base, nft, ft)];
  for (int item = blockIdx.x; item < num_items; item += gridDim.x) {
    const Item it = next;
    if (item + gridDim.x < num_items)
      next = items[item_base(item + gridDim.x, num_block, num_base, nft, ft)];
    item_base(item, num_block, num_base, nft, ft);
    const int f0 = ft * C::FT;
    const int nf = min(C::FT, F - f0);
    const uint32_t x_bytes = nf * sizeof(T);  // one x row of this tile
    const int p0 = it.p0, p1 = it.p1;
    // a batch of EDGE_BATCH remainder edges (this thread's slots: edge
    // batch0 + pt + NP q), loaded before the tiles so that the indices of
    // the gathers are at hand when their stages come
    int bcol[EDGE_SLOTS];
    float bval[EDGE_SLOTS];
    int batch0 = p0;
    auto load_batch = [&](int b0) {
      batch0 = b0;
#pragma unroll
      for (int q = 0; q < EDGE_SLOTS; ++q) {
        const int e = b0 + pt + NP * q;
        bcol[q] = e < p1 ? rem_cols[e] : 0;
        bval[q] = e < p1 ? rem_val(rem_vals[e], x) : 0.f;
      }
    };
    load_batch(p0);

    for (int t = it.t0; t < it.t1; ++t) {
      const int xrow0 = block_cols[t] * BLK;
      for (int kc = 0; kc < C::CHUNKS; ++kc) {
        // a walked chunk's list (f32 tiles only) comes in place of its box
        int w0 = 0, w1 = 0;
        if constexpr (sizeof(T) == 4)
          if (pt == 0) {
            w0 = walk_ptr[C::CHUNKS * t + kc];
            w1 = walk_ptr[C::CHUNKS * t + kc + 1];
          }
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t a_s = smem0 + stage * C::STAGE_BYTES;
        const uint32_t b_s = a_s + C::A_BYTES;
        const uint32_t full = full0 + 8 * stage;
        if (!x_vec) {  // x rows element by element, swizzled, zero past F
          unsigned char* bs = smem + stage * C::STAGE_BYTES + C::A_BYTES;
          const Raw* xr = reinterpret_cast<const Raw*>(
              x + (size_t)(xrow0 + kc * C::KC) * F + f0);
          for (int i = pt; i < C::KC * C::NBOX * C::KC; i += NP) {
            const int k = i / (C::NBOX * C::KC), j = i - k * (C::NBOX * C::KC);
            *reinterpret_cast<Raw*>(
                bs + (j / C::KC) * C::B_BOX +
                swz(k, (j % C::KC) * (int)sizeof(T))) =
                j < nf ? xr[(size_t)k * F + j] : Raw(0);
          }
        }
        if (pt == 0) {
          const uint32_t a_bytes = w1 > w0 ? (w1 - w0) * UNIT : C::A_BYTES;
          mbar_arrive_expect_tx(full, a_bytes + (x_vec ? C::B_BYTES : 0));
          if (w1 > w0)
            bulk_copy(a_s, walk_data + (size_t)w0 * UNIT, a_bytes, full);
          else
            tma_2d(a_s, map_a, kc * C::KC, t * BLK, full);
          if (x_vec)
#pragma unroll
            for (int b = 0; b < C::NBOX; ++b)
              tma_2d(b_s + b * C::B_BOX, map_x, f0 + b * C::KC,
                     xrow0 + kc * C::KC, full);
        } else {
          mbar_arrive(full);
        }
        advance();
      }
    }

    // remainder stages: RE edges each, the gathered x rows from the stage's
    // start (edge i at i * RROW, unswizzled) and the values after the boxes
    for (int e0 = p0; e0 < p1; e0 += C::RE) {
      if (e0 >= batch0 + EDGE_BATCH) load_batch(e0);
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t r_s = smem0 + stage * C::STAGE_BYTES;
      const uint32_t full = full0 + 8 * stage;
      unsigned char* rs = smem + stage * C::STAGE_BYTES;
      float* vs = reinterpret_cast<float*>(rs + C::A_BYTES + C::B_BYTES);
      const int e1 = min(e0 + C::RE, p1);
      if constexpr (C::BULK) {  // one bulk copy per gathered x row
        uint32_t bytes = 0;
#pragma unroll
        for (int q = 0; q < EDGE_SLOTS; ++q) {
          const int e = batch0 + pt + NP * q;
          if (e < e0 || e >= e1) continue;
          vs[e - e0] = bval[q];
          if (x_vec) {
            bytes += x_bytes;
          } else {
            Raw* row = reinterpret_cast<Raw*>(rs + (e - e0) * C::RROW);
            const Raw* xr = reinterpret_cast<const Raw*>(
                x + (size_t)bcol[q] * F + f0);
            for (int j = 0; j < C::FT; ++j) row[j] = j < nf ? xr[j] : Raw(0);
          }
        }
        mbar_arrive_expect_tx(full, bytes);
        if (x_vec) {
#pragma unroll
          for (int q = 0; q < EDGE_SLOTS; ++q) {
            const int e = batch0 + pt + NP * q;
            if (e < e0 || e >= e1) continue;
            bulk_copy(r_s + (e - e0) * C::RROW, x + (size_t)bcol[q] * F + f0,
                      x_bytes, full);
          }
        }
      } else {  // 16-byte cp.async copies, each edge's by its index's holder
#pragma unroll
        for (int q = 0; q < EDGE_SLOTS; ++q) {
          const int e = batch0 + pt + NP * q;
          if (e < e0 || e >= e1) continue;
          vs[e - e0] = bval[q];
          unsigned char* row = rs + (e - e0) * C::RROW;
          const T* xr = x + (size_t)bcol[q] * F + f0;
          if (x_vec) {
            const auto* xb = reinterpret_cast<const unsigned char*>(xr);
            for (int b = 0; b < (int)x_bytes; b += UNIT)
              cp_async16_ca(row + b, xb + b);
          } else {
            for (int j = 0; j < C::FT; ++j)
              reinterpret_cast<Raw*>(row)[j] =
                  j < nf ? reinterpret_cast<const Raw*>(xr)[j] : Raw(0);
          }
        }
        if (x_vec) cp_async_mbar_arrive(full);
        mbar_arrive(full);
      }
      advance();
    }
  }
}

// zeros into out rows [row0, row0 + nrows) at features [f0, f0 + nf), by
// every consumer thread
__device__ __forceinline__ void write_zeros(float* __restrict__ out,
                                            int row0, int nrows, int f0,
                                            int nf, int F, int out_vec) {
  if (out_vec) {  // nf % 4 == 0
    const int u4 = nf / 4;
    for (int s = threadIdx.x; s < nrows * u4; s += CT) {
      const int r = s / u4;
      *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * F + f0 +
                                 4 * (s - r * u4)) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int s = threadIdx.x; s < nrows * nf; s += CT) {
      const int r = s / nf;
      out[(size_t)(row0 + r) * F + f0 + (s - r * nf)] = 0.f;
    }
  }
}

// a consumer warp hands its stage back to the producers
template <int STAGES>
__device__ __forceinline__ void release(uint32_t empty0, int& stage,
                                        uint32_t& phase) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty0 + 8 * stage);
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// An item's remainder stages, spread over every consumer thread: thread t
// owns the 16-byte feature unit fc = (t % nu) VEC of the rows t / nu,
// + rstep, ... (nu units a row, rstep = 256 / nu), so consecutive rows land
// on different warps; its cursor row lr takes each stage's edges in edge
// order, starting from the tile products (or 0), and goes out once its last
// edge is added.  Every warp hands every stage back.  An item whose edges
// fit one stage walks each row whole, with no cursor across stages (on the
// PeMS band's items of ~25 edges 2-3% faster than the cursor's walk).
template <typename T, int NT>
__device__ __forceinline__ void rem_stages(
    const unsigned char* smem, const float* cblk, const int* rp,
    uint32_t full0, uint32_t empty0, int& stage, uint32_t& phase,
    const Item& it, int f0, int nf, int F, bool tiles,
    float* __restrict__ out, int out_vec) {
  using C = Cfg<T, NT>;
  const int nu = (nf + C::VEC - 1) / C::VEC;  // owners a row
  const int rstep = CT / nu;                  // rows a round of the map
  const int fc = (threadIdx.x % nu) * C::VEC;
  const int nval = nf - fc;  // real features of this thread's unit
  int lr = threadIdx.x / nu < rstep ? threadIdx.x / nu : it.nrows;
  float* ob = out + (size_t)it.row0 * F + f0 + fc;
  float a[8];
  bool open = false;
  auto start = [&]() {
#pragma unroll
    for (int j = 0; j < C::VEC; j += 4) {
      const float4 b =
          tiles ? *reinterpret_cast<const float4*>(cblk + lr * C::CS + fc + j)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      a[j] = b.x;
      a[j + 1] = b.y;
      a[j + 2] = b.z;
      a[j + 3] = b.w;
    }
    open = true;
  };
  auto flush = [&]() {
    float* o = ob + (size_t)lr * F;
    if (out_vec) {  // F % 4 == 0: 16-byte aligned rows
#pragma unroll
      for (int j = 0; j < C::VEC; j += 4)
        if (j < nval)
          *reinterpret_cast<float4*>(o + j) =
              make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < C::VEC; ++j)
        if (j < nval) o[j] = a[j];
    }
    open = false;
    lr += rstep;
  };
  // a[..] += v * x's unit of edge row e of the stage at xs
  auto add = [&](const unsigned char* xs, const float* vs, int e) {
    fma_unit(a, vs[e], *reinterpret_cast<const uint4*>(xs + e * C::RROW),
             static_cast<const T*>(nullptr));
  };
  if (it.p1 - it.p0 <= C::RE) {  // one stage: each owned row whole
    mbar_wait(full0 + 8 * stage, phase);
    const unsigned char* xs =
        smem + stage * C::STAGE_BYTES + fc * (int)sizeof(T);
    const float* vs = reinterpret_cast<const float*>(
        smem + stage * C::STAGE_BYTES + C::A_BYTES + C::B_BYTES);
#pragma unroll 2
    while (lr < it.nrows) {
      const int rb = rp[lr] - it.p0, re = rp[lr + 1] - it.p0;
      start();
      for (int e = rb; e < re; ++e) add(xs, vs, e);
      flush();
    }
    release<C::STAGES>(empty0, stage, phase);
    return;
  }
  for (int e0 = it.p0; e0 < it.p1; e0 += C::RE) {
    mbar_wait(full0 + 8 * stage, phase);
    const int e1 = min(e0 + C::RE, it.p1);
    const unsigned char* xs =
        smem + stage * C::STAGE_BYTES + fc * (int)sizeof(T);
    const float* vs = reinterpret_cast<const float*>(
        smem + stage * C::STAGE_BYTES + C::A_BYTES + C::B_BYTES);
    while (lr < it.nrows) {
      const int rb = rp[lr], re = rp[lr + 1];
      if (rb >= e1) break;  // the row starts in a later stage
      if (!open) start();
      const int hi_e = min(re, e1) - e0;
      int e = max(rb, e0) - e0;
      for (; e + 4 <= hi_e; e += 4) {  // loads ahead of FMAs, edge order
#pragma unroll
        for (int k = 0; k < 4; ++k) add(xs, vs, e + k);
      }
      for (; e < hi_e; ++e) add(xs, vs, e);
      if (re > e1) break;  // the row goes on in the next stage
      flush();
    }
    release<C::STAGES>(empty0, stage, phase);
  }
  // the rows after the item's last edge
  while (lr < it.nrows) {
    start();
    flush();
  }
}

template <typename T, int NT>
__device__ __forceinline__ void consume(
    unsigned char* smem, float* cblk, int* rptr, Item* dslots,
    uint32_t full0, uint32_t empty0, const int* __restrict__ walk_ptr,
    const Item* __restrict__ items, int num_block, int num_base,
    const int* __restrict__ rem_row_ptr, float* __restrict__ out, int F,
    int out_vec) {
  using C = Cfg<T, NT>;
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int NACC = MMA ? NT * 4 : C::FT / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  const uint32_t smem0 = smem_u32(smem);
  // ldmatrix rows of this lane (bf16 path): A row r0 + lrow, x row lrow
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int hi = lane >> 4;  // second 8-column half of the x4 load
  int stage = 0;
  uint32_t phase = 0;
  const int nft = (F + C::FT - 1) / C::FT;
  const int num_items = num_base * nft;
  // each warp's two descriptor slots: lane 0 copies the next item's while
  // this one runs
  Item* mine = dslots + 2 * warp;
  auto fetch = [&](int item, int slot) {
    if (lane == 0 && item < num_items) {
      int ft;
      const Item* src = items + item_base(item, num_block, num_base, nft, ft);
      cp_async16(&mine[slot], src);
      cp_async16(reinterpret_cast<int*>(&mine[slot]) + 4,
                 reinterpret_cast<const int*>(src) + 4);
    }
  };
  fetch(blockIdx.x, 0);
  int slot = 0;
  // the block or the row pointers were read across warps since the last
  // consumer_sync
  bool shared_reads = false;
  int rem_items = 0;  // items with remainder edges so far
  for (int item = blockIdx.x; item < num_items; item += gridDim.x) {
    cp_async_wait_all();
    __syncwarp();
    const Item it = mine[slot];
    fetch(item + gridDim.x, slot ^= 1);
    // the item's row pointers, copied while its tiles run (two buffers:
    // the previous item's may still be read)
    int* rp = rptr + (rem_items & 1) * (BLK + 1);
    if (it.p0 != it.p1 && (int)threadIdx.x <= it.nrows)
      cp_async4(rp + threadIdx.x, rem_row_ptr + it.row0 + threadIdx.x);
    int ft;
    item_base(item, num_block, num_base, nft, ft);
    const int f0 = ft * C::FT;
    const int nf = min(C::FT, F - f0);
    const int n_stages = (it.t1 - it.t0) * C::CHUNKS;
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    for (int c = 0; c < n_stages; ++c) {
      // stage c is K chunk c % CHUNKS of tile t0 + c / CHUNKS
      bool walked = false;
      if constexpr (!MMA)
        walked = walk_ptr[C::CHUNKS * it.t0 + c + 1] >
                 walk_ptr[C::CHUNKS * it.t0 + c];
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a_s = smem0 + stage * C::STAGE_BYTES;
      const uint32_t b_s = a_s + C::A_BYTES;
      if constexpr (MMA) {
#pragma unroll
        for (int kk = 0; kk < C::KC; kk += 16) {
          uint32_t a0, a1, a2, a3;
          ldsm_x4(a_s + swz(r0 + lrow, (kk + 8 * hi) * 2), a0, a1, a2, a3);
          const uint32_t b_k = b_s + (kk + lrow) * SW;
#pragma unroll
          for (int j = 0; j + 1 < NT; j += 2) {
            const int n = 8 * (j + hi);  // this lane's 8 features
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(b_k + (n / 64) * C::B_BOX +
                          (((((n % 64) >> 3) ^ lrow) & 7) << 4),
                      b0, b1, b2, b3);
            mma_bf16(&acc[4 * j], a0, a1, a2, a3, b0, b1);
            mma_bf16(&acc[4 * j + 4], a0, a1, a2, a3, b2, b3);
          }
          if constexpr (NT & 1) {
            const int n = 8 * (NT - 1);
            uint32_t b0, b1;
            ldsm_x2_t(b_k + (n / 64) * C::B_BOX +
                          (((((n % 64) >> 3) ^ lrow) & 7) << 4),
                      b0, b1);
            mma_bf16(&acc[4 * (NT - 1)], a0, a1, a2, a3, b0, b1);
          }
        }
      } else if (walked) {
        // the tile slot holds the chunk's row pointers and its nonzeros in
        // (row, column) order: each lane walks the nonzeros of its R rows
        // in turn, one (column, value) pair and U float4s of x for 4U FMAs
        // each.  Each output's chain is the dense loop's, k ascending, less
        // the terms whose tile value is zero
        using M = F32Tile<C::FT>;
        const int fg = lane % M::FG, rg = lane / M::FG;
        const unsigned char* st = smem + stage * C::STAGE_BYTES;
        const uint16_t* wrp = reinterpret_cast<const uint16_t*>(st);
        const int2* pairs = reinterpret_cast<const int2*>(st + WALK_HEAD);
        const unsigned char* xs = st + C::A_BYTES;
        int ub[M::U];
#pragma unroll
        for (int m = 0; m < M::U; ++m) {
          const int q = fg + M::FG * m;
          ub[m] = (q >> 3) * C::B_BOX + ((q & 7) << 4);
        }
        int e[M::R], n[M::R];
#pragma unroll
        for (int i = 0; i < M::R; ++i) {
          const int r = r0 + rg + M::RG * i;
          e[i] = wrp[r];
          n[i] = wrp[r + 1];
        }
#pragma unroll
        for (int i = 0; i < M::R; ++i) {
#pragma unroll 2
          for (int p = e[i]; p < n[i]; ++p) {
            const int2 q = pairs[p];
            const float v = __int_as_float(q.y);
            const int k = q.x;
#pragma unroll
            for (int m = 0; m < M::U; ++m) {
              const float4 b = *reinterpret_cast<const float4*>(
                  xs + ((ub[m] ^ ((k & 7) << 4)) + k * SW));
              float* d = &acc[(i * M::U + m) * 4];
              d[0] = fmaf(v, b.x, d[0]);
              d[1] = fmaf(v, b.y, d[1]);
              d[2] = fmaf(v, b.z, d[2]);
              d[3] = fmaf(v, b.w, d[3]);
            }
          }
        }
      } else {
        // per k-group of 4 (one 16-byte unit of an A row), R float4s of A
        // and 4 x U float4s of B feed 16 R U FMAs.  Under the 128-byte
        // swizzle unit u of row r sits at u ^ (r % 8), and the stage is
        // 1024-byte aligned, so an address is its row's base XOR the unit:
        // each quarter-warp reads 8 distinct 16-byte slots of B and one
        // broadcast row of A (two or four in distinct slots when FG < 8)
        using M = F32Tile<C::FT>;
        const int fg = lane % M::FG, rg = lane / M::FG;
        uint32_t pa[M::R], pb[M::U];
#pragma unroll
        for (int i = 0; i < M::R; ++i) {
          const int r = rg + M::RG * i;  // r0 % 8 == 0
          pa[i] = a_s + (r0 + r) * SW + ((r & 7) << 4);
        }
#pragma unroll
        for (int m = 0; m < M::U; ++m) {
          const int q = fg + M::FG * m;
          pb[m] = b_s + (q >> 3) * C::B_BOX + ((q & 7) << 4);
        }
#pragma unroll 2
        for (int g = 0; g < C::KC / 4; ++g) {
          float a[M::R][4];
#pragma unroll
          for (int i = 0; i < M::R; ++i) lds128(pa[i] ^ (g << 4), a[i]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * g + kk;
            float b[M::U][4];
#pragma unroll
            for (int m = 0; m < M::U; ++m)
              lds128((pb[m] ^ ((k & 7) << 4)) + k * SW, b[m]);
            // each output's chain: k ascending, as every f32 tile before
#pragma unroll
            for (int i = 0; i < M::R; ++i)
#pragma unroll
              for (int m = 0; m < M::U; ++m)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  float& d = acc[(i * M::U + m) * 4 + j];
                  d = fmaf(a[i][kk], b[m][j], d);
                }
          }
        }
      }
      release<C::STAGES>(empty0, stage, phase);
    }

    if (it.p0 == it.p1) {  // no remainder edges: no shared reads, no sync
      if (n_stages == 0) {
        write_zeros(out, it.row0, it.nrows, f0, nf, F, out_vec);
        continue;
      }
      if (shared_reads) consumer_sync();
      shared_reads = false;
    } else {
      consumer_sync();  // the previous item's remainder is done
      shared_reads = true;
    }
    // epilogue: accumulator -> shared block (this warp's 16 rows)
    if (n_stages > 0) {
      if constexpr (MMA) {
        const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          *reinterpret_cast<float2*>(
              &cblk[(r0 + g) * C::CS + 8 * j + 2 * t4]) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(
              &cblk[(r0 + g + 8) * C::CS + 8 * j + 2 * t4]) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      } else {
        using M = F32Tile<C::FT>;
        const int fg = lane % M::FG, rg = lane / M::FG;
#pragma unroll
        for (int i = 0; i < M::R; ++i)
#pragma unroll
          for (int m = 0; m < M::U; ++m) {
            const float* d = &acc[(i * M::U + m) * 4];
            *reinterpret_cast<float4*>(
                &cblk[(r0 + rg + M::RG * i) * C::CS + 4 * (fg + M::FG * m)]) =
                make_float4(d[0], d[1], d[2], d[3]);
          }
      }
    }
    if (it.p0 != it.p1) {
      cp_async_wait_all();
      consumer_sync();  // the block and the row pointers are in place
      ++rem_items;
      rem_stages<T, NT>(smem, cblk, rp, full0, empty0, stage, phase, it, f0,
                        nf, F, n_stages > 0, out, out_vec);
      continue;
    }
    // the tile products alone: each warp writes its own 16 rows once
    __syncwarp();
    float* orow = out + (size_t)(it.row0 + r0) * F + f0;
    if (out_vec) {  // F % 4 == 0: rows and f0 are 16-byte aligned
      constexpr int U4 = C::FT / 4;
      for (int s = lane; s < 16 * U4; s += 32) {
        const int lr = s / U4, u = s - lr * U4;
        if (u * 4 < nf)
          *reinterpret_cast<float4*>(orow + (size_t)lr * F + u * 4) =
              *reinterpret_cast<const float4*>(
                  &cblk[(r0 + lr) * C::CS + u * 4]);
      }
    } else {
      for (int s = lane; s < 16 * C::FT; s += 32) {
        const int lr = s / C::FT, j = s - lr * C::FT;
        if (j < nf) orow[(size_t)lr * F + j] = cblk[(r0 + lr) * C::CS + j];
      }
    }
    __syncwarp();
  }
  cp_async_wait_all();
}

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 1)
hybrid_spmm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_x,
                   const int* __restrict__ block_cols,
                   const int* __restrict__ walk_ptr,
                   const unsigned char* __restrict__ walk_data,
                   const Item* __restrict__ items, int num_block,
                   int num_base, const int* __restrict__ rem_row_ptr,
                   const int* __restrict__ rem_cols,
                   const float* __restrict__ rem_vals,
                   const T* __restrict__ x, float* __restrict__ out, int F,
                   int x_vec, int out_vec) {
  using C = Cfg<T, NT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* cblk = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE_BYTES);
  unsigned char* bars = smem + C::STAGES * C::STAGE_BYTES + C::C_BYTES;
  Item* dslots = reinterpret_cast<Item*>(bars + 2 * MAX_STAGES * 8);
  int* rptr = reinterpret_cast<int*>(dslots + 2 * CONSUMER_WARPS);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + C::STAGES * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, NP);  // one arrival per producer thread
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if ((threadIdx.x >> 5) >= CONSUMER_WARPS)
    produce<T, NT>(smem, full0, empty0, &map_a, &map_x, block_cols,
                   walk_ptr, walk_data, items, num_block, num_base, rem_cols,
                   rem_vals, x, F, x_vec);
  else
    consume<T, NT>(smem, cblk, rptr, dslots, full0, empty0, walk_ptr, items,
                   num_block, num_base, rem_row_ptr, out, F, out_vec);
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) matrix read in (box_rows, 128-byte) boxes with
// the 128-byte swizzle; elements outside the matrix arrive as zeros
template <typename T>
bool encode(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
            uint32_t box_rows) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(SW / sizeof(T)), box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map,
            sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NT>
int launch(const void* blocks, int num_tiles, const int* block_cols,
           const int* walk_ptr, const void* walk_data, const int* items,
           int num_block, int num_base,
           const int* rem_row_ptr, const int* rem_cols, const float* rem_vals,
           const void* x, int num_cols, float* out, int F, cudaStream_t s) {
  using C = Cfg<T, NT>;
  auto kern = hybrid_spmm_kernel<T, NT>;
  static int cached_dev = -1, max_ctas = 0;  // CTAs resident at once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != cached_dev) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                        C::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_ctas = sms * per_sm;
    cached_dev = dev;
  }
  const int items_all = num_base * ((F + C::FT - 1) / C::FT);
  // x rows as tensor-map boxes and 16-byte gathers need 16-byte alignment
  const int x_vec = (F % C::VEC == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % UNIT == 0);
  const int out_vec = (F % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % UNIT == 0);
  CUtensorMap map_a{}, map_x{};
  if (!encode<T>(&map_a, blocks, (uint64_t)num_tiles * BLK, BLK, BLK) ||
      (x_vec && !encode<T>(&map_x, x, num_cols, F, C::KC)))
    return (int)cudaErrorInvalidValue;
  kern<<<items_all < max_ctas ? items_all : max_ctas, THREADS, C::SMEM, s>>>(
      map_a, map_x, block_cols, walk_ptr,
      static_cast<const unsigned char*>(walk_data),
      reinterpret_cast<const Item*>(items),
      num_block, num_base, rem_row_ptr, rem_cols, rem_vals,
      static_cast<const T*>(x), out, F, x_vec, out_vec);
  return (int)cudaGetLastError();
}

// widest f32 feature tile (bf16: 128; see the header).  chip_smoke.py builds
// copies with -DPGTT_F32_MAX_FT=64 and 128 to time the three.
#ifndef PGTT_F32_MAX_FT
#define PGTT_F32_MAX_FT 96
#endif

// smallest instantiated n-tile count that covers `width` features
int pick_nt(int width) {
  static const int nts[] = {1, 2, 4, 5, 6, 8, 12, 16};
  for (int nt : nts)
    if (nt * 8 >= width) return nt;
  return 16;
}

template <typename T>
int dispatch(int nt, const void* blocks, int num_tiles, const int* block_cols,
             const int* walk_ptr, const void* walk_data, const int* items,
             int num_block, int num_base,
             const int* rem_row_ptr, const int* rem_cols,
             const float* rem_vals, const void* x, int num_cols, float* out,
             int F, cudaStream_t s) {
#define PGTT_NT(N)                                                       \
  case N:                                                                \
    return launch<T, N>(blocks, num_tiles, block_cols, walk_ptr,         \
                        walk_data, items, num_block, num_base,           \
                        rem_row_ptr, rem_cols, rem_vals, x, num_cols,    \
                        out, F, s);
  switch (nt) {
    PGTT_NT(1)
    PGTT_NT(2)
    PGTT_NT(4)
    PGTT_NT(5)
    PGTT_NT(6)
    PGTT_NT(8)
    PGTT_NT(12)
    PGTT_NT(16)
  }
#undef PGTT_NT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// blocks (num_tiles >= nnzb, 128, 128) f32 or bf16 (is_bf16), the
// row-sorted tiles; block_cols (nnzb) int32; walk_ptr (nnzb * 4 + 1) int32
// and walk_data, the walked f32 tiles' nonzero lists (16-byte units; a
// dense tile's are empty; not read for bf16); items (num_base, 8) int32, the
// item list's descriptors (row0, rows, first tile, end tile, first
// remainder edge, end edge, 0, 0; 16-byte aligned), the first num_block of
// them row blocks, the rest remainder-only tasks; rem_row_ptr (num_rows + 1)
// int32 row pointers over the remainder edges sorted by (row, col), whose
// columns and f32 values are rem_cols, rem_vals; x (num_cols, F) in the
// tiles' dtype; out (num_rows, F) f32, fully written (the items cover every
// row).
int pgtt_hybrid_spmm(const void* blocks, int num_tiles, int is_bf16,
                     const int* block_cols, const int* walk_ptr,
                     const void* walk_data, const int* items, int num_block,
                     int num_base, const int* rem_row_ptr,
                     const int* rem_cols, const float* rem_vals,
                     const void* x, int num_cols, float* out, int F,
                     void* stream) {
  if (num_base == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int max_ft = is_bf16 ? 128 : PGTT_F32_MAX_FT;
  const int nft = (F + max_ft - 1) / max_ft;
  const int nt = pick_nt((F + nft - 1) / nft);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(nt, blocks, num_tiles, block_cols,
                                   walk_ptr, walk_data, items, num_block,
                                   num_base, rem_row_ptr,
                                   rem_cols, rem_vals, x, num_cols, out, F,
                                   s);
  return dispatch<float>(nt, blocks, num_tiles, block_cols, walk_ptr,
                         walk_data, items, num_block, num_base, rem_row_ptr,
                         rem_cols, rem_vals, x,
                         num_cols, out, F, s);
}

}  // extern "C"
