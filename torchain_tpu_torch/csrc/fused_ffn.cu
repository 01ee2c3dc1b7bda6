// Fused conformer feed-forward half-step: kernels K10f (forward) and K10b
// (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/fused_ffn.py:
//   K10f  ffn_forward  -> _fwd_kernel (pallas_call :200)
//   K10b  ffn_backward -> _bwd_kernel (pallas_call :239)
//
//   u   = xn W1 + b1                      [N, F], float32 accumulation
//   h   = round(u * sigmoid(u))           rounded to the trunk dtype
//   out = res + alpha * (h W2 + b2)       [N, D], trunk dtype
//
// With `partial` set, the kernels compute one model rank's share of a
// half-step whose hidden columns are split over a model group: the forward
// writes out = alpha * (h W2) in float32 (no res, no b2), and the backward
// writes dx in float32, so that the sum over the group rounds once, as the
// unsplit kernel rounds its output (the caller adds res and b2 after it).
//
// xn, res, W1, W2, g, out and dx are float32 or bfloat16 (the trunk dtype);
// b1, b2 and the weight gradients are float32.  The backward recomputes u,
// sigmoid and h, and keeps the roundings of the Pallas body: h and
// dhb = round(dh) are rounded before the products that use them, db1 sums
// the unrounded dh, db2 = alpha * sum(g), dW2 = alpha * h^T g.  Bias, swish
// and its derivative are float32.
//
// What bounds them on the H100: operations, and behind them the L2.  At
// N=6400, D=256, F=1024 the forward is 6.7 GFLOP over 11 MB of bf16
// operands and the backward 16.8 GFLOP; every 64-row tile streams the whole
// of W1 and W2 from the L2.  So every product runs on the tensor cores:
//   * bfloat16 operands: wgmma.m64n64k16 (one warpgroup, 64 rows, A and B
//     from shared memory, float32 accumulators in registers).  Operands lie
//     in shared memory in the 128-byte swizzle: a tile is cut into blocks of
//     64 columns (128 bytes), each row of a block holds 8 chunks of 16 bytes
//     at chunk ^ (row % 8).  A K-major operand (xn, h, dhb, W2 read as W2^T,
//     W1 read as W1^T) advances along K by moving the descriptor's start 32
//     bytes; an MN-major one (W1 and W2 in their stored layout, and both
//     operands of the weight gradients) is read transposed by wgmma itself,
//     which it allows for 16-bit types, so no weight is transposed in device
//     memory.  Every wgmma is 64 columns wide, one swizzle block, so the
//     descriptor's two strides are both the 1024 bytes of 8 rows.
//   * float32 operands: 3xTF32 on mma.sync.m16n8k8.  Each operand is split
//     as hi = x with its 13 low mantissa bits cleared (a TF32 value) and
//     lo = x - hi (exact; the tensor cores read its TF32 leading bits), and
//     lo*hi + hi*lo + hi*hi are summed in float32 (lo*lo dropped: a relative
//     error near 2^-20 per product, tests/test_torch_ffn.py sizes it).  wgmma
//     takes tf32 operands K-major only, and half of the operands here are
//     MN-major in device memory; mma.sync's fragments are loaded by the
//     threads from padded row-major tiles, in either orientation, and split
//     in registers, so no operand is transposed or stored twice.  The
//     accumulators of both forms share one register layout (that of wgmma's
//     m64nN and of mma.sync's m16n8 per warp), so every epilogue is written
//     once.
// Tiles come into a ring of shared-memory stages, filled up to three slices
// ahead of the products and guarded by mbarriers (full / empty).  bfloat16
// operands whose rows are 16-byte aligned come by TMA: 64 x 64 boxes, one
// instruction each, issued by thread 0, swizzled and zero-filled past the
// edges by the hardware.  Float32 tiles (padded, which TMA cannot write) and
// unaligned bfloat16 rows (D = 300, F = 130) come by cp.async from every
// thread, 16 bytes a copy with src-size zero-filling the edges, or element
// by element where a row's start is not 16-byte aligned.
//
// Forward: a block owns 64 rows, a group of at most 384 output columns and
// two warpgroups.  It keeps the xn tile in shared memory and walks F in
// chunks of 128: warpgroup w computes u[:, 64w : 64w + 64] of the chunk,
// adds b1, applies swish, rounds and writes its half of the h tile into
// shared memory; then each adds h W2[c, cols] into its half of the block's
// [64, <= 384] float32 output accumulator, which stays in registers for the
// whole F loop (at most 96 floats a thread).  The [N, F] hidden tensor never
// leaves the SM.  Filling the card: N = 6400 gives 100 row tiles, one block
// per SM for 132 SMs (shared memory 178 KB); 32 SMs stay idle.  Splitting F
// across blocks would fill them but needs a second pass to add the partial
// outputs.
//
// Rows wider than 384 (D 512, as in a conformer of dim 512) are cut into
// column groups of at most 384 (D 512: two of 256), one grid row of blocks
// each; every group recomputes the chunk's hidden values (u over all of D),
// so the first product is done once per group.  Where the groups are more
// than one, or the [64, D] xn tile and the ring would not fit one block's
// shared memory (float32 D > 352), xn comes in [64, KS] slices beside W1's,
// as in the backward's first pass, and no xn tile is kept.
//
// Backward, two launches and no atomics (two calls give the same bits).
// Pass 1, one block per 64 rows, as the forward: per chunk of F, u = xn W1
// and t = g W2^T on the tensor cores (xn and g arrive in K slices beside the
// weights, so no [64, D] tile is kept), then h, dh, dhb in registers; h and
// dhb go to the [N, F] scratch in the trunk dtype and dhb to shared memory,
// the block's column sums of dh (db1) and, in the first chunk, of g (db2) to
// per-block partials; dx += dhb W1^T[c, cols] in registers, the columns cut
// into groups as the forward's (only the first group writes the scratch and
// the partials; the others recompute u and t for their dx).  Pass 2: one block
// per 64 x 64 tile of dW1 = xn^T dhb or dW2 = alpha h^T g (128 blocks at
// the conformer shape); its two warpgroups take the first and the second
// half of the N rows, and warpgroup 0 adds warpgroup 1's sum to its own.
// The blocks after the tiles add the per-block bias partials in block order.
//
// Any N, D and F.  ptxas serializes a warpgroup's wgmmas where its threads take
// different paths while products are in flight, so every thread of a block
// waits at the ring's barriers and TMA copies are predicated, not branched.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <tuple>
#include <type_traits>

namespace {

constexpr int ROWS = 64;         // rows of xn per block: one wgmma M
constexpr int WG = 128;          // threads of a warpgroup
constexpr int THREADS = 2 * WG;  // two warpgroups per block
constexpr int FC = 128;          // hidden columns per chunk, 64 per warpgroup
constexpr int NSTW = 4;          // ring stages of the weight-gradient kernel
constexpr int MAX_NA = 3;        // 64-column output blocks per warpgroup: 384 a block
constexpr int TW = 64;           // weight-gradient tile, square

typedef __nv_bfloat16 bf16;

// K depth of one staged slice (128 bytes of K) and elements per 16 bytes
template <typename T> struct Kind;
template <> struct Kind<bf16> { static constexpr int KS = 64, CH = 8; };
template <> struct Kind<float> { static constexpr int KS = 32, CH = 4; };

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// A tile of `rows` x `cols` elements in shared memory, `cols` contiguous in
// device memory.  bfloat16: 128-byte swizzle in blocks of 64 columns (cols a
// multiple of 64, rows of 8).  float32: row-major with the row stride padded
// so that mma.sync's fragment loads hit 32 distinct banks: 4 mod 32 when the
// columns run along K, 8 mod 32 when they run along M or N.
struct Tile {
  uint32_t off;  // bytes from the 1024-aligned base
  int rows, cols, stride;
};

__host__ __device__ inline int f32_stride(int cols, bool kcols) {
  return (int)round_up(cols, 32) + (kcols ? 4 : 8);
}

__host__ __device__ inline long long tile_bytes(int esz, int rows, int cols, bool kcols) {
  const long long b = esz == 2 ? 2LL * rows * cols : 4LL * rows * f32_stride(cols, kcols);
  return round_up(b, 1024);
}

__host__ __device__ inline Tile make_tile(long long& cursor, int esz, int rows, int cols,
                                          bool kcols) {
  Tile t{(uint32_t)cursor, rows, cols, esz == 2 ? cols : f32_stride(cols, kcols)};
  cursor += tile_bytes(esz, rows, cols, kcols);
  return t;
}

// byte offset of element (r, c); c % 8 == 0 gives its 16-byte chunk
template <typename T> __device__ __forceinline__ uint32_t at(const Tile& t, int r, int c);
template <> __device__ __forceinline__ uint32_t at<bf16>(const Tile& t, int r, int c) {
  return t.off + (uint32_t)((c >> 6) * t.rows * 128 + r * 128 +
                            ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2);
}
template <> __device__ __forceinline__ uint32_t at<float>(const Tile& t, int r, int c) {
  return t.off + (uint32_t)(r * t.stride + c) * 4;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// swish's sigmoid as torch.sigmoid computes it: 1 / (1 + exp(-u)), the
// reciprocal rounded once (rcp.rn is the correctly rounded 1 / x)
__device__ __forceinline__ float sigmoid_f32(float u) { return __frcp_rn(1.0f + expf(-u)); }

// dh = (t alpha) (sig (1 + u (1 - sig))), each operation rounded on its own as
// the plain version's separate tensor operations round it (no contraction)
__device__ __forceinline__ float dswish(float t, float alpha, float u, float sig) {
  return __fmul_rn(__fmul_rn(t, alpha),
                   __fmul_rn(sig, __fadd_rn(1.0f, __fmul_rn(u, __fsub_rn(1.0f, sig)))));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// two adjacent elements (the first at an even column), rounded to T
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// the same into row-major device memory of row length n at column c (even):
// a pair store where both lie in the row and n is even, else one by one
template <typename T>
__device__ __forceinline__ void store_row_pair(T* row, int c, int n, float a, float b) {
  if ((n & 1) == 0) {
    if (c < n) store_pair(row + c, a, b);
  } else {
    if (c < n) row[c] = from_f32<T>(a);
    if (c + 1 < n) row[c + 1] = from_f32<T>(b);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// shared-memory writes by the threads become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + t.rows) and columns [c0, c0 + t.cols) of the row-major
// array g [nr, nc] (row stride ld) into tile t at base, zeros outside g; all
// THREADS threads of the block take part, each walking its own 16-byte
// chunks.  `vec`: ld and g allow 16-byte copies (cp.async, src-size 0..16
// at the edges); otherwise element by element into the same layout.
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t base, char* sbase, const Tile& t,
                                          const T* __restrict__ g, long long ld, int nr, int nc,
                                          int r0, int c0, bool vec) {
  constexpr int CH = Kind<T>::CH;
  const int cpr = t.cols / CH, n = t.rows * cpr;
  int r = threadIdx.x / cpr, c = (threadIdx.x - r * cpr) * CH;
  const int dr = THREADS / cpr, dc = (THREADS - dr * cpr) * CH;
  const bool inside = r0 + t.rows <= nr && c0 + t.cols <= nc;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const uint32_t off = at<T>(t, r, c);
    const int gr = r0 + r, gc = c0 + c;
    if (vec) {
      const int valid = inside ? CH : (gr < nr ? min(max(nc - gc, 0), CH) : 0);
      cp_async16(base + off, valid ? g + (long long)gr * ld + gc : g, valid * (int)sizeof(T));
    } else {
      T* dst = reinterpret_cast<T*>(sbase + off);
#pragma unroll
      for (int e = 0; e < CH; ++e)
        dst[e] = (gr < nr && gc + e < nc) ? g[(long long)gr * ld + gc + e] : from_f32<T>(0.0f);
    }
    r += dr;
    c += dc;
    if (c >= t.cols) {
      c -= t.cols;
      ++r;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p, long long ld, int esz) {
  return ((uintptr_t)p & 15) == 0 && (ld * esz) % 16 == 0;
}

// ---------------------------------------------------------------------------
// The ring of stages.  full[st] completes when stage st has landed: with TMA
// one arrival (thread 0's, which also sets the bytes to expect), otherwise
// one per thread, when that thread's copies land.  empty[st] completes when
// every thread of the block is done with the stage; only then is it filled
// again.  A wait that does not end traps, so that a fault surfaces as a
// launch error and not as a hung card.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t a, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a) : "memory");
}
// thread 0 arrives and sets the bytes to expect (the others skip it, as a
// predicate and not a branch: no thread of a warpgroup takes another path
// while its products are in flight)
__device__ __forceinline__ void mbar_expect(uint32_t a, uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(a),
      "r"(bytes), "r"(threadIdx.x)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t a, int parity) {
  uint32_t done = 0;
  for (long spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (spins > (1L << 26)) __trap();
  }
}
// this thread's copies of a stage are issued: with `vec` it arrives when
// they land; otherwise now (its element-wise stores are done, its copies
// waited for)
__device__ __forceinline__ void mbar_produced(uint32_t a, bool vec) {
  if (vec) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(a) : "memory");
  } else {
    cp_async_wait_all();
    mbar_arrive(a);
  }
}
__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty, int stages, bool tma) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + 8 * st, tma ? 1 : THREADS);
      mbar_init(empty + 8 * st, THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// TMA: the bfloat16 operands, when their rows are 16-byte aligned, come as
// boxes of 64 x 64 elements (8 KB), one instruction each, written in the
// 128-byte swizzle the tiles use (box row r at r * 128, chunk j at j ^ r % 8)
// and zero-filled past the array's edges.  One map per operand array.
constexpr int BOX = 64;
struct Maps {
  CUtensorMap m[4];
};

// box of rows [row, row + 64) and columns [col, col + 64) of map m into
// shared memory at dst, completing on barrier bar (issued by thread 0)
__device__ __forceinline__ void tma_box(const CUtensorMap& m, uint32_t dst, int col, int row,
                                        uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&m)), "r"(col), "r"(row), "r"(bar), "r"(threadIdx.x)
      : "memory");
}
// the boxes of a bfloat16 tile: its 64-column blocks, each in 64-row boxes
__device__ __forceinline__ void tma_tile(const CUtensorMap& m, uint32_t base, const Tile& t, int r0,
                                         int c0, uint32_t bar) {
  for (int cb = 0; cb < t.cols; cb += BOX)
    for (int rb = 0; rb < t.rows; rb += BOX)
      tma_box(m, base + t.off + (uint32_t)(cb * t.rows * 2 + rb * 128), c0 + cb, r0 + rb, bar);
}

// ---------------------------------------------------------------------------
// Products.  acc[a][i] accumulates a [64, 64] block of A B: A [64, K] and B
// [K, 64 NA] in shared memory, the warpgroup's 64 output rows, columns
// [bmn + 64 a, ...).  Element i of a thread of warp q (of the warpgroup),
// lane l sits at row 16 q + l / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (l % 4) + i % 2 of its block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int frag_row(int i) {
  return 16 * ((threadIdx.x % WG) >> 5) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

template <int NA>
__device__ __forceinline__ void zero(float (&acc)[NA][32]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.0f;
}

// wgmma shared-memory descriptor: 128-byte swizzle, both strides 1024 bytes
// (the next 8 rows; the other stride spans swizzle blocks, which a 64-wide
// operand never crosses)
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)64 << 16) | ((uint64_t)64 << 32) |
         (1ULL << 62);
}

// start of the 64 x 16 (K-major) or 16 x 64 (MN-major) operand at (mn, k)
__device__ __forceinline__ uint32_t op_start(const Tile& t, bool kmajor, int mn, int k) {
  return kmajor ? t.off + (uint32_t)((k >> 6) * t.rows * 128 + mn * 128 + (k & 63) * 2)
                : t.off + (uint32_t)((mn >> 6) * t.rows * 128 + k * 128);
}

// the 32 accumulator registers of a thread, in and out
#define WGMMA_ACC                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define WGMMA_OPS                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d = A B (+ d unless `fresh`), one 64 x 64 x 16 step; TA / TB: the operand
// is MN-major (transposed).  `fresh` is a predicate of the one instruction,
// not a branch: no path of the warpgroup may part while products are in flight.
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da, uint64_t db, int fresh) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_OPS
      "%32, %33, p, 1, 1, %34, %35;\n}\n"
      : WGMMA_ACC
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(fresh));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int NA>
__device__ __forceinline__ void fence_acc(float (&acc)[NA][32]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[a][i])::"memory");
}

// Wait until at most N groups of this warpgroup's wgmmas are in flight
// (float32: mma.sync has finished on return already)
template <typename T, int N, int NA>
__device__ __forceinline__ void retire(float (&acc)[NA][32]) {
  if constexpr (sizeof(T) == 2) {
    wgmma_wait<N>();
    if (N == 0) fence_acc(acc);  // (a fence on registers in flight would serialize)
  }
}

// x = hi + lo: hi keeps the 10 leading mantissa bits (tf32), lo = x - hi is
// exact, and the tensor cores read lo's 10 leading bits in turn
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float32: acc += A[:, ak : ak + K] B[0 : K, bmn : bmn + 64 NA] in 3xTF32,
// K = Kind<float>::KS.  AK / BK: the operand is K-major in its tile (A: rows
// are M; B: rows are N).  The slice's products are summed on the tensor
// cores into zeros and that sum is added to acc on the float32 units: the
// tensor cores' own accumulation is not round-to-nearest, which over a long
// K (6400 rows) would grow past float32's error.
template <int NA, bool AK, bool BK>
__device__ __forceinline__ void product_f32(float (&acc)[NA][32], const char* sbase,
                                            const Tile& A, int ak, const Tile& B, int bmn) {
  constexpr int K = Kind<float>::KS;
  const int m = 16 * ((threadIdx.x % WG) >> 5) + ((threadIdx.x & 31) >> 2);
  const int t = threadIdx.x & 3;
  auto ld = [&](const Tile& tl, bool kmaj, int mn, int k) {
    return *reinterpret_cast<const float*>(sbase + (kmaj ? at<float>(tl, mn, k)
                                                         : at<float>(tl, k, mn)));
  };
  uint32_t ah[K / 8][4], al[K / 8][4];
#pragma unroll
  for (int s = 0; s < K / 8; ++s) {
    const int k = ak + 8 * s + t;
    split(ld(A, AK, m, k), ah[s][0], al[s][0]);
    split(ld(A, AK, m + 8, k), ah[s][1], al[s][1]);
    split(ld(A, AK, m, k + 4), ah[s][2], al[s][2]);
    split(ld(A, AK, m + 8, k + 4), ah[s][3], al[s][3]);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = bmn + 64 * a + 8 * j + (m & 7);
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < K / 8; ++s) {
        const int k = 8 * s + t;
        uint32_t bh0, bl0, bh1, bl1;
        split(ld(B, BK, n, k), bh0, bl0);
        split(ld(B, BK, n, k + 4), bh1, bl1);
        mma_tf32(d, al[s], bh0, bh1);
        mma_tf32(d, ah[s], bl0, bl1);
        mma_tf32(d, ah[s], bh0, bh1);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][4 * j + q] += d[q];
    }
}

// acc (= when `fresh`) += A[:, ak : ak + KS] B[0 : KS, bmn : bmn + 64 NA].  bfloat16: issued
// on the tensor cores and committed as one group, not waited for (`retire`
// waits); float32: done on return.
template <typename T, int NA, bool AK, bool BK>
__device__ __forceinline__ void product(float (&acc)[NA][32], const char* sbase, uint32_t base,
                                        const Tile& A, int ak, const Tile& B, int bmn,
                                        bool fresh = false) {
  if constexpr (sizeof(T) == 2) {
    // `fresh`: the first step overwrites acc (no other instruction may write
    // an accumulator while products are in flight)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Kind<T>::KS; kk += 16) {
      const uint64_t da = sdesc(base + op_start(A, AK, 0, ak + kk));
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma64<AK ? 0 : 1, BK ? 0 : 1>(acc[a], da, sdesc(base + op_start(B, BK, bmn + 64 * a, kk)),
                                        kk == 0 && fresh);
    }
    wgmma_commit();
  } else {
    if (fresh) zero(acc);
    product_f32<NA, AK, BK>(acc, sbase, A, ak, B, bmn);
  }
}

__device__ __forceinline__ char* aligned_base(unsigned char* raw, uint32_t& base) {
  const uint32_t s = smem_u32(raw);
  const uint32_t pad = (1024 - (s & 1023)) & 1023;
  base = s + pad;
  return reinterpret_cast<char*>(raw) + pad;
}

// ---------------------------------------------------------------------------
// Shared-memory plans (the host's sizes and the kernels' offsets agree).  The
// first 1024 bytes hold the ring's barriers.
// ---------------------------------------------------------------------------

constexpr int BARS = 1024;

// ring stages of the row kernels: as many as fit at every D of the width
// class (bfloat16: 4, 3 for D > 256; float32: 3, 2 for D > 256)
__host__ __device__ constexpr int row_stages(int NA, int esz) {
  return (NA <= 2 ? 4 : 3) - (esz == 4);
}

// per warp, a list of LIST values to sum again (bfloat16 only: see
// "Rounding boundaries"), each its (row, column)
constexpr int LIST = 128;
__host__ __device__ inline long long fix_bytes(int esz) { return esz == 2 ? 8 * LIST * 8 : 0; }

// `stream`: xn comes in [64, KS] slices at the start of the stages of W1's
// slices (w1s: where W1's slice starts in a stage), and no xn tile is kept
struct FwdPlan {
  Tile xs, hs;
  long long stage0, stage, w1s, total;
};
__host__ __device__ inline FwdPlan fwd_plan(int esz, int KS, int D, int NA, bool stream) {
  FwdPlan p;
  long long cur = BARS;
  p.xs = stream ? Tile{0, ROWS, KS, 0} : make_tile(cur, esz, ROWS, (int)round_up(D, KS), true);
  p.hs = make_tile(cur, esz, ROWS, FC, true);
  p.stage0 = cur;
  p.w1s = stream ? tile_bytes(esz, ROWS, KS, true) : 0;
  const long long u_slice = p.w1s + tile_bytes(esz, KS, FC, false);
  const long long out_slice = tile_bytes(esz, KS, 128 * NA, false);  // W2 [KS, DP]
  p.stage = u_slice > out_slice ? u_slice : out_slice;
  p.total = cur + row_stages(NA, esz) * p.stage + 1024;  // + alignment slack
  return p;
}

struct RowsPlan {
  Tile dhs;
  long long red, fix, stage0, stage, total;
  long long xsl, gsl, w1s, w2t;  // offsets within a stage of the u / t slice
};
__host__ __device__ inline RowsPlan rows_plan(int esz, int KS, int NA) {
  RowsPlan p;
  long long cur = BARS;
  p.dhs = make_tile(cur, esz, ROWS, FC, true);
  p.red = cur;
  cur += round_up(4 * 4 * FC, 1024);  // [4 warps, FC] column sums
  p.fix = cur;
  cur += fix_bytes(esz);
  p.stage0 = cur;
  long long s = 0;
  p.xsl = s;
  s += tile_bytes(esz, ROWS, KS, true);
  p.gsl = s;
  s += tile_bytes(esz, ROWS, KS, true);
  p.w1s = s;
  s += tile_bytes(esz, KS, FC, false);
  p.w2t = s;
  s += tile_bytes(esz, FC, KS, true);
  const long long dx_slice = tile_bytes(esz, 128 * NA, KS, true);  // W1^T [DP, KS]
  p.stage = s > dx_slice ? s : dx_slice;
  p.total = cur + row_stages(NA, esz) * p.stage + 1024;
  return p;
}

__host__ __device__ inline long long weights_stage(int esz, int KS) {
  return 4 * tile_bytes(esz, KS, TW, false);
}
__host__ __device__ inline long long weights_bytes(int esz, int KS) {
  const long long ring = NSTW * weights_stage(esz, KS);
  return BARS + (ring > 4LL * TW * TW ? ring : 4LL * TW * TW) + 1024;
}

__host__ __device__ inline int tstride(int esz, int cols, bool kcols) {
  return esz == 2 ? cols : f32_stride(cols, kcols);
}

// ---------------------------------------------------------------------------
// Rounding boundaries.  With bfloat16 operands every product is exact in
// float32, and a float32 FMA loop over k in cuBLAS's order gives its sum bit
// for bit.  The tensor cores align their addends and truncate, so their sums
// may miss by a few float32 ulps, and where the value
// (h, or dh) lies that close to a bfloat16 rounding midpoint it would round
// the other way.  In the backward, where h and dhb feed the weight
// gradients, such values (about 1 in 1000) are summed again as that loop sums
// them, one lane per value, and rewritten in the scratch; dx and db1 keep the
// tensor cores' values, whose difference is inside their tolerance.  In the
// forward a value rounded the other way moves `out` by a fraction of its
// own rounding step, and nothing is summed again.
// ---------------------------------------------------------------------------

constexpr int NEAR = 16;  // float32 ulps from a midpoint that are summed again

__device__ __forceinline__ bool near_midpoint(float x) {
  return abs((int)(__float_as_uint(x) & 0xFFFFu) - 0x8000) < NEAR;
}

// This warp's list of flagged values: `list_add` appends the values of its
// fragments flagged in `mask` (bit i: element i) in a fixed order, calling
// `flush` (which empties the list) whenever it is full.
template <typename Flush>
__device__ __forceinline__ void list_add(uint32_t mask, int2* list, int& pending, int row0,
                                         int col0, Flush flush) {
  const int lane = threadIdx.x & 31, cnt = __popc(mask);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  for (int r0 = 0; r0 < total;) {
    const int take = min(LIST - pending, total - r0);
    int k = incl - cnt;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if ((mask >> i) & 1) {
        if (k >= r0 && k < r0 + take)
          list[pending + k - r0] = make_int2(row0 + frag_row(i), col0 + frag_col(i));
        ++k;
      }
    __syncwarp();
    pending += take;
    r0 += take;
    if (pending == LIST) flush();
  }
}

// The block's ring: the prologue fills stages 0..S-2; after slice s is done
// stage (s - 1) % S is refilled with slice s + S - 1 once every thread has
// released it.  Every thread waits for that and takes the same path (with
// TMA only thread 0's copies are issued, by predicate): ptxas serializes
// the products of a warpgroup whose threads part ways while they are in flight.
template <int S, typename Issue>
__device__ __forceinline__ void refill(int s, int total, uint32_t full, uint32_t empty,
                                       Issue issue) {
  if (s > 0) mbar_arrive(empty + 8 * ((s - 1) % S));
  if (s + S - 1 >= total) return;
  if (s > 0) mbar_wait(empty + 8 * ((s - 1) % S), ((s - 1) / S) & 1);
  issue(s + S - 1);
}

// ---------------------------------------------------------------------------
// K10f
// ---------------------------------------------------------------------------

template <typename T, int NA>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fwd_kernel(const __grid_constant__ Maps maps, const T* __restrict__ xn,
               const T* __restrict__ res, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, void* __restrict__ out, int N, int D, int F,
               float alpha, int tma, int stream, int partial) {
  constexpr int KS = Kind<T>::KS, ESZ = sizeof(T), S = row_stages(NA, ESZ);
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  char* sb = aligned_base(smem_raw, base);
  const FwdPlan p = fwd_plan(ESZ, KS, D, NA, stream);
  const uint32_t full = base, empty = base + 8 * S;
  const int wg = threadIdx.x / WG;
  const int row0 = blockIdx.x * ROWS;
  const int DK = (int)round_up(D, KS), DP = 128 * NA, dc0 = blockIdx.y * DP;
  const int nk1 = DK / KS, per = nk1 + FC / KS, total = ((F + FC - 1) / FC) * per;
  const bool vD = aligned16(xn, D, ESZ) && aligned16(w2, D, ESZ);
  const bool vF = aligned16(w1, F, ESZ);
  auto stage_at = [&](int s) { return (uint32_t)(p.stage0 + (s % S) * p.stage); };
  // a slice of xn [64, KS] (streamed) and of W1 [KS, FC] (u), or of W2
  // [KS, DP] at the group's columns (the output); W1's and W2's MN-major
  auto xsl = [&](int s) { return Tile{stage_at(s), ROWS, KS, tstride(ESZ, KS, true)}; };
  auto w1s = [&](int s) {
    return Tile{stage_at(s) + (uint32_t)p.w1s, KS, FC, tstride(ESZ, FC, false)};
  };
  auto w2s = [&](int s) { return Tile{stage_at(s), KS, DP, tstride(ESZ, DP, false)}; };
  auto issue = [&](int s) {
    const int c = s / per, k = s - c * per;
    const uint32_t bar = full + 8 * (s % S);
    const bool whole_x = s == 0 && !stream, x_slice = k < nk1 && stream;
    if (tma) {  // maps: xn, W1, W2
      uint32_t bytes = 0;
      if (whole_x) bytes += p.xs.rows * p.xs.cols * 2;
      if (x_slice) bytes += ROWS * KS * 2;
      bytes += k < nk1 ? KS * FC * 2 : KS * DP * 2;
      mbar_expect(bar, bytes);
      if (whole_x) tma_tile(maps.m[0], base, p.xs, row0, 0, bar);
      if (x_slice) tma_tile(maps.m[0], base, xsl(s), row0, k * KS, bar);
      if (k < nk1) tma_tile(maps.m[1], base, w1s(s), k * KS, c * FC, bar);
      else tma_tile(maps.m[2], base, w2s(s), c * FC + (k - nk1) * KS, dc0, bar);
    } else {
      if (whole_x) load_tile<T>(base, sb, p.xs, xn, D, N, D, row0, 0, vD);
      if (x_slice) load_tile<T>(base, sb, xsl(s), xn, D, N, D, row0, k * KS, vD);
      if (k < nk1) load_tile<T>(base, sb, w1s(s), w1, F, D, F, k * KS, c * FC, vF);
      else load_tile<T>(base, sb, w2s(s), w2, D, F, D, c * FC + (k - nk1) * KS, dc0, vD);
      mbar_produced(bar, vD && vF);
    }
  };
  init_ring(full, empty, S, tma);
  for (int s = 0; s < S - 1 && s < total; ++s) issue(s);

  float acc[NA][32], u[1][32];
  zero(acc);
  zero(u);
  for (int s = 0; s < total; ++s) {
    mbar_wait(full + 8 * (s % S), (s / S) & 1);
    fence_proxy_async();
    const int c = s / per, k = s - c * per;
    if (k < nk1) {
      product<T, 1, true, false>(u, sb, base, stream ? xsl(s) : p.xs, stream ? 0 : k * KS,
                                 w1s(s), 64 * wg, k == 0);
      if (k == nk1 - 1) {  // swish, rounded, into this warpgroup's half of h
        retire<T, 0>(u);
        __syncthreads();  // both warpgroups are done with the chunk before's h
        float bb[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int f = c * FC + 64 * wg + frag_col(2 * (j & ~1) + (j & 1));
          bb[j] = f < F ? b1[f] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int q = 2 * (i >> 2);
          const float v0 = u[0][i] + bb[q], v1 = u[0][i + 1] + bb[q + 1];
          store_pair(reinterpret_cast<T*>(sb + at<T>(p.hs, frag_row(i), 64 * wg + frag_col(i))),
                     v0 * sigmoid_f32(v0), v1 * sigmoid_f32(v1));
        }
        fence_proxy_async();
        __syncthreads();
      }
    } else {
      product<T, NA, true, false>(acc, sb, base, p.hs, (k - nk1) * KS, w2s(s), 64 * NA * wg);
    }
    // the products of slice s - 1 are done: its stage is released and refilled
    retire<T, 1>(acc);
    refill<S>(s, total, full, empty, issue);
  }
  retire<T, 0>(acc);

#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = row0 + frag_row(i), col = dc0 + 64 * NA * wg + 64 * a + frag_col(i);
      if (row < N && col < D) {
        if (partial) {  // the share of a split half-step, float32
          store_row_pair(reinterpret_cast<float*>(out) + (long long)row * D, col, D,
                         alpha * acc[a][i], alpha * acc[a][i + 1]);
          continue;
        }
        const T* r = res + (long long)row * D;
        const float r1 = col + 1 < D ? to_f32(r[col + 1]) : 0.0f;
        const float b21 = col + 1 < D ? b2[col + 1] : 0.0f;
        store_row_pair(reinterpret_cast<T*>(out) + (long long)row * D, col, D,
                       to_f32(r[col]) + alpha * (acc[a][i] + b2[col]),
                       r1 + alpha * (acc[a][i + 1] + b21));
      }
    }
}

// ---------------------------------------------------------------------------
// K10b pass 1: rows
// ---------------------------------------------------------------------------

template <typename T, int NA>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_rows_kernel(const __grid_constant__ Maps maps, const T* __restrict__ xn,
                    const T* __restrict__ g, const T* __restrict__ w1,
                    const float* __restrict__ b1, const T* __restrict__ w2,
                    void* __restrict__ dx, T* __restrict__ hbuf, T* __restrict__ dhbuf,
                    float* __restrict__ db1_part, float* __restrict__ db2_part, int N, int D,
                    int F, float alpha, int tma, int partial) {
  constexpr int KS = Kind<T>::KS, ESZ = sizeof(T), S = row_stages(NA, ESZ);
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  char* sb = aligned_base(smem_raw, base);
  const RowsPlan p = rows_plan(ESZ, KS, NA);
  const uint32_t full = base, empty = base + 8 * S;
  float* red = reinterpret_cast<float*>(sb + p.red);
  const int tid = threadIdx.x, wg = tid / WG, lane = tid & 31, wq = (tid % WG) >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int DK = (int)round_up(D, KS), DP = 128 * NA, dc0 = blockIdx.y * DP;
  // the first column group writes h, dhb and the bias partials
  const bool lead = blockIdx.y == 0;
  const int nk1 = DK / KS, per = nk1 + FC / KS, total = ((F + FC - 1) / FC) * per;
  const bool vD = aligned16(xn, D, ESZ) && aligned16(g, D, ESZ) && aligned16(w2, D, ESZ);
  const bool vF = aligned16(w1, F, ESZ);
  auto stage_at = [&](int s) { return (uint32_t)(p.stage0 + (s % S) * p.stage); };
  // the four tiles of a u / t slice, and the W1^T slice of dx
  auto xsl = [&](int s) { return Tile{stage_at(s) + (uint32_t)p.xsl, ROWS, KS, tstride(ESZ, KS, true)}; };
  auto gsl = [&](int s) { return Tile{stage_at(s) + (uint32_t)p.gsl, ROWS, KS, tstride(ESZ, KS, true)}; };
  auto w1s = [&](int s) { return Tile{stage_at(s) + (uint32_t)p.w1s, KS, FC, tstride(ESZ, FC, false)}; };
  auto w2t = [&](int s) { return Tile{stage_at(s) + (uint32_t)p.w2t, FC, KS, tstride(ESZ, KS, true)}; };
  auto w1k = [&](int s) { return Tile{stage_at(s), DP, KS, tstride(ESZ, KS, true)}; };
  auto issue = [&](int s) {
    const int c = s / per, k = s - c * per;
    const uint32_t bar = full + 8 * (s % S);
    if (tma) {  // maps: xn, g, W1, W2
      mbar_expect(bar, k < nk1 ? (2 * ROWS * KS + 2 * KS * FC) * 2 : DP * KS * 2);
      if (k < nk1) {
        tma_tile(maps.m[0], base, xsl(s), row0, k * KS, bar);
        tma_tile(maps.m[1], base, gsl(s), row0, k * KS, bar);
        tma_tile(maps.m[2], base, w1s(s), k * KS, c * FC, bar);
        tma_tile(maps.m[3], base, w2t(s), c * FC, k * KS, bar);
      } else {
        tma_tile(maps.m[2], base, w1k(s), dc0, c * FC + (k - nk1) * KS, bar);
      }
    } else {
      if (k < nk1) {
        load_tile<T>(base, sb, xsl(s), xn, D, N, D, row0, k * KS, vD);
        load_tile<T>(base, sb, gsl(s), g, D, N, D, row0, k * KS, vD);
        load_tile<T>(base, sb, w1s(s), w1, F, D, F, k * KS, c * FC, vF);
        load_tile<T>(base, sb, w2t(s), w2, D, F, D, c * FC, k * KS, vD);
      } else {  // W1[dc0 : dc0 + DP, c FC + (k - nk1) KS : +KS], read as W1^T K-major
        load_tile<T>(base, sb, w1k(s), w1, F, D, F, dc0, c * FC + (k - nk1) * KS, vF);
      }
      mbar_produced(bar, vD && vF);
    }
  };
  init_ring(full, empty, S, tma);
  for (int s = 0; s < S - 1 && s < total; ++s) issue(s);

  // values of h or dhb that the tensor cores' sums may round the other way
  // are listed by their warp and, at the end (or when the list is full),
  // summed again in order and rewritten in the scratch.  Each lane takes a
  // value and loads its operands 32 terms at a time before it adds them in
  // order, so that a load's latency is paid once for 32 terms.
  int2* list = reinterpret_cast<int2*>(sb + p.fix) + (tid >> 5) * LIST;
  int pending = 0;
  auto flush = [&](auto batch) {
    constexpr int B = decltype(batch)::value;
    for (int j = lane; j < pending; j += 32) {
      const int2 e = list[j];  // (row, f)
      const T* xr = xn + (long long)e.x * D;
      const T* gr = g + (long long)e.x * D;
      const T* w1c = w1 + e.y;
      const T* w2r = w2 + (long long)e.y * D;
      float uu = 0.0f, tt = 0.0f;
      for (int d0 = 0; d0 < D; d0 += B) {
        T x[B], w[B], y[B], v[B];
#pragma unroll
        for (int d = 0; d < B; ++d) {
          const bool in = d0 + d < D;
          x[d] = in ? xr[d0 + d] : from_f32<T>(0.0f);
          w[d] = in ? w1c[(long long)(d0 + d) * F] : from_f32<T>(0.0f);
          y[d] = in ? gr[d0 + d] : from_f32<T>(0.0f);
          v[d] = in ? w2r[d0 + d] : from_f32<T>(0.0f);
        }
#pragma unroll
        for (int d = 0; d < B; ++d) {
          uu = fmaf(to_f32(x[d]), to_f32(w[d]), uu);
          tt = fmaf(to_f32(y[d]), to_f32(v[d]), tt);
        }
      }
      uu += b1[e.y];
      const float sig = sigmoid_f32(uu);
      const long long o = (long long)e.x * F + e.y;
      hbuf[o] = from_f32<T>(uu * sig);
      dhbuf[o] = from_f32<T>(dswish(tt, alpha, uu, sig));
    }
    __syncwarp();
    pending = 0;
  };
  // a full list inside the loop, where the accumulators hold registers: a
  // narrow batch; at the end: 32 terms a load round
  auto flush_now = [&]() { flush(std::integral_constant<int, 4>()); };

  float acc[NA][32], u[1][32], t[1][32];
  zero(acc);
  zero(u);
  zero(t);
  for (int s = 0; s < total; ++s) {
    mbar_wait(full + 8 * (s % S), (s / S) & 1);
    fence_proxy_async();
    const int c = s / per, k = s - c * per;
    if (k < nk1) {
      product<T, 1, true, false>(u, sb, base, xsl(s), 0, w1s(s), 64 * wg, k == 0);  // u += xn W1
      product<T, 1, true, true>(t, sb, base, gsl(s), 0, w2t(s), 64 * wg, k == 0);   // t += g W2^T
      if (lead && c == 0 && tid < KS && k * KS + tid < D) {  // this block's share of db2
        const Tile gt = gsl(s);
        float sum = 0.0f;
        for (int r = 0; r < ROWS; ++r)
          sum += to_f32(*reinterpret_cast<const T*>(sb + at<T>(gt, r, tid)));
        db2_part[(long long)blockIdx.x * D + k * KS + tid] = sum;
      }
      if (k == nk1 - 1) {
        retire<T, 0>(u);
        fence_acc(t);
        __syncthreads();  // both warpgroups are done with the chunk before's dhb
        float colsum[16];
        // b1 of this thread's columns (bias 0 past F)
        auto bias = [&](int i) {
          const int f = c * FC + 64 * wg + frag_col(i);
          return f < F ? b1[f] : 0.0f;
        };
        uint32_t mask = 0;  // values near a rounding midpoint (bfloat16)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = frag_row(i), col = 64 * wg + frag_col(i), q = 2 * (i >> 2);
          float h[2], dh[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float uu = u[0][i + e] + bias(i + e);
            const float sig = sigmoid_f32(uu);
            h[e] = uu * sig;
            // rows past N have g = 0, so their dh is 0
            dh[e] = dswish(t[0][i + e], alpha, uu, sig);
            if (sizeof(T) == 2 && lead && row0 + r < N && c * FC + col + e < F &&
                (near_midpoint(h[e]) || near_midpoint(dh[e])))
              mask |= 1u << (i + e);
          }
          store_pair(reinterpret_cast<T*>(sb + at<T>(p.dhs, r, col)), dh[0], dh[1]);
          if (lead && row0 + r < N) {
            const long long o = (long long)(row0 + r) * F;
            store_row_pair(hbuf + o, c * FC + col, F, h[0], h[1]);
            store_row_pair(dhbuf + o, c * FC + col, F, dh[0], dh[1]);
          }
          if (i & 2) {
            colsum[q] += dh[0];
            colsum[q + 1] += dh[1];
          } else {
            colsum[q] = dh[0];
            colsum[q + 1] = dh[1];
          }
        }
        if constexpr (sizeof(T) == 2)
          if (__any_sync(0xffffffffu, mask))
            list_add(mask, list, pending, row0, c * FC + 64 * wg, flush_now);
        fence_proxy_async();
        // db1: the unrounded dh summed over the block's rows in a fixed order
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          colsum[j] += __shfl_xor_sync(0xffffffffu, colsum[j], 4);
          colsum[j] += __shfl_xor_sync(0xffffffffu, colsum[j], 8);
          colsum[j] += __shfl_xor_sync(0xffffffffu, colsum[j], 16);
        }
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            red[wq * FC + 64 * wg + 8 * (j >> 1) + 2 * lane + (j & 1)] = colsum[j];
        }
        __syncthreads();
        if (lead && tid < FC && c * FC + tid < F)
          db1_part[(long long)blockIdx.x * F + c * FC + tid] =
              ((red[tid] + red[FC + tid]) + red[2 * FC + tid]) + red[3 * FC + tid];
      }
    } else {  // dx += dhb W1^T[c, group's columns]
      product<T, NA, true, true>(acc, sb, base, p.dhs, (k - nk1) * KS, w1k(s), 64 * NA * wg);
    }
    retire<T, 1>(acc);
    refill<S>(s, total, full, empty, issue);
  }
  retire<T, 0>(acc);

#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = row0 + frag_row(i), col = dc0 + 64 * NA * wg + 64 * a + frag_col(i);
      if (row < N) {
        if (partial)  // the share of a split half-step, float32
          store_row_pair(reinterpret_cast<float*>(dx) + (long long)row * D, col, D, acc[a][i],
                         acc[a][i + 1]);
        else
          store_row_pair(reinterpret_cast<T*>(dx) + (long long)row * D, col, D, acc[a][i],
                         acc[a][i + 1]);
      }
    }
  if (sizeof(T) == 2 && __any_sync(0xffffffffu, pending)) flush(std::integral_constant<int, 32>());
}

// ---------------------------------------------------------------------------
// K10b pass 2: weight gradients, then the bias sums
// ---------------------------------------------------------------------------

// Blocks [0, tiles) own the 64 x 64 tiles of dW1 [D, F] = xn^T dhb, the next
// `tiles` those of dW2 [F, D] = alpha h^T g, the rest 256 columns each of
// db1 (F) then db2 (D): part [nblk, .] summed in block order.  Maps: xn,
// dhb, h, g.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_weights_kernel(const __grid_constant__ Maps maps, const T* __restrict__ xn,
                       const T* __restrict__ g, const T* __restrict__ hbuf,
                       const T* __restrict__ dhbuf, const float* __restrict__ db1_part,
                       const float* __restrict__ db2_part, float* __restrict__ dw1,
                       float* __restrict__ db1, float* __restrict__ dw2,
                       float* __restrict__ db2, int N, int D, int F, int nblk, float alpha,
                       int tma) {
  constexpr int KS = Kind<T>::KS, ESZ = sizeof(T);
  const int td = (D + TW - 1) / TW, tf = (F + TW - 1) / TW, tiles = td * tf;
  const int tid = threadIdx.x, wg = tid / WG;
  int b = blockIdx.x;
  if (b >= 2 * tiles) {
    const int j = (b - 2 * tiles) * THREADS + tid;
    const bool one = j < F;
    const float* part = one ? db1_part : db2_part;
    const int n = one ? F : D, col = one ? j : j - F;
    if (col >= n) return;
    float sum = 0.0f;
    for (int blk = 0; blk < nblk; ++blk) sum += part[(long long)blk * n + col];
    if (one) db1[col] = sum;
    else db2[col] = alpha * sum;
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  char* sb = aligned_base(smem_raw, base);
  const uint32_t full = base, empty = base + 8 * NSTW;
  const bool first = b < tiles;
  if (!first) b -= tiles;
  const T* A = first ? xn : hbuf;   // [N, M]
  const T* B = first ? dhbuf : g;   // [N, Nc]
  const CUtensorMap& mA = maps.m[first ? 0 : 2];
  const CUtensorMap& mB = maps.m[first ? 1 : 3];
  float* C = first ? dw1 : dw2;     // [M, Nc]
  const int M = first ? D : F, Nc = first ? F : D;
  const int m0 = (b / (first ? tf : td)) * TW, n0 = (b % (first ? tf : td)) * TW;
  const float scale = first ? 1.0f : alpha;
  const bool vec = aligned16(A, M, ESZ) && aligned16(B, Nc, ESZ);
  const int nsl = (N + KS - 1) / KS, half = (nsl + 1) / 2;
  const long long sbytes = weights_stage(ESZ, KS), tb = sbytes / 4;
  const int stride = tstride(ESZ, TW, false);
  // stage: A and B slices of warpgroup 0 (rows s KS), then of warpgroup 1
  // (rows (s + half) KS)
  auto tile = [&](int s, int j) {
    return Tile{(uint32_t)(BARS + (s % NSTW) * sbytes + j * tb), KS, TW, stride};
  };
  auto issue = [&](int s) {
    const uint32_t bar = full + 8 * (s % NSTW);
    if (tma) mbar_expect(bar, 4 * KS * TW * 2);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int r0 = (s + w * half) * KS;
      if (tma) {
        tma_tile(mA, base, tile(s, 2 * w), r0, m0, bar);
        tma_tile(mB, base, tile(s, 2 * w + 1), r0, n0, bar);
      } else {
        load_tile<T>(base, sb, tile(s, 2 * w), A, M, N, M, r0, m0, vec);
        load_tile<T>(base, sb, tile(s, 2 * w + 1), B, Nc, N, Nc, r0, n0, vec);
      }
    }
    if (!tma) mbar_produced(bar, vec);
  };
  init_ring(full, empty, NSTW, tma);
  for (int s = 0; s < NSTW - 1 && s < half; ++s) issue(s);

  float acc[1][32];
  zero(acc);
  for (int s = 0; s < half; ++s) {
    mbar_wait(full + 8 * (s % NSTW), (s / NSTW) & 1);
    fence_proxy_async();
    product<T, 1, false, false>(acc, sb, base, tile(s, 2 * wg), 0, tile(s, 2 * wg + 1), 0);
    retire<T, 1>(acc);
    refill<NSTW>(s, half, full, empty, issue);
  }
  retire<T, 0>(acc);
  __syncthreads();  // every product is done: the ring's memory is free
  float* other = reinterpret_cast<float*>(sb + BARS);  // [64, 64], warpgroup 1's sums
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) other[frag_row(i) * TW + frag_col(i)] = acc[0][i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = frag_row(i), c = frag_col(i);
      if (m0 + r < M && n0 + c < Nc)
        C[(long long)(m0 + r) * Nc + n0 + c] = scale * (acc[0][i] + other[r * TW + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

constexpr long long TOO_BIG = 0x7fffffffLL;

int shared_limit();

// The output's columns in groups of at most 384 (64 NA per warpgroup), one
// grid row of blocks each: as few groups as the width needs, as even as the
// 128-column steps allow (D 512: two of 256)
int col_groups(int D) { return ((D + 127) / 128 + MAX_NA - 1) / MAX_NA; }
int na_of(int D) {
  const int steps = (D + 127) / 128, groups = col_groups(D);
  return (steps + groups - 1) / groups;
}

// whether the forward streams xn (see fwd_plan): past one column group, or
// where the [64, D] tile and the ring do not fit the device's shared memory
bool fwd_streams(int D, int esz) {
  const int KS = esz == 2 ? Kind<bf16>::KS : Kind<float>::KS;
  return col_groups(D) > 1 || fwd_plan(esz, KS, D, na_of(D), false).total > shared_limit();
}

long long shared_bytes(int D, int esz, int backward) {
  const int na = na_of(D);
  const int KS = esz == 2 ? Kind<bf16>::KS : Kind<float>::KS;
  return backward ? rows_plan(esz, KS, na).total
                  : fwd_plan(esz, KS, D, na, fwd_streams(D, esz)).total;
}

// the device's opt-in limit, asked once per device
int shared_limit() {
  static int limits[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (limits[dev] == 0 &&
      cudaDeviceGetAttribute(&limits[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return limits[dev];
}

// Raise `kernel`'s dynamic shared-memory allowance to `bytes`; `granted`
// (one per kernel) remembers the largest allowance set, so that a launch at
// a size already allowed makes no runtime call.
template <typename K>
int allow_shared(K kernel, long long bytes, long long& granted) {
  if (bytes <= granted) return 0;
  if (bytes > shared_limit()) return (int)cudaErrorInvalidValue;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)bytes);
  if (!err) granted = bytes;
  return err;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map of the bfloat16 array [rows, cols] in 64 x 64 boxes, 128-byte swizzle
bool encode(CUtensorMap* m, const void* ptr, int rows, int cols) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {BOX, BOX}, step[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// TMA for bfloat16 operands whose arrays are [rows >= 64, cols >= 64] with
// 16-byte aligned bases and rows; the maps of the arrays, in order
template <typename T>
bool make_maps(Maps& maps, std::initializer_list<std::tuple<const void*, int, int>> arrays) {
  if (sizeof(T) != 2) return false;
  int i = 0;
  for (const auto& [ptr, rows, cols] : arrays) {
    if (rows < BOX || cols < BOX || ((uintptr_t)ptr & 15) || (cols * 2) % 16) return false;
    if (!encode(&maps.m[i++], ptr, rows, cols)) return false;
  }
  return true;
}

template <typename T, int NA>
int forward_na(const void* xn, const void* res, const void* w1, const float* b1, const void* w2,
               const float* b2, void* out, int N, int D, int F, float alpha, int partial,
               cudaStream_t stream) {
  static long long granted = 0;
  const bool streams = fwd_streams(D, sizeof(T));
  const long long bytes = fwd_plan(sizeof(T), Kind<T>::KS, D, NA, streams).total;
  const int err = allow_shared(ffn_fwd_kernel<T, NA>, bytes, granted);
  if (err) return err;
  Maps maps{};
  const bool tma = make_maps<T>(maps, {{xn, N, D}, {w1, D, F}, {w2, F, D}});
  const dim3 grid((N + ROWS - 1) / ROWS, col_groups(D));
  ffn_fwd_kernel<T, NA><<<grid, THREADS, bytes, stream>>>(
      maps, (const T*)xn, (const T*)res, (const T*)w1, b1, (const T*)w2, b2, out, N, D, F,
      alpha, tma, streams, partial);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const void* xn, const void* res, const void* w1, const float* b1, const void* w2,
            const float* b2, void* out, int N, int D, int F, float alpha, int partial,
            cudaStream_t stream) {
  switch (na_of(D)) {
    case 1: return forward_na<T, 1>(xn, res, w1, b1, w2, b2, out, N, D, F, alpha, partial, stream);
    case 2: return forward_na<T, 2>(xn, res, w1, b1, w2, b2, out, N, D, F, alpha, partial, stream);
    case 3: return forward_na<T, 3>(xn, res, w1, b1, w2, b2, out, N, D, F, alpha, partial, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int NA>
int rows_na(const void* xn, const void* g, const void* w1, const float* b1, const void* w2,
            void* dx, void* hbuf, void* dhbuf, float* db1_part, float* db2_part, int N, int D,
            int F, float alpha, int partial, cudaStream_t stream) {
  static long long granted = 0;
  const long long bytes = shared_bytes(D, sizeof(T), 1);
  const int err = allow_shared(ffn_bwd_rows_kernel<T, NA>, bytes, granted);
  if (err) return err;
  Maps maps{};
  const bool tma = make_maps<T>(maps, {{xn, N, D}, {g, N, D}, {w1, D, F}, {w2, F, D}});
  const dim3 grid((N + ROWS - 1) / ROWS, col_groups(D));
  ffn_bwd_rows_kernel<T, NA><<<grid, THREADS, bytes, stream>>>(
      maps, (const T*)xn, (const T*)g, (const T*)w1, b1, (const T*)w2, dx, (T*)hbuf,
      (T*)dhbuf, db1_part, db2_part, N, D, F, alpha, tma, partial);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* xn, const void* g, const void* w1, const float* b1, const void* w2,
             void* dx, void* hbuf, void* dhbuf, float* db1_part, float* db2_part, float* dw1,
             float* db1, float* dw2, float* db2, int N, int D, int F, float alpha, int partial,
             cudaStream_t stream) {
  int err;
  switch (na_of(D)) {
    case 1: err = rows_na<T, 1>(xn, g, w1, b1, w2, dx, hbuf, dhbuf, db1_part, db2_part, N, D, F, alpha, partial, stream); break;
    case 2: err = rows_na<T, 2>(xn, g, w1, b1, w2, dx, hbuf, dhbuf, db1_part, db2_part, N, D, F, alpha, partial, stream); break;
    case 3: err = rows_na<T, 3>(xn, g, w1, b1, w2, dx, hbuf, dhbuf, db1_part, db2_part, N, D, F, alpha, partial, stream); break;
    default: err = (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  static long long granted = 0;
  const long long bytes = weights_bytes(sizeof(T), Kind<T>::KS);
  if ((err = allow_shared(ffn_bwd_weights_kernel<T>, bytes, granted))) return err;
  Maps maps{};
  const bool tma =
      make_maps<T>(maps, {{xn, N, D}, {dhbuf, N, F}, {hbuf, N, F}, {g, N, D}});
  const int tiles = ((D + TW - 1) / TW) * ((F + TW - 1) / TW);
  const int nblk = (N + ROWS - 1) / ROWS;
  const int bias_blocks = (F + D + THREADS - 1) / THREADS;
  ffn_bwd_weights_kernel<T><<<2 * tiles + bias_blocks, THREADS, bytes, stream>>>(
      maps, (const T*)xn, (const T*)g, (const T*)hbuf, (const T*)dhbuf, db1_part, db2_part, dw1,
      db1, dw2, db2, N, D, F, nblk, alpha, tma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Rows of xn that one block of the forward and of the backward's first pass
// owns: the per-block partial sums are [ceil(N / rows), F] and [.., D].
int ffn_rows_per_block() { return ROWS; }

// Shared memory per block, in bytes, of the forward (backward = 0) or of the
// backward's first pass (1) at width D, for float32 (is_bf16 = 0) or
// bfloat16 (1) operands, on the current device (the forward streams xn
// where its tile would not fit).
int ffn_shared_bytes(int D, int is_bf16, int backward) {
  const long long bytes = shared_bytes(D, is_bf16 ? 2 : 4, backward);
  return bytes > TOO_BIG ? (int)TOO_BIG : (int)bytes;
}

// The most shared memory a block may ask for on the current device.
int ffn_shared_limit() { return shared_limit(); }

// K10f: xn, res [N, D], w1 [D, F], w2 [F, D] in the trunk dtype, b1 [F] and
// b2 [D] f32 -> out [N, D] in the trunk dtype; with `partial`, res and b2 are
// not read and out = alpha * (h W2) [N, D] is float32.
int ffn_forward(const void* xn, const void* res, const void* w1, const float* b1, const void* w2,
                const float* b2, void* out, int N, int D, int F, float alpha, int is_bf16,
                int partial, cudaStream_t stream) {
  if (N == 0 || D == 0) return 0;
  if (F == 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? forward<bf16>(xn, res, w1, b1, w2, b2, out, N, D, F, alpha, partial, stream)
                 : forward<float>(xn, res, w1, b1, w2, b2, out, N, D, F, alpha, partial, stream);
}

// K10b, two launches: xn, g [N, D], w1 [D, F], w2 [F, D] in the trunk dtype,
// b1 [F] f32 -> dx [N, D] (trunk dtype), dw1 [D, F], db1 [F], dw2 [F, D],
// db2 [D] (f32); scratch hbuf, dhbuf [N, F] (trunk dtype), db1_part
// [blocks, F] and db2_part [blocks, D] (f32), blocks = ceil(N / rows); with
// `partial`, dx is float32.
int ffn_backward(const void* xn, const void* g, const void* w1, const float* b1, const void* w2,
                 void* dx, void* hbuf, void* dhbuf, float* db1_part, float* db2_part,
                 float* dw1, float* db1, float* dw2, float* db2, int N, int D, int F,
                 float alpha, int is_bf16, int partial, cudaStream_t stream) {
  if (N == 0 || D == 0) return 0;
  if (F == 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? backward<bf16>(xn, g, w1, b1, w2, dx, hbuf, dhbuf, db1_part, db2_part, dw1,
                                   db1, dw2, db2, N, D, F, alpha, partial, stream)
                 : backward<float>(xn, g, w1, b1, w2, dx, hbuf, dhbuf, db1_part, db2_part, dw1,
                                   db1, dw2, db2, N, D, F, alpha, partial, stream);
}

}  // extern "C"
