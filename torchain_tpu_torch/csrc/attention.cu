// Fused multi-head self-attention with relative-position bias:
// kernels K7f (forward) and K7b (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/attention.py:
//   K7f  attention_forward  -> _fwd_kernel (pallas_call :219)
//   K7b  attention_backward -> _bwd_kernel (pallas_call :258)
//
//   out[b, t, h*dh + d] = sum_s softmax_s(scale * q_h[t] . k_h[s] + bias[h, t, s]) * v_h[s, d]
//
// with q_h, k_h, v_h the [T, dh] slices of qkv [B, T, 3D] at columns
// h*dh + {0, D, 2D}.  qkv, out, g and dqkv are float32 or bfloat16; the
// softmax is float32, the probabilities are not rounded to qkv's dtype
// before the product with v, and the backward recomputes the softmax.
//
// What bounds them on the H100: bytes.  At B=128, T=50, H=4, dh=64 the
// forward moves 13.1 MB of bf16 qkv, bias and out (3.9 us at 3.35 TB/s) for
// 0.33 GFLOP, the backward 23 MB (6.9 us).  The first design computed every
// product as a scalar FMA loop over float32 copies in shared memory, one
// shared-memory wavefront per FMA and warp: some 10 M wavefronts per forward
// call at that shape, whatever the dtype.  Here every product runs on the
// tensor cores (mma.sync), fed from tiles that arrive by cp.async, and the
// logits and probabilities stay in registers (about 0.3 M wavefronts of
// fragment loads per bf16 forward call):
//   * Tiles.  A block has four warps and owns 64 rows (16 a warp) of one
//     (batch row, head); the other operand comes in tiles of 64 rows, two
//     stages deep, the next tile's copies in flight while this one's products
//     run.  A tile is [64, DHP]: dh (1..128) padded with zeros to DHP, a
//     multiple of 16 up to 64, else 96 or 128 (dh 65-96 pads to 96, 97-128
//     to 128: two instantiations more, not four), and each row padded by 16
//     bytes so that fragment loads hit distinct banks.  Rows past T are
//     zero-filled by the copy.  The shared memory of a block depends on dh,
//     never on T: at DHP 128 a bf16 forward block holds 87,040 bytes, a
//     float32 backward block 202,752 of the H100's 232,448.
//   * bfloat16 operands: mma.m16n8k16 bf16 fed by ldmatrix (.trans for the
//     operand whose rows are the summed index).  A bf16 product is exact in
//     float32, so q k^T and g v^T take one product each.  A float32
//     probability or logit gradient (p, dl) used as an operand is split into
//     hi = bf16(x), mid = bf16(x - hi) and lo = bf16(x - hi - mid) and enters
//     three products (relative error near 2^-26, below a float32 rounding).
//     A split into two (hi, lo; error near 2^-17) moved the bf16 outputs off
//     the plain version's by one rounding step some 40 times as often as
//     float32 reordering does (tests/test_torch_attention.py sizes both).
//   * float32 operands: 3xTF32 on mma.m16n8k8 as in K10 (csrc/fused_ffn.cu),
//     lo*hi + hi*lo + hi*hi, fragments read from the padded tiles and split in
//     registers.
//   * The accumulator of a warp's [16, 64] logit tile is the A operand of the
//     next product (flash attention's reuse).  For bf16 the m16n8 accumulator
//     pairs are the m16n8k16 A fragment; for TF32 the summed index is permuted
//     in both operands (k slot t <-> column 2t, t + 4 <-> 2t + 1) so that the
//     accumulator is the A fragment too.
//   * Sums over T: bf16 outputs take the products straight into the tensor
//     cores' accumulators; float32 outputs sum each tile's products into zeros
//     and add that on the float32 units, since the tensor cores' accumulation
//     truncates its addends (not round-to-nearest).
//   * The bias tile of an item is loaded into registers before the wait for
//     its operand tiles, so that those loads are in flight together; the
//     logits are kept in base 2 (scale and bias times log2 e) for exp2f.
// Forward: one block per (batch row, head, 64 query rows), an online softmax
// over the key tiles: 512 blocks at the shape above, in one wave of four bf16
// blocks per SM (at most 128 registers a thread).  At DHP 96 and 128 the
// output accumulators alone take 48 and 64 registers beside the 64 of the
// logit and bias tiles, so the bf16 forward asks for two blocks per SM there
// (at most 255 registers a thread).
// Backward: three launches, no atomics (two calls give the same bits):
//   rows  one block per (batch chunk, head, 64 query rows).  For each batch
//         row in order: a pass over the key tiles for the softmax statistics
//         lse and delta = sum_s p dp (written to [B, H, T] scratches), then
//         (with the registers of that pass where T <= 64) dl = p (dp - delta),
//         dq = scale dl k, and dl added into the chunk's [H, T, T] partial of
//         dbias;
//   cols  one block per (batch row, head, 64 key rows): over the query tiles,
//         p^T and dl^T from lse and delta, dv = p^T g, dk = scale dl^T q;
//   sum   dbias = the chunks' partials added in chunk order (no launch where
//         one chunk holds the whole batch).
// The batch is cut into C chunks so that the rows launch fits one wave of
// three blocks per SM (at most 396 blocks), with at most 32 MiB of partials.
// The scratch is 8 B H T + 4 C H T^2 bytes (C > 1): at B=128, H=4, 2.8 MB at
// T=50 (C = 64), 12.1 MB at T=150 (C = 32), 35.7 MB at T=512 (C = 8), where
// the first design's [B, H, T, T] took 5.1 MB, 46 MB and 537 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * WARPS;  // rows of a tile: 16 per warp
constexpr int MAX_DH = 128;
constexpr int ROWS_BLOCKS = 396;            // the rows launch's most blocks: three per SM of an H100
constexpr long long PART_FLOATS = 1 << 23;  // cap of the dbias partials: 32 MiB

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A [TILE, DHP] tile in shared memory, row stride LD elements: 16 bytes
// (bf16) or 4 floats past DHP
template <typename T, int DHP> struct Tile {
  static constexpr int LD = DHP + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int BYTES = TILE * LD * (int)sizeof(T);
};

// tiles per block: forward q, k[2], v[2]; rows k[2], v[2], q[QG], g[QG];
// cols k, v, q[2], g[2].  The rows launch keeps two stages of q and g for
// bf16 and one for float32 (two blocks per SM in shared memory).
constexpr int FWD_TILES = 5, COLS_TILES = 6;
template <typename T> constexpr int QG_STAGES = sizeof(T) == 2 ? 2 : 1;
template <typename T> constexpr int ROWS_TILES = 4 + 2 * QG_STAGES<T>;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int N> __device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0f;
}

template <int N> __device__ __forceinline__ void add(float (&a)[N][4], const float (&b)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] += b[i][e];
}

// ---------------------------------------------------------------------------
// copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int gran, int bytes) {
  if (gran == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  else if (gran == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most the latest group is in flight
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Zero the block's tiles (the padding columns stay zero: copies never write
// them), then wait for every thread.
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS)
    reinterpret_cast<int4*>(p)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
}

// Rows [r0, r0 + TILE) of a head's [n, dh] slice at src (row stride `stride`
// elements) into tile dst; rows at or past n become zeros.  gran: the bytes
// of one copy, 16, 8 or 4 (cp.async, asynchronous: one group per tile set),
// or 2 (bf16 at an odd dh: element by element).
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, long long stride,
                                          int r0, int n, int dh, int gran) {
  constexpr int LD = Tile<T, DHP>::LD;
  if (gran >= 4) {
    const int per = gran / (int)sizeof(T), cpr = dh / per;
    for (int i = threadIdx.x; i < TILE * cpr; i += THREADS) {
      const int r = i / cpr, c = (i - r * cpr) * per;
      const bool in = r0 + r < n;
      cp_async(smem_u32(dst + r * LD + c), in ? src + (long long)(r0 + r) * stride + c : src, gran,
               in ? gran : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * dh; i += THREADS) {
      const int r = i / dh, c = i - r * dh;
      dst[r * LD + c] = r0 + r < n ? src[(long long)(r0 + r) * stride + c] : from_f32<T>(0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core products.  Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k8),
// g = lane / 4, t = lane % 4: the accumulator of a warp's 16 x 8 block holds
// (row g, columns 2t, 2t + 1) and (row g + 8, the same columns).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi keeps the 10 leading mantissa bits (tf32), lo = x - hi is
// exact, and the tensor cores read lo's 10 leading bits in turn
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b in 3xTF32 (a, b split)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bl0,
                                     uint32_t bh1, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// (x, y) = hi + mid + lo, each packed as a bf16 pair: hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid) (both differences exact in float32)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  x -= hf.x;
  y -= hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(x, y);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - mf.x, y - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[j] = A[16w .. 16w + 16, :] Bt[8j .. 8j + 8, :]^T over the DHP columns of
// two tiles (w the warp): the warp's 16 rows against the 64 rows of Bt.
template <int DHP>
__device__ __forceinline__ void abT(float (&acc)[8][4], const bf16* A, const bf16* Bt) {
  constexpr int LD = Tile<bf16, DHP>::LD;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, mi = lane >> 3, r = lane & 7;
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(A + (16 * w + r + (mi & 1) * 8) * LD + 16 * kk + (mi >> 1) * 8));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(Bt + (16 * jj + r + (mi >> 1) * 8) * LD + 16 * kk + (mi & 1) * 8));
      mma_bf16(acc[2 * jj], a, b[0], b[1]);
      mma_bf16(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

template <int DHP>
__device__ __forceinline__ void abT(float (&acc)[8][4], const float* A, const float* Bt) {
  constexpr int LD = Tile<float, DHP>::LD;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  zero(acc);
  const float* a = A + (16 * w + g) * LD + t;
#pragma unroll
  for (int kk = 0; kk < DHP / 8; ++kk) {
    uint32_t ah[4], al[4];
    split(a[8 * kk], ah[0], al[0]);
    split(a[8 * LD + 8 * kk], ah[1], al[1]);
    split(a[8 * kk + 4], ah[2], al[2]);
    split(a[8 * LD + 8 * kk + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* b = Bt + (8 * j + g) * LD + 8 * kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      split(b[0], bh0, bl0);
      split(b[4], bh1, bl1);
      mma3(acc[j], ah, al, bh0, bl0, bh1, bl1);
    }
  }
}

// acc[n] += P Bm[0 .. 64, 8n .. 8n + 8]: P the warp's [16, 64] float32 tile
// in accumulator layout (p[j] its columns 8j .. 8j + 8), Bm a tile whose 64
// rows are the summed index.
template <int DHP>
__device__ __forceinline__ void pB(float (&acc)[DHP / 8][4], const float (&p)[8][4],
                                   const bf16* Bm) {
  constexpr int LD = Tile<bf16, DHP>::LD;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], mid[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], mid[0], lo[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], mid[1], lo[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], mid[2], lo[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
    for (int nn = 0; nn < DHP / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(Bm + (16 * kk + r + (mi & 1) * 8) * LD + 16 * nn + (mi >> 1) * 8));
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the smallest terms first
        mma_bf16(acc[2 * nn + h], lo, b[2 * h], b[2 * h + 1]);
        mma_bf16(acc[2 * nn + h], mid, b[2 * h], b[2 * h + 1]);
        mma_bf16(acc[2 * nn + h], hi, b[2 * h], b[2 * h + 1]);
      }
    }
  }
}

template <int DHP>
__device__ __forceinline__ void pB(float (&acc)[DHP / 8][4], const float (&p)[8][4],
                                   const float* Bm) {
  constexpr int LD = Tile<float, DHP>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // k slot t is column 8j + 2t, slot t + 4 column 8j + 2t + 1
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
    const float* b = Bm + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split(b[8 * n], bh0, bl0);
      split(b[LD + 8 * n], bh1, bl1);
      mma3(acc[n], ah, al, bh0, bl0, bh1, bl1);
    }
  }
}

// sums += P Bm.  bfloat16 outputs: straight into the sums on the tensor
// cores.  float32: into zeros (tmp), then added on the float32 units, since
// the tensor cores' accumulation truncates its addends (not round-to-nearest).
// The float32 form for bfloat16 gives the same bits where T <= 64 (one tile)
// and took a quarter more of K7b's time at T = 150: its registers left two
// rows blocks per SM, not three.
template <int DHP>
__device__ __forceinline__ void accumulate(float (&sums)[DHP / 8][4], float (&)[DHP / 8][4],
                                           const float (&p)[8][4], const bf16* Bm) {
  pB<DHP>(sums, p, Bm);
}
template <int DHP>
__device__ __forceinline__ void accumulate(float (&sums)[DHP / 8][4], float (&tmp)[DHP / 8][4],
                                           const float (&p)[8][4], const float* Bm) {
  zero(tmp);
  pB<DHP>(tmp, p, Bm);
  add(sums, tmp);
}

constexpr float LOG2E = 1.4426950408889634f;

// The bias of the warp's accumulator cells, rows r0, r0 + 8 and columns
// c0 + 8j + 2t + {0, 1} (0 where either is at or past Tn), into registers.  Issued before
// the wait for a tile, so that these loads are in flight during it.  TRANS:
// the rows are keys and the columns queries, so the bias is read as
// bias[col, row].
template <bool TRANS>
__device__ __forceinline__ void load_bias(float (&bv)[8][4], const float* __restrict__ bh, int r0,
                                          int c0, int Tn) {
  const int t = threadIdx.x & 3, c = c0 + 2 * t;
  if (r0 + 8 < Tn && c0 + TILE <= Tn) {  // this thread's cells all inside
    if (!TRANS && (Tn & 1) == 0) {  // (row, c) pairs 8-byte aligned
      const float* b = bh + (long long)r0 * Tn + c;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(b + 8 * i * Tn + 8 * j));
          bv[j][2 * i] = x.x;
          bv[j][2 * i + 1] = x.y;
        }
    } else {
      const float* b = TRANS ? bh + (long long)c * Tn + r0 : bh + (long long)r0 * Tn + c;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bv[j][e] = __ldg(b + (TRANS ? (8 * j + (e & 1)) * Tn + 8 * (e >> 1)
                                      : 8 * (e >> 1) * Tn + 8 * j + (e & 1)));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1), col = c + 8 * j + (e & 1);
      bv[j][e] = row < Tn && col < Tn ? __ldg(TRANS ? bh + (long long)col * Tn + row
                                                    : bh + (long long)row * Tn + col)
                                      : 0.0f;
    }
}

// s = (scale * s + bias) * log2(e), -inf in columns at or past Tn: the
// logits in base 2, for exp2f
__device__ __forceinline__ void logits(float (&s)[8][4], const float (&bv)[8][4], int c0, int Tn,
                                       float scale) {
  const int c = c0 + 2 * (threadIdx.x & 3);
  const float sc = scale * LOG2E;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = c + 8 * j + (e & 1) < Tn ? s[j][e] * sc + bv[j][e] * LOG2E : -INFINITY;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The warp's accumulator rows r0 and r0 + 8 (columns 8n + 2t + {0, 1} of dh),
// times mul[0] and mul[1], into dst (row stride `stride`), rows below Tn.
// pairs: two neighbouring columns may be stored as one.
template <typename T, int DHP>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long stride,
                                           const float (&acc)[DHP / 8][4], int r0, int Tn,
                                           int dh, const float (&mul)[2], bool pairs) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Tn) continue;
    T* out = dst + (long long)row * stride;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float x = acc[n][2 * i] * mul[i], y = acc[n][2 * i + 1] * mul[i];
      if (pairs && col + 1 < dh) {
        store_pair(out + col, x, y);
      } else {
        if (col < dh) out[col] = from_f32<T>(x);
        if (col + 1 < dh) out[col + 1] = from_f32<T>(y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// K7f: one block per (batch row, head, 64 query rows), grid B * H * nq.
template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? (DHP <= 64 ? 4 : 2) : 1)
attn_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias, T* __restrict__ out,
                int Tn, int H, int dh, float scale, int gran) {
  using L = Tile<T, DHP>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);  // q, k[2], v[2]
  zero_smem(smem, FWD_TILES * L::BYTES);
  const int nk = cdiv(Tn, TILE);
  const int qt = blockIdx.x % nk, bh_ = blockIdx.x / nk, b = bh_ / H, h = bh_ - b * H;
  const int D = H * dh;
  const long long s3 = 3LL * D;
  const T* base = qkv + (long long)b * Tn * s3 + h * dh;
  T* const sq = tiles;
  auto sk = [&](int i) { return tiles + (1 + (i & 1)) * TILE * L::LD; };
  auto sv = [&](int i) { return tiles + (3 + (i & 1)) * TILE * L::LD; };

  load_tile<T, DHP>(sq, base, s3, qt * TILE, Tn, dh, gran);
  load_tile<T, DHP>(sk(0), base + D, s3, 0, Tn, dh, gran);
  load_tile<T, DHP>(sv(0), base + 2 * D, s3, 0, Tn, dh, gran);
  cp_commit();

  const int lane = threadIdx.x & 31;
  const int r0 = qt * TILE + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const float* bh = bias + (long long)h * Tn * Tn;
  float o[DHP / 8][4], pv[DHP / 8][4], s[8][4], bv[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  zero(o);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile<T, DHP>(sk(kt + 1), base + D, s3, (kt + 1) * TILE, Tn, dh, gran);
      load_tile<T, DHP>(sv(kt + 1), base + 2 * D, s3, (kt + 1) * TILE, Tn, dh, gran);
    }
    cp_commit();
    load_bias<false>(bv, bh, r0, kt * TILE, Tn);
    cp_wait_one();
    __syncthreads();
    abT<DHP>(s, sq, sk(kt));
    logits(s, bv, kt * TILE, Tn, scale);
    // online softmax: rescale the running sums to the new row maximum
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float mn = fmaxf(m[i], quad_max(mx)), corr = exp2f(m[i] - mn);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - mn);
          sum += s[j][e];
        }
      m[i] = mn;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int n = 0; n < DHP / 8; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }
    accumulate<DHP>(o, pv, s, sv(kt));
    __syncthreads();
  }
  const float inv[2] = {1.0f / quad_sum(l[0]), 1.0f / quad_sum(l[1])};
  store_rows<T, DHP>(out + (long long)b * Tn * D + h * dh, D, o, r0, Tn, dh, inv,
                     gran >= 2 * (int)sizeof(T));
}

// K7b, launch 1 of 3: one block per (batch chunk, head, 64 query rows), grid
// chunks * H * nq; the batch rows [c * chunk, c * chunk + chunk) in order.
// Writes dq, lse and delta ([B, H, T] each) and the chunk's dbias partial
// dpart[c] ([H, T, T]).
template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
attn_bwd_rows_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dqkv, float* __restrict__ lse_out,
                     float* __restrict__ delta_out, float* __restrict__ dpart, int B, int Tn,
                     int H, int dh, float scale, int chunk, int gran) {
  using L = Tile<T, DHP>;
  constexpr int QG = QG_STAGES<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);  // k[2], v[2], q[QG], g[QG]
  zero_smem(smem, ROWS_TILES<T> * L::BYTES);
  auto tile = [&](int i) { return tiles + i * TILE * L::LD; };
  const int nk = cdiv(Tn, TILE);
  const int qt = blockIdx.x % nk, h = (blockIdx.x / nk) % H, c = blockIdx.x / (nk * H);
  const int b0 = c * chunk, nb = min(chunk, B - b0);
  const int D = H * dh;
  const long long s3 = 3LL * D;
  // items: per batch row, the statistics pass over the nk key tiles, then the
  // gradient pass over them again (one item does both where nk == 1).  The k
  // and v tiles of item i + 1 are copied during item i, and so are the q and g
  // tiles of the next batch row where they have two stages (QG = 2, bf16);
  // with one (float32, for shared memory) after the row's last item.
  const int per_b = nk == 1 ? 1 : 2 * nk, items = nb * per_b;
  auto load_kv = [&](int i) {
    const int bi = i / per_b, kt = (i - bi * per_b) % nk;
    const T* base = qkv + (long long)(b0 + bi) * Tn * s3 + h * dh;
    load_tile<T, DHP>(tile(i & 1), base + D, s3, kt * TILE, Tn, dh, gran);
    load_tile<T, DHP>(tile(2 + (i & 1)), base + 2 * D, s3, kt * TILE, Tn, dh, gran);
  };
  auto load_qg = [&](int bi) {
    const long long row = (long long)(b0 + bi) * Tn;
    load_tile<T, DHP>(tile(4 + bi % QG), qkv + row * s3 + h * dh, s3, qt * TILE, Tn, dh, gran);
    load_tile<T, DHP>(tile(4 + QG + bi % QG), g + row * D + h * dh, D, qt * TILE, Tn, dh, gran);
  };

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = qt * TILE + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const float* bh = bias + (long long)h * Tn * Tn;
  float* part = dpart + (long long)(c * H + h) * Tn * Tn;
  float s[8][4], dp[8][4], dq[DHP / 8][4], tmp[DHP / 8][4];
  float m[2], l[2], ds[2], lse[2], delta[2];
  zero(dq);
  load_qg(0);
  load_kv(0);
  cp_commit();
  for (int i = 0; i < items; ++i) {
    const int bi = i / per_b, j = i - bi * per_b, kt = j % nk, b = b0 + bi;
    if (i + 1 < items) {
      load_kv(i + 1);
      if (QG == 2 && j == per_b - 1) load_qg(bi + 1);
    }
    cp_commit();
    load_bias<false>(dp, bh, r0, kt * TILE, Tn);  // the bias, in dp until g v^T
    cp_wait_one();
    __syncthreads();
    const T* sk = tile(i & 1);
    abT<DHP>(s, tile(4 + bi % QG), sk);
    logits(s, dp, kt * TILE, Tn, scale);
    abT<DHP>(dp, tile(4 + QG + bi % QG), tile(2 + (i & 1)));
    if (j < nk) {  // statistics: online max, sum of exp and sum of exp * dp
      if (kt == 0) {
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = ds[0] = ds[1] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) mx = fmaxf(mx, fmaxf(s[jj][2 * r], s[jj][2 * r + 1]));
        const float mn = fmaxf(m[r], quad_max(mx)), corr = exp2f(m[r] - mn);
        float sum = 0.0f, sd = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float x = exp2f(s[jj][e] - mn);
            sum += x;
            sd += x * dp[jj][e];
          }
        m[r] = mn;
        l[r] = l[r] * corr + sum;
        ds[r] = ds[r] * corr + sd;
      }
      if (kt == nk - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float sum = quad_sum(l[r]);
          lse[r] = m[r] + log2f(sum);
          delta[r] = quad_sum(ds[r]) / sum;
          const int row = r0 + 8 * r;
          if (t == 0 && row < Tn) {
            const long long at = ((long long)b * H + h) * Tn + row;
            lse_out[at] = lse[r];
            delta_out[at] = delta[r];
          }
        }
      }
    }
    if (nk == 1 || j >= nk) {  // gradients: dl = p (dp - delta), in s
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[jj][e] = exp2f(s[jj][e] - lse[e >> 1]) * (dp[jj][e] - delta[e >> 1]);
      // dl into this thread's cells of the chunk's dbias partial (rows r0,
      // r0 + 8; columns kt * TILE + 8jj + 2t + {0, 1}) in batch order.  The
      // earlier rows' sums are loaded into dp, all before the dq product and
      // the stores, so that the loads are in flight during the product.
      float* cells = part + (long long)r0 * Tn + kt * TILE + 2 * t;
      const int cols_in = Tn - kt * TILE - 2 * t;
      const bool rows_in[2] = {r0 < Tn, r0 + 8 < Tn};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = 8 * (e >> 1) * Tn + 8 * jj + (e & 1);
          dp[jj][e] = bi > 0 && rows_in[e >> 1] && 8 * jj + (e & 1) < cols_in ? cells[at] : 0.0f;
        }
      accumulate<DHP>(dq, tmp, s, sk);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (rows_in[e >> 1] && 8 * jj + (e & 1) < cols_in)
            cells[8 * (e >> 1) * Tn + 8 * jj + (e & 1)] = dp[jj][e] + s[jj][e];
      if (kt == nk - 1) {
        const float mul[2] = {scale, scale};
        store_rows<T, DHP>(dqkv + (long long)b * Tn * s3 + h * dh, s3, dq, r0, Tn, dh, mul,
                           gran >= 2 * (int)sizeof(T));
        zero(dq);
      }
    }
    __syncthreads();
    if (QG == 1 && i + 1 < items && j == per_b - 1) {  // the next batch row's q and g
      load_qg(bi + 1);
      cp_commit();
    }
  }
}

// K7b, launch 2 of 3: one block per (batch row, head, 64 key rows), grid
// B * H * nk.  Writes dk and dv.
template <typename T, int DHP>
__global__ void __launch_bounds__(THREADS)
attn_bwd_cols_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dqkv,
                     const float* __restrict__ lse_in, const float* __restrict__ delta_in,
                     int Tn, int H, int dh, float scale, int gran) {
  using L = Tile<T, DHP>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);  // k, v, q[2], g[2]
  zero_smem(smem, COLS_TILES * L::BYTES);
  auto tile = [&](int i) { return tiles + i * TILE * L::LD; };
  const int nq = cdiv(Tn, TILE);
  const int kt = blockIdx.x % nq, bh_ = blockIdx.x / nq, b = bh_ / H, h = bh_ - b * H;
  const int D = H * dh;
  const long long s3 = 3LL * D;
  const T* base = qkv + (long long)b * Tn * s3 + h * dh;
  const T* gb = g + (long long)b * Tn * D + h * dh;
  auto load = [&](int i) {
    if (i == 0) {
      load_tile<T, DHP>(tile(0), base + D, s3, kt * TILE, Tn, dh, gran);
      load_tile<T, DHP>(tile(1), base + 2 * D, s3, kt * TILE, Tn, dh, gran);
    }
    load_tile<T, DHP>(tile(2 + (i & 1)), base, s3, i * TILE, Tn, dh, gran);
    load_tile<T, DHP>(tile(4 + (i & 1)), gb, D, i * TILE, Tn, dh, gran);
  };

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = kt * TILE + 16 * (threadIdx.x >> 5) + (lane >> 2);  // key rows
  const float* bh = bias + (long long)h * Tn * Tn;
  const float* lse = lse_in + ((long long)b * H + h) * Tn;
  const float* delta = delta_in + ((long long)b * H + h) * Tn;
  float s[8][4], dp[8][4], dk[DHP / 8][4], dv[DHP / 8][4], tmp[DHP / 8][4];
  zero(dk);
  zero(dv);
  load(0);
  cp_commit();
  for (int i = 0; i < nq; ++i) {
    if (i + 1 < nq) load(i + 1);
    cp_commit();
    load_bias<true>(dp, bh, r0, i * TILE, Tn);  // the bias, in dp until v g^T
    cp_wait_one();
    __syncthreads();
    const T* sq = tile(2 + (i & 1));
    const T* sg = tile(4 + (i & 1));
    abT<DHP>(s, tile(0), sq);  // s^T: keys x queries
    logits(s, dp, i * TILE, Tn, scale);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // p^T (0 in columns past T: s = -inf there)
        const int col = i * TILE + 8 * j + 2 * t + (e & 1);
        s[j][e] = exp2f(s[j][e] - (col < Tn ? __ldg(lse + col) : 0.0f));
      }
    accumulate<DHP>(dv, tmp, s, sg);
    abT<DHP>(dp, tile(1), sg);  // dp^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * TILE + 8 * j + 2 * t + (e & 1);
        dp[j][e] = s[j][e] * (dp[j][e] - (col < Tn ? __ldg(delta + col) : 0.0f));
      }
    accumulate<DHP>(dk, tmp, dp, sq);
    __syncthreads();
  }
  const bool pairs = gran >= 2 * (int)sizeof(T);
  T* db = dqkv + (long long)b * Tn * s3 + h * dh;
  const float mk[2] = {scale, scale}, mv[2] = {1.0f, 1.0f};
  store_rows<T, DHP>(db + D, s3, dk, r0, Tn, dh, mk, pairs);
  store_rows<T, DHP>(db + 2 * D, s3, dv, r0, Tn, dh, mv, pairs);
}

// K7b, launch 3 of 3: dbias[i] = sum over the chunks, in order, of
// dpart[c, i]; i over H * T * T
__global__ void dbias_reduce_kernel(const float* __restrict__ dpart, float* __restrict__ dbias,
                                    int chunks, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int c = 0; c < chunks; ++c) acc += dpart[c * n + i];
    dbias[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the tile width of head width dh: 16, 32, 48, 64, then 96 and 128
int head_pad(int dh) { return dh <= 64 ? cdiv(dh, 16) * 16 : dh <= 96 ? 96 : 128; }

// bytes of shared memory a block of the forward (backward = 0) or of the
// larger backward launch (1) asks for; -1 for a head width not taken
long long shared_bytes(int dh, int is_bf16, int backward) {
  if (dh < 0 || dh > MAX_DH) return -1;
  const long long esz = is_bf16 ? 2 : 4, ld = head_pad(dh) + (is_bf16 ? 8 : 4);
  const int rows = is_bf16 ? ROWS_TILES<bf16> : ROWS_TILES<float>;
  return (backward ? std::max(rows, COLS_TILES) : FWD_TILES) * TILE * ld * esz;
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
// (one per kernel) remembers the allowance set, so that later launches make
// no runtime call.
template <typename K>
int allow_shared(K kernel, int bytes, int& granted) {
  if (bytes <= granted) return 0;
  if (bytes > shared_limit()) return (int)cudaErrorInvalidValue;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) granted = bytes;
  return err;
}

// The bytes of one copy into shared memory: the largest of 16, 8 and 4 that
// divides a head's row of dh elements and both base addresses (every row and
// head offset is a multiple of dh elements), else the element size.
int granule(const void* a, const void* b, int dh, int esz) {
  for (int gsz = 16; gsz >= 4; gsz /= 2)
    if ((dh * esz) % gsz == 0 && (uintptr_t)a % gsz == 0 && (uintptr_t)b % gsz == 0) return gsz;
  return esz;
}

// Batch rows per chunk of the rows launch, and the number of chunks: as many
// chunks as keep chunks * H * nq within ROWS_BLOCKS (one wave), at least one,
// at most B, and no more than PART_FLOATS of partials hold.  A function of the shapes only, so the
// dbias sums always take the same order.
void batch_chunks(int B, int Tn, int H, int& chunk, int& chunks) {
  const int tiles = H * cdiv(Tn, TILE);
  const long long fit = std::max(1LL, PART_FLOATS / ((long long)H * Tn * Tn));
  const int want = (int)std::min<long long>(std::min(B, std::max(1, ROWS_BLOCKS / tiles)), fit);
  chunk = cdiv(B, want);
  chunks = cdiv(B, chunk);
}

// float32 elements of the backward's scratch; ops/attention.py computes the
// same, and attention_backward refuses a smaller scratch
long long scratch_floats(int B, int Tn, int H) {
  int chunk, chunks;
  batch_chunks(B, Tn, H, chunk, chunks);
  return 2LL * B * H * Tn + (chunks > 1 ? (long long)chunks * H * Tn * Tn : 0);
}

template <typename T, int DHP>
int forward(const void* qkv, const float* bias, void* out, int B, int Tn, int H, int dh,
            float scale, cudaStream_t stream) {
  static int granted = 0;
  constexpr int bytes = FWD_TILES * Tile<T, DHP>::BYTES;
  const int err = allow_shared(attn_fwd_kernel<T, DHP>, bytes, granted);
  if (err) return err;
  const int gran = granule(qkv, qkv, dh, sizeof(T));
  attn_fwd_kernel<T, DHP><<<B * H * cdiv(Tn, TILE), THREADS, bytes, stream>>>(
      (const T*)qkv, bias, (T*)out, Tn, H, dh, scale, gran);
  return (int)cudaGetLastError();
}

template <typename T, int DHP>
int backward(const void* qkv, const float* bias, const void* g, void* dqkv, float* scratch,
             float* dbias, int B, int Tn, int H, int dh, float scale, cudaStream_t stream) {
  static int granted_rows = 0, granted_cols = 0;
  constexpr int rows_bytes = ROWS_TILES<T> * Tile<T, DHP>::BYTES;
  constexpr int cols_bytes = COLS_TILES * Tile<T, DHP>::BYTES;
  int err = allow_shared(attn_bwd_rows_kernel<T, DHP>, rows_bytes, granted_rows);
  if (!err) err = allow_shared(attn_bwd_cols_kernel<T, DHP>, cols_bytes, granted_cols);
  if (err) return err;
  const int gran = granule(qkv, g, dh, sizeof(T)), nq = cdiv(Tn, TILE);
  int chunk, chunks;
  batch_chunks(B, Tn, H, chunk, chunks);
  float* lse = scratch;
  float* delta = lse + (long long)B * H * Tn;
  float* part = chunks > 1 ? delta + (long long)B * H * Tn : dbias;
  attn_bwd_rows_kernel<T, DHP><<<chunks * H * nq, THREADS, rows_bytes, stream>>>(
      (const T*)qkv, bias, (const T*)g, (T*)dqkv, lse, delta, part, B, Tn, H, dh, scale, chunk,
      gran);
  if ((err = (int)cudaGetLastError())) return err;
  attn_bwd_cols_kernel<T, DHP><<<B * H * nq, THREADS, cols_bytes, stream>>>(
      (const T*)qkv, bias, (const T*)g, (T*)dqkv, lse, delta, Tn, H, dh, scale, gran);
  if ((err = (int)cudaGetLastError()) || chunks == 1) return err;
  const long long n = (long long)H * Tn * Tn;
  const int blocks = (int)std::min((n + 255) / 256, 4096LL);
  dbias_reduce_kernel<<<blocks, 256, 0, stream>>>(part, dbias, chunks, n);
  return (int)cudaGetLastError();
}

template <typename T>
int forward_any(const void* qkv, const float* bias, void* out, int B, int Tn, int H, int dh,
                float scale, cudaStream_t stream) {
  switch (head_pad(dh)) {
    case 16: return forward<T, 16>(qkv, bias, out, B, Tn, H, dh, scale, stream);
    case 32: return forward<T, 32>(qkv, bias, out, B, Tn, H, dh, scale, stream);
    case 48: return forward<T, 48>(qkv, bias, out, B, Tn, H, dh, scale, stream);
    case 64: return forward<T, 64>(qkv, bias, out, B, Tn, H, dh, scale, stream);
    case 96: return forward<T, 96>(qkv, bias, out, B, Tn, H, dh, scale, stream);
    case 128: return forward<T, 128>(qkv, bias, out, B, Tn, H, dh, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int backward_any(const void* qkv, const float* bias, const void* g, void* dqkv, float* scratch,
                 float* dbias, int B, int Tn, int H, int dh, float scale, cudaStream_t stream) {
  switch (head_pad(dh)) {
    case 16: return backward<T, 16>(qkv, bias, g, dqkv, scratch, dbias, B, Tn, H, dh, scale, stream);
    case 32: return backward<T, 32>(qkv, bias, g, dqkv, scratch, dbias, B, Tn, H, dh, scale, stream);
    case 48: return backward<T, 48>(qkv, bias, g, dqkv, scratch, dbias, B, Tn, H, dh, scale, stream);
    case 64: return backward<T, 64>(qkv, bias, g, dqkv, scratch, dbias, B, Tn, H, dh, scale, stream);
    case 96: return backward<T, 96>(qkv, bias, g, dqkv, scratch, dbias, B, Tn, H, dh, scale, stream);
    case 128: return backward<T, 128>(qkv, bias, g, dqkv, scratch, dbias, B, Tn, H, dh, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shared memory per block, in bytes, that the forward (backward = 0) or the
// backward (1) asks for at head width dh, whatever T; -1 where the kernels do
// not take dh (above 128).
int attention_shared_bytes(int dh, int is_bf16, int backward) {
  return (int)shared_bytes(dh, is_bf16, backward);
}

// The most shared memory a block may ask for on the current device.
int attention_shared_limit() { return shared_limit(); }

// K7f: qkv [B, T, 3*H*dh], bias [H, T, T] f32 -> out [B, T, H*dh]; qkv and
// out float32 (is_bf16 = 0) or bfloat16 (1).
int attention_forward(const void* qkv, const float* bias, void* out, int B, int T, int H, int dh,
                      float scale, int is_bf16, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0 || dh == 0) return 0;
  if (shared_bytes(dh, is_bf16, 0) < 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? forward_any<bf16>(qkv, bias, out, B, T, H, dh, scale, stream)
                 : forward_any<float>(qkv, bias, out, B, T, H, dh, scale, stream);
}

// K7b: + g [B, T, H*dh] -> dqkv [B, T, 3*H*dh], dbias [H, T, T] f32, through
// `scratch` of scratch_n float32 elements (at least scratch_floats(B, T, H)).
int attention_backward(const void* qkv, const float* bias, const void* g, void* dqkv,
                       float* scratch, long long scratch_n, float* dbias, int B, int T, int H,
                       int dh, float scale, int is_bf16, cudaStream_t stream) {
  if (B == 0 || T == 0 || H == 0 || dh == 0) return 0;
  if (shared_bytes(dh, is_bf16, 1) < 0 || scratch_n < scratch_floats(B, T, H))
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? backward_any<bf16>(qkv, bias, g, dqkv, scratch, dbias, B, T, H, dh, scale,
                                      stream)
                 : backward_any<float>(qkv, bias, g, dqkv, scratch, dbias, B, T, H, dh, scale,
                                       stream);
}

}  // extern "C"
