// Numerator steady-frame recursions of LF-MMI: kernels K3 (forward) and K4
// (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/num_resident.py:
//   K3  num_steady_forward  -> _fwd_kernel (steady_forward,  pallas_call :158)
//   K4  num_steady_backward -> _bwd_kernel (steady_backward, pallas_call :207)
//
// Math (log semiring; arc slot (s, k) of frame t enters state s from state
// src[s, k] with weight logw[s, k] and emits vocabulary slot lpdf[s, k];
// src < 0 marks a pad slot):
//   K3, frame t = 0 .. T-2 of the steady tables (frames 1 .. T-1 of the
//   chunk):
//       next[s] = lse_k(alpha[src[s, k]] + logw[s, k] + ysm[t, lpdf[s, k]])
//   K4, the same frames in reverse, beta starting at the final weights:
//       arc_w[s, k] = logw[s, k] + ysm[t, lpdf[s, k]] + beta[s]
//       post[s, k]  = exp(alpha_t[src[s, k]] + arc_w[s, k] - logp)
//       gsm[t, w]   = sum of post over the arcs with lpdf == w
//       beta'[s']   = lse of arc_w over the arcs with src == s'
//   with logp = +inf for a sequence whose log-probability is not finite, so
//   that its occupancies are exactly 0.  A log-sum-exp over no arcs (or over
//   arcs that are all -inf) is -inf, never NaN: the maximum is tested before
//   anything is subtracted from it.  No fast-math: the recursion relies on
//   expf(-inf) == 0 and on exact -inf arithmetic.
//
// K3 and K4 walk only the live arcs.  97% of the dense slots are pads at
// the trigram shapes (40,875 live of 1,505,280: about 6.5 a frame of a
// sequence), so the wrapper lists each sequence's live arcs once, when a
// batch is placed (ops/num_resident.py kernel_tables): frame by frame, in
// slot order, one 16-byte record each (src, dst = slot / Kr, lpdf, logw),
// with per-frame offsets, and for K3 also per-frame destination offsets
// [T-1, S+1] (slot order is destination order, so each destination's
// in-arcs are one run of its frame).  What bounds either kernel on the H100
// is neither bytes (the list of a batch is 654 KB at trigram) nor
// operations but the latency of 49 dependent frames.  The TPU kernels keep
// the batch on the lanes ([Kr, S, B] tiles) and select alpha[src] and
// ysm[lpdf] with S- and W-long loops of comparison masks, because they
// cannot gather; here sequences are independent, one thread block owns one
// sequence and loops over all frames inside one launch.
//
// K3.  One thread per destination state walks its run: the maximum of v =
// alpha[src] + (logw + ysm[lpdf]), then the sum of expf(v - m) in list
// order.  The first KEEP = 2 values of a run stay in registers between the
// two passes, their loads sent together; a longer run's rest is read in a
// loop (most frames' longest run is 2 arcs at both shipped shapes).  The
// block copies, by cp.async before the first frame, its sequence's whole
// list, destination offsets and ysm rows into shared memory (the staged
// plan: 14,528 bytes at trigram, L 444, S 20, W 16), and alpha is
// double-buffered there, so a frame has no global load on its chain and
// one barrier; the alpha rows go out to device memory off the chain.
// Where the list does not fit (the plan is chosen from sizes alone,
// steady_fwd_shared_bytes) it is read from device memory instead.  A block
// is 32 * ceil(S / 32) threads: at S <= 32 (trigram S 20, production 12)
// one warp owns a sequence and a frame ends at __syncwarp, not at a block
// barrier.  One sequence a block, not several: the 128 sequences of a batch
// then spread over 128 of the H100's 132 SMs, each a chain of its own.
// The dense design's pads only ever added +0.0 to a sum or left the maximum
// as it was, and the runs keep slot order: K3 gives the dense design's
// bits.
//
// K4.  One block per sequence (a warp or more for the source states, then
// one or more for the vocabulary slots) copies, by cp.async before the
// first frame, everything the frame loop reads into shared memory: the
// offsets, its whole list, its ysm rows and its alpha
// rows (the staged plan).  Where the list does not fit, each frame's
// records, ysm row and alpha row are copied instead one frame ahead into
// one of two buffers (the streamed plan, sized by S * Kr, the most live
// arcs a frame can have).  The plan is chosen from sizes alone
// (steady_shared_bytes).  Per frame, in reverse: one thread per live arc
// computes arc_w and post into shared memory; a barrier; one thread per
// source state scans the frame's records for its arcs (the maximum, noting
// which arcs are its own, then the sum of exp over those) while one thread
// per vocabulary slot, in other warps, sums the posteriors of its arcs; a
// barrier.  No global load is on the frame's dependency chain.  Shared
// memory per block (staged, L the longest list of the batch): 16 L + 4 (T
// + (T - 1) (W + S) + S + 2 S Kr) bytes, each array rounded to 16: 16,368
// at trigram (L 444, S 20, Kr 12, W 16) and 12,128 at production (L 375, S
// 12, Kr 4).  What bounds K4 is the latency of 49 dependent frames (two
// barriers and scans of the frame's records, about 1 microsecond a frame on
// an H100), not bytes.
//
// Both reductions use no atomics and repeat bit for bit.  The records keep
// slot order, the scans keep it, and the dense design's pads only ever
// added +0.0 or were skipped, so the sums run in the order of the dense
// design: the same bits.

#include <limits.h>

#include "den_common.cuh"

namespace {

// K3's shared memory.  Staged: the records [L], the destination offsets
// [T-1][S+1] and the ysm rows [T-1][W]; then (both plans) alpha [2][S].
struct K3Layout {
  long long rec, off, ysm, alpha, bytes;
};

__host__ __device__ inline K3Layout k3_layout(bool staged, int L, int Tm1, int S, int W) {
  K3Layout l{};
  long long o = 0;
  if (staged) {
    l.rec = o;
    o = up16(o + 16LL * L);
    l.off = o;
    o = up16(o + 4LL * Tm1 * (S + 1));
    l.ysm = o;
    o = up16(o + 4LL * Tm1 * W);
  }
  l.alpha = o;
  l.bytes = up16(o + 8LL * S);
  return l;
}

// the end of a frame: the block's threads are one warp where S <= 32
__device__ __forceinline__ void frame_sync(int nt) {
  if (nt <= 32)
    __syncwarp();
  else
    __syncthreads();
}

// values of a run K3 keeps in registers between its two passes, read
// together whatever the run's length: a warp runs every lane through them,
// so they are sized to the common run (most frames' longest run is 2 arcs
// at the trigram and production batches; the few longer ones, up to 10,
// read the rest in a loop)
constexpr int KEEP = 2;

// K3.  One block per sequence b, one thread per destination state.  arcs
// [B, L] records (src, dst, lpdf, logw bits) of the live arcs, frame by
// frame in slot order; dst_off [B, T-1, S+1]: where each destination's run
// of frame t starts in the sequence's list, and (column S) one past the
// frame's last.  ysm rows at b * ys_b + t * ys_t, W wide; alpha1 [B, S];
// out [T-1, B, S].
template <bool STAGED>
__global__ void steady_fwd_kernel(const int4* __restrict__ arcs, const int* __restrict__ dst_off,
                                  int L, const float* __restrict__ ysm, long long ys_b,
                                  long long ys_t, const float* __restrict__ alpha1,
                                  float* __restrict__ out, int B, int Tm1, int S, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const K3Layout lay = k3_layout(STAGED, L, Tm1, S, W);
  int4* rec_sh = reinterpret_cast<int4*>(smem + lay.rec);
  int* off_sh = reinterpret_cast<int*>(smem + lay.off);
  float* ysm_sh = reinterpret_cast<float*>(smem + lay.ysm);
  float* alpha_sh = reinterpret_cast<float*>(smem + lay.alpha);  // [2][S]
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int4* arcs_b = arcs + (size_t)b * L;
  const int* off_b = dst_off + (size_t)b * Tm1 * (S + 1);
  const float* ys_seq = ysm + (size_t)b * ys_b;
  if (STAGED) {
    for (int j = tid; j < L; j += nt) cp_async16(rec_sh + j, arcs_b + j);
    for (int i = tid; i < Tm1 * (S + 1); i += nt) cp_async4(off_sh + i, off_b + i);
    for (int i = tid; i < Tm1 * W; i += nt) {
      const int t = i / W;
      cp_async4(ysm_sh + i, ys_seq + (size_t)t * ys_t + (i - t * W));
    }
    commit_async();
  }
  for (int s = tid; s < S; s += nt) alpha_sh[s] = alpha1[(size_t)b * S + s];
  if (STAGED) wait_async();
  __syncthreads();  // the list, the offsets, the ysm rows and alpha1 are in place
  const int4* rec = STAGED ? rec_sh : arcs_b;
  for (int t = 0; t < Tm1; ++t) {
    const float* cur = alpha_sh + (t & 1) * S;
    float* nxt = alpha_sh + ((t + 1) & 1) * S;
    const int* of = (STAGED ? off_sh : off_b) + (size_t)t * (S + 1);
    const float* ys = STAGED ? ysm_sh + (size_t)t * W : ys_seq + (size_t)t * ys_t;
    auto value = [&](int j) {
      const int4 r = rec[j];
      return cur[r.x] + (__int_as_float(r.w) + ys[r.z]);
    };
    for (int s = tid; s < S; s += nt) {
      // the first KEEP records are read whatever the run's length (past its
      // end, its last record again: an index inside the list even for an
      // empty run), so that their loads go out together, not one a branch
      const int j0 = of[s], j1 = of[s + 1], jl = max(j1 - 1, 0);
      float v[KEEP];
#pragma unroll
      for (int k = 0; k < KEEP; ++k) {
        const float x = value(min(j0 + k, jl));
        v[k] = j0 + k < j1 ? x : -INFINITY;
      }
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < KEEP; ++k) m = fmaxf(m, v[k]);
      for (int j = j0 + KEEP; j < j1; ++j) m = fmaxf(m, value(j));
      float r = -INFINITY;
      if (m > -INFINITY) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < KEEP; ++k)
          if (j0 + k < j1) sum += expf(v[k] - m);
        for (int j = j0 + KEEP; j < j1; ++j) sum += expf(value(j) - m);
        r = m + logf(sum);
      }
      nxt[s] = r;
      out[((size_t)t * B + b) * S + s] = r;
    }
    frame_sync(nt);  // nxt is complete, and every thread has left cur
  }
}

// K4's shared memory: the offsets [T], the records (staged: the whole list
// [L]; streamed: two frames' [2][A]), the ysm rows ([T-1][W] or [2][W]), the
// alpha rows ([T-1][S] or [2][S]), beta [S], arc_w and post [A] each.
struct K4Layout {
  long long off, rec, ysm, alpha, beta, aw, po, bytes;
};

__host__ __device__ inline K4Layout k4_layout(bool staged, int L, int Tm1, int S, int A, int W) {
  K4Layout l;
  const long long rows = staged ? Tm1 : 2;
  long long o = 0;
  l.rec = o;
  o = up16(o + 16LL * (staged ? L : 2LL * A));
  l.off = o;
  o = up16(o + 4LL * (Tm1 + 1));
  l.ysm = o;
  o = up16(o + 4LL * rows * W);
  l.alpha = o;
  o = up16(o + 4LL * rows * S);
  l.beta = o;
  o = up16(o + 4LL * S);
  l.aw = o;
  o = up16(o + 4LL * A);
  l.po = o;
  l.bytes = up16(o + 4LL * A);
  return l;
}

// K4.  One block per sequence b.  arcs [B, L] records (src, dst, lpdf, logw
// bits) of the live arcs, frame by frame in slot order; arc_off [B, T]:
// where frame t's records start in the sequence's list, and one past the
// last.  ysm rows at b * ys_b + t * ys_t, W wide; alphas [Tm1, B, S] are the
// alphas of each frame's SOURCE states; final [B, S]; logp [B]; gsm out
// [Tm1, B, W]; beta1 out [B, S]: the beta after the earliest frame's step.
template <bool STAGED>
__global__ void steady_bwd_kernel(const int4* __restrict__ arcs, const int* __restrict__ arc_off,
                                  int L, const float* __restrict__ ysm, long long ys_b,
                                  long long ys_t, const float* __restrict__ alphas,
                                  const float* __restrict__ final_logw,
                                  const float* __restrict__ logp_in, float* __restrict__ gsm,
                                  float* __restrict__ beta1, int B, int Tm1, int S, int A,
                                  int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const K4Layout lay = k4_layout(STAGED, L, Tm1, S, A, W);
  int4* rec_sh = reinterpret_cast<int4*>(smem + lay.rec);
  int* off_sh = reinterpret_cast<int*>(smem + lay.off);
  float* ysm_sh = reinterpret_cast<float*>(smem + lay.ysm);
  float* alpha_sh = reinterpret_cast<float*>(smem + lay.alpha);
  float* beta_sh = reinterpret_cast<float*>(smem + lay.beta);
  float* aw_sh = reinterpret_cast<float*>(smem + lay.aw);
  float* po_sh = reinterpret_cast<float*>(smem + lay.po);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int4* arcs_b = arcs + (size_t)b * L;
  const int* off_b = arc_off + (size_t)b * (Tm1 + 1);
  const float* ys_seq = ysm + (size_t)b * ys_b;
  const float lp = logp_in[b];
  const float logp = isfinite(lp) ? lp : INFINITY;

  // frame t's records, ysm row and alpha row into buffer t & 1 (streamed)
  auto stage_frame = [&](int t) {
    const int j0 = off_sh[t], n = off_sh[t + 1] - j0;
    int4* rd = rec_sh + (t & 1) * A;
    for (int j = tid; j < n; j += nt) cp_async16(rd + j, arcs_b + j0 + j);
    const float* yrow = ys_seq + (size_t)t * ys_t;
    for (int w = tid; w < W; w += nt) cp_async4(ysm_sh + (t & 1) * W + w, yrow + w);
    const float* arow = alphas + ((size_t)t * B + b) * S;
    for (int s = tid; s < S; s += nt) cp_async4(alpha_sh + (t & 1) * S + s, arow + s);
    commit_async();
  };

  for (int t = tid; t <= Tm1; t += nt) cp_async4(off_sh + t, off_b + t);
  if (STAGED) {
    for (int j = tid; j < L; j += nt) cp_async16(rec_sh + j, arcs_b + j);
    for (int i = tid; i < Tm1 * W; i += nt) {
      const int t = i / W;
      cp_async4(ysm_sh + i, ys_seq + (size_t)t * ys_t + (i - t * W));
    }
    for (int i = tid; i < Tm1 * S; i += nt) {
      const int t = i / S;
      cp_async4(alpha_sh + i, alphas + ((size_t)t * B + b) * S + (i - t * S));
    }
  }
  commit_async();
  for (int s = tid; s < S; s += nt) beta_sh[s] = final_logw[(size_t)b * S + s];
  if (!STAGED) {
    wait_async();
    __syncthreads();  // the offsets are in place
    stage_frame(Tm1 - 1);
  }
  for (int t = Tm1 - 1; t >= 0; --t) {
    wait_async();
    __syncthreads();  // frame t's records, ysm and alpha rows and beta are in place
    if (!STAGED && t > 0) stage_frame(t - 1);  // into the buffer frame t + 1 has left
    const int j0 = off_sh[t], n = off_sh[t + 1] - j0;
    const int4* rf = STAGED ? rec_sh + j0 : rec_sh + (t & 1) * A;
    const float* ys = STAGED ? ysm_sh + (size_t)t * W : ysm_sh + (t & 1) * W;
    const float* al = STAGED ? alpha_sh + (size_t)t * S : alpha_sh + (t & 1) * S;
    for (int j = tid; j < n; j += nt) {
      const int4 r = rf[j];
      const float aw = (__int_as_float(r.w) + ys[r.z]) + beta_sh[r.y];
      aw_sh[j] = aw;
      // alpha or aw may be -inf and logp +inf: the sum is then -inf (never
      // inf - inf), and expf(-inf) is exactly 0
      po_sh[j] = expf(al[r.x] + aw - logp);
    }
    __syncthreads();  // every arc has read beta_sh; arc_w and post are complete
    // the lowest threads take the source states, the highest the vocabulary
    // slots, so that the two scans run in different warps
    for (int sp = tid; sp < S; sp += nt) {
      // the first pass notes its arcs among the frame's first 64, and the
      // second walks those bits in ascending order: the same order
      float m = -INFINITY;
      unsigned long long hit = 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j)
        if (rf[j].x == sp) {
          m = fmaxf(m, aw_sh[j]);
          hit |= j < 64 ? 1ull << j : 0ull;
        }
      float r = -INFINITY;
      if (m > -INFINITY) {
        float sum = 0.0f;
        for (; hit; hit &= hit - 1) sum += expf(aw_sh[__ffsll(hit) - 1] - m);
        for (int j = 64; j < n; ++j)
          if (rf[j].x == sp) sum += expf(aw_sh[j] - m);
        r = m + logf(sum);
      }
      beta_sh[sp] = r;
    }
    for (int w = nt - 1 - tid; w < W; w += nt) {
      float acc = 0.0f;
#pragma unroll 4
      for (int j = 0; j < n; ++j)
        if (rf[j].z == w) acc += po_sh[j];
      gsm[((size_t)t * B + b) * W + w] = acc;
    }
  }
  __syncthreads();
  for (int s = tid; s < S; s += nt) beta1[(size_t)b * S + s] = beta_sh[s];
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of dynamic shared memory a K3 block asks for: with the sequence's
// list, destination offsets and ysm rows staged (staged = 1) or alpha
// alone (0).
int steady_fwd_shared_bytes(int staged, int L, int Tm1, int S, int W) {
  const long long bytes = k3_layout(staged != 0, L, Tm1, S, W).bytes;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// K3: alphas of frames 1 .. T-1, on `stream`; `staged` as
// steady_fwd_shared_bytes; `threads` a multiple of 32.
int num_steady_forward(const int4* arcs, const int* dst_off, int L, const float* ysm,
                       long long ys_b, long long ys_t, const float* alpha1, float* out, int B,
                       int Tm1, int S, int W, int staged, int threads, cudaStream_t stream) {
  if (B == 0 || Tm1 == 0) return 0;
  static int granted[2] = {0, 0};
  const long long bytes = k3_layout(staged != 0, L, Tm1, S, W).bytes;
  int err;
  if (staged) {
    if ((err = allow_shared(steady_fwd_kernel<true>, bytes, granted[1]))) return err;
    steady_fwd_kernel<true><<<B, threads, bytes, stream>>>(arcs, dst_off, L, ysm, ys_b, ys_t,
                                                           alpha1, out, B, Tm1, S, W);
  } else {
    if ((err = allow_shared(steady_fwd_kernel<false>, bytes, granted[0]))) return err;
    steady_fwd_kernel<false><<<B, threads, bytes, stream>>>(arcs, dst_off, L, ysm, ys_b, ys_t,
                                                            alpha1, out, B, Tm1, S, W);
  }
  return (int)cudaGetLastError();
}

// The most dynamic shared memory a block may ask for on the current
// device (opt-in limit), in bytes.
int num_shared_limit() { return shared_limit(); }

// Bytes of dynamic shared memory a K4 block asks for: with the sequence's
// whole list staged (staged = 1) or two frames' records streamed (0).
int steady_shared_bytes(int staged, int L, int Tm1, int S, int A, int W) {
  const long long bytes = k4_layout(staged != 0, L, Tm1, S, A, W).bytes;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// K4: vocabulary-space occupancies of frames 1 .. T-1 and beta1, on
// `stream`; `staged` as steady_shared_bytes.
int num_steady_backward(const int4* arcs, const int* arc_off, int L, const float* ysm,
                        long long ys_b, long long ys_t, const float* alphas,
                        const float* final_logw, const float* logp, float* gsm, float* beta1,
                        int B, int Tm1, int S, int A, int W, int staged, int threads,
                        cudaStream_t stream) {
  if (B == 0 || Tm1 == 0) return 0;
  static int granted[2] = {0, 0};
  const long long bytes = k4_layout(staged != 0, L, Tm1, S, A, W).bytes;
  int err;
  if (staged) {
    if ((err = allow_shared(steady_bwd_kernel<true>, bytes, granted[1]))) return err;
    steady_bwd_kernel<true><<<B, threads, bytes, stream>>>(arcs, arc_off, L, ysm, ys_b, ys_t,
                                                           alphas, final_logw, logp, gsm,
                                                           beta1, B, Tm1, S, A, W);
  } else {
    if ((err = allow_shared(steady_bwd_kernel<false>, bytes, granted[0]))) return err;
    steady_bwd_kernel<false><<<B, threads, bytes, stream>>>(arcs, arc_off, L, ysm, ys_b, ys_t,
                                                            alphas, final_logw, logp, gsm,
                                                            beta1, B, Tm1, S, A, W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
