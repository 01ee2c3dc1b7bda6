// Flat-start (e2e) numerator recursions of LF-MMI: kernels K8f (forward)
// and K8b (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/num_resident.py:
//   K8f  e2e_forward  -> _e2e_fwd_kernel (e2e_forward_resident,  pallas_call :319)
//   K8b  e2e_backward -> _e2e_bwd_kernel (e2e_backward_resident, pallas_call :356)
//
// Math (log semiring; one cyclic graph per sequence whose tables do not
// change over time: arc slot (s, k) enters state s from state src[s, k] with
// weight logw[s, k]; src < 0 marks a pad slot; ylocal[t, s, k] is the arc's
// emission log-probability at frame t):
//   K8f, alpha_0 = (0, -inf, ...), frames t = 0 .. T-1:
//       alpha_{t+1}[s] = lse_k(alpha_t[src[s, k]] + logw[s, k] + ylocal[t, s, k])
//   K8b, the frames in reverse, beta_T = final_logw:
//       arc_w[s, k]  = (logw[s, k] + ylocal[t, s, k]) + beta_{t+1}[s]
//       post[t, s, k] = exp(alpha_t[src[s, k]] + arc_w[s, k] - logp)
//       beta_t[s']   = lse of arc_w over the arcs with src == s'
//   with logp = +inf for a sequence whose log-probability is not finite, so
//   that its posteriors are exactly 0.  A log-sum-exp over no arcs (or over
//   arcs that are all -inf) is -inf, never NaN: the maximum is tested before
//   anything is subtracted from it, and pad slots are never added up.  No
//   fast-math: the recursion relies on expf(-inf) == 0 and on exact -inf
//   arithmetic.
//
// K8f walks only the live arcs, and no global load is on a frame's
// dependency chain.  What bounds it on the H100 is the latency of 50
// dependent frames, not bytes (of ylocal only the live slots are needed:
// 6% of 66 MB at B=128, T=50, S=55, K=47).  The TPU kernel keeps the batch
// on the lanes ([K, S, B] tiles) and selects alpha[src] with an S-long loop
// of comparison masks, because it cannot gather.  Here sequences are
// independent, so one thread block owns one sequence and loops over all
// frames inside one launch, with K8b's design turned around: the wrapper
// prepares, once per batch, each sequence's live slots in slot order, which
// is destination order (in_off [S + 1], in_arc; about 159 of 2,585 slots a
// sequence at the trigram shape), and the block turns them, once per
// launch, into 16-byte records in shared memory (slot, source, destination
// = slot / K, logw).  Each frame's live ylocal values run through a ring of
// STAGES buffers filled by two copy warps with cp.async STAGES - 1 frames
// ahead; alpha is double-buffered in shared memory, because the graphs are
// cyclic and a frame's result must not land in the buffer the frame still
// reads.  Per frame, after one barrier, each destination's run is reduced
// (maximum, then sum of exp) into the next alpha.  A run of up to
// HEAVY_RUN arcs (most states of the e2e graphs have 0 or 2 in-arcs) goes
// to one thread, its first LIGHT_KEPT = 2 values kept in registers between
// the two passes: a warp runs every lane through the kept values whatever
// its own run's length, so they are sized to the common run.  A longer one
// (about 6 a sequence at the trigram e2e batch, of 13 to 47 arcs) goes to
// a group of GROUP = 8 lanes of FWD_HEAVY_WARPS = 4 warps, four groups a
// warp: lane g takes arcs g, g + 8, ..., then a butterfly of three
// shuffles over the group, so that a frame waits for its longest run once,
// not for each in turn.  The sixteen groups take a sequence's heavy runs
// (at most 16 at the trigram e2e batch) in one round, and a group keeps
// 8 KEPT = 48 values in registers (the longest run there is 47); a whole
// warp to a run would spend five shuffles a reduction where three serve.
// Shared memory per block (staged plan): 16 L + 4 STAGES
// L + 8 (S + 1) + 8 S bytes, each array rounded to 16: 8,384 bytes at the
// trigram e2e batch (L 234, S 55).  Where the list does not fit (the plan
// is chosen from sizes alone, e2e_forward_shared_bytes) the block reads the
// list, the tables and ylocal from device memory each frame.  The sums
// have one order: two launches give the same bits.
//
// K8b walks only the live arcs, and no global load is on a frame's
// dependency chain.  The wrapper prepares, once per batch, each sequence's
// live slots in source order (by_off [S + 1], by_arc; about 159 of 2,585
// slots a sequence at the trigram shape).  One block per sequence turns
// them, once per launch, into 16-byte records in shared memory (slot,
// source, destination = slot / K, logw), with the offsets.  The frames'
// inputs run through a ring of STAGES buffers filled by cp.async STAGES - 1
// frames ahead: each frame's live ylocal values (a gather of L floats from
// the frame's 10 KB row) and its alpha row, so the latency of device memory
// stays off the chain (one frame ahead would leave it there: a frame takes
// less time than a load from device memory).  Per frame, after one barrier,
// each source state's run of the list is walked: arc_w of each arc, its
// posterior stored at its slot, and the run reduced (maximum, then sum of
// exp) into the next beta, double-buffered as in K8f.  A run of up to
// HEAVY_RUN arcs (most states of the e2e graphs have 2) goes to one thread,
// in list order; a longer one (one state of each graph has 36-128
// out-arcs, and its run is the frame's critical path) to a whole warp: lane
// g takes arcs g, g + 32, ..., then a butterfly.  Threads are few (192 at
// S = 55): a group of 16 lanes for every state ran slower on an H100 at
// the trigram e2e batch, the SM's issue slots spent on the butterflies of
// two-arc runs.  Two more warps
// keep the ring filled and write post in full: the next frame's row as
// zeros with 16-byte streaming stores (66 MB at the
// trigram shape, 20 microseconds at 3.35 TB/s, spread over the frames),
// and the barrier orders them before that frame's live stores.  Shared
// memory per block (staged plan): 16 L + 4 STAGES (L + S) + 8 (S + 1) + 8 S
// bytes, each array rounded to 16 (L the longest list of the batch): 9,264
// bytes at the trigram e2e batch (L 234, S 55), 4,464 at the production
// one (L 92, S 47).  What bounds it is the latency of 50 dependent frames; the
// post write is the byte bound.  Where the list does not fit (the plan is
// chosen from sizes alone, e2e_backward_shared_bytes), the block keeps only
// beta in shared memory and reads the list, the tables, ylocal and alpha
// from device memory each frame.  Either way the sums have one order: two
// launches give the same bits.

#include <limits.h>

#include "den_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// the warp's maximum by fmaxf (a NaN lane is passed over)
__device__ __forceinline__ float warp_fmax(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// m + log(sum of exp(v_i - m)) from the warp's maximum m and each lane's
// sum of exp(v_i - m); -inf when there was nothing to add
__device__ __forceinline__ float warp_lse(float m, float lane_sum) {
  const float total = warp_sum(lane_sum);
  return m > -INFINITY ? m + logf(total) : -INFINITY;
}

// frames whose inputs K8f's and K8b's rings hold: filled STAGES - 1 frames
// ahead
constexpr int STAGES = 4;

// a run of the list (K8f: a destination's in-arcs; K8b: a source's
// out-arcs) longer than this is reduced by a whole warp (a heavy state), a
// shorter run by one thread
constexpr int HEAVY_RUN = 4;
// K8b's warps besides one thread per source state: for the heavy states,
// and for the copies (K8f: the ring; K8b: the ring, the zeros of post)
constexpr int HEAVY_WARPS = 2;
constexpr int COPY_WARPS = 2;



// K8b's shared memory.  Staged: the records [L] (int4), the ring of ylocal
// values [STAGES][L] and alpha rows [STAGES][S], the offsets [S + 1]; then
// (both plans) the heavy states [S + 1] (their count first) and beta [2][S].
struct K8Layout {
  long long rec, yv, alpha, off, heavy, beta, bytes;
};

__host__ __device__ inline K8Layout k8_layout(bool staged, int L, int S) {
  K8Layout l{};
  long long o = 0;
  if (staged) {
    l.rec = o;
    o = up16(o + 16LL * L);
    l.yv = o;
    o = up16(o + 4LL * STAGES * L);
    l.alpha = o;
    o = up16(o + 4LL * STAGES * S);
    l.off = o;
    o = up16(o + 4LL * (S + 1));
  }
  l.heavy = o;
  o = up16(o + 4LL * (S + 1));
  l.beta = o;
  l.bytes = up16(o + 8LL * S);
  return l;
}

// n floats from p as zeros, by threads tid of nt: 16-byte streaming stores,
// scalar ones for a head up to 16-byte alignment and for the tail
__device__ __forceinline__ void zero_span(float* p, int n, int tid, int nt) {
  const int head = min(n, (int)((16 - ((uintptr_t)p & 15)) & 15) / 4);
  for (int i = tid; i < head; i += nt) __stcs(p + i, 0.0f);
  float4* body = reinterpret_cast<float4*>(p + head);
  const int nv = (n - head) / 4;
  for (int i = tid; i < nv; i += nt) __stcs(body + i, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  for (int i = head + 4 * nv + tid; i < n; i += nt) __stcs(p + i, 0.0f);
}

// K8f's heavy warps, for the destinations whose run is longer than
// HEAVY_RUN; each reduces four runs at a time, GROUP lanes to a run, the
// first KEPT values of a lane in registers (runs of up to 48 arcs): sixteen
// groups, one round for the heavy runs of a sequence of the e2e graphs
constexpr int FWD_HEAVY_WARPS = 4;
constexpr int GROUP = 8;
constexpr int KEPT = 6;
// values of a light run K8f keeps in registers between its two passes (most
// destinations of the e2e graphs have 0 or 2 in-arcs)
constexpr int LIGHT_KEPT = 2;

// the maximum and the sum over the GROUP lanes of a group: lane i takes
// lane i ^ off for off = GROUP / 2 .. 1, so that every lane of the group
// ends with the same bits
__device__ __forceinline__ float group_fmax(float v) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// K8f's shared memory.  Staged: the records [L] (int4) and the ring of
// ylocal values [STAGES][L]; then (both plans) the offsets [S + 1], the
// heavy states [S + 1] (their count first) and alpha [2][S].
struct K8fLayout {
  long long rec, yv, off, heavy, alpha, bytes;
};

__host__ __device__ inline K8fLayout k8f_layout(bool staged, int L, int S) {
  K8fLayout l{};
  long long o = 0;
  if (staged) {
    l.rec = o;
    o = up16(o + 16LL * L);
    l.yv = o;
    o = up16(o + 4LL * STAGES * L);
  }
  l.off = o;
  o = up16(o + 4LL * (S + 1));
  l.heavy = o;
  o = up16(o + 4LL * (S + 1));
  l.alpha = o;
  l.bytes = up16(o + 8LL * S);
  return l;
}

// K8f.  One block per sequence b: threads [0, NL) one per destination state
// (NL = blockDim.x - 32 * (FWD_HEAVY_WARPS + COPY_WARPS), a multiple of 32),
// then the heavy warps, then the copy warps.  ylocal [B, T, S, K]; src, logw
// [B, S, K]; in_off [B, S + 1]; in_arc [B, L]: each sequence's live slots in
// slot order and where each destination's run starts; out [T, B, S].
template <bool STAGED>
__global__ void e2e_fwd_kernel(const float* __restrict__ ylocal, const int* __restrict__ src,
                               const float* __restrict__ logw, const int* __restrict__ in_off,
                               const int* __restrict__ in_arc, float* __restrict__ out, int B,
                               int T, int S, int K, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const K8fLayout lay = k8f_layout(STAGED, L, S);
  int4* rec_sh = reinterpret_cast<int4*>(smem + lay.rec);  // (slot, src, dst, logw bits)
  float* yv_sh = reinterpret_cast<float*>(smem + lay.yv);
  int* off_sh = reinterpret_cast<int*>(smem + lay.off);
  int* heavy_sh = reinterpret_cast<int*>(smem + lay.heavy);  // [0]: count
  float* alpha_sh = reinterpret_cast<float*>(smem + lay.alpha);  // [2][S]
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int NL = nt - 32 * (FWD_HEAVY_WARPS + COPY_WARPS), NC = 32 * COPY_WARPS;
  const int hw = (tid - NL) >> 5, ct = tid - (nt - NC);  // heavy warp; copy thread
  const int A = S * K;
  const int* src_b = src + (size_t)b * A;
  const float* logw_b = logw + (size_t)b * A;
  const int* arc_b = in_arc + (size_t)b * L;
  const float* yl_b = ylocal + (size_t)b * T * A;

  for (int s = tid; s <= S; s += nt) off_sh[s] = in_off[(size_t)b * (S + 1) + s];
  for (int s = tid; s < S; s += nt) alpha_sh[s] = s == 0 ? 0.0f : -INFINITY;
  __syncthreads();  // the offsets are in place
  const int n = off_sh[S];  // the sequence's live arcs
  if (n == 0) {  // no arc: every later alpha is -inf (and the list holds no record to read)
    for (int i = tid; i < T * S; i += nt) out[((size_t)(i / S) * B + b) * S + i % S] = -INFINITY;
    return;
  }
  if (STAGED) {
    for (int j = tid; j < n; j += nt) {
      const int a = arc_b[j];
      rec_sh[j] = make_int4(a, src_b[a], a / K, __float_as_int(logw_b[a]));
    }
  }
  if (tid == 0) {
    int nh = 0;
    for (int s = 0; s < S; ++s)
      if (off_sh[s + 1] - off_sh[s] > HEAVY_RUN) heavy_sh[1 + nh++] = s;
    heavy_sh[0] = nh;
  }
  __syncthreads();  // the records and the heavy states are in place

  // frame t's live ylocal values into ring entry t % STAGES, by the copy warps
  auto stage = [&](int t) {
    if (ct >= 0 && t < T) {
      const float* yl = yl_b + (size_t)t * A;
      float* dst = yv_sh + (t % STAGES) * L;
      for (int j = ct; j < n; j += NC) cp_async4(dst + j, yl + rec_sh[j].x);
    }
    commit_async();  // an empty group past the last frame keeps the count
  };
  if (STAGED)
    for (int t = 0; t < STAGES - 1; ++t) stage(t);
  for (int t = 0; t < T; ++t) {
    const float* cur = alpha_sh + (t & 1) * S;
    float* nxt = alpha_sh + ((t + 1) & 1) * S;
    const float* yv = yv_sh + (t % STAGES) * L;
    const float* yl = yl_b + (size_t)t * A;
    if (STAGED) wait_async_groups<STAGES - 2>();
    // frame t's ring entry (each thread's own copies, then everyone's) and
    // the alpha written last frame are in place, and every thread has left
    // the buffer this frame writes
    __syncthreads();
    // arc j of the list: its value alpha[src] + logw + ylocal
    auto value = [&](int j) {
      if (STAGED) {
        const int4 r = rec_sh[j];
        return (cur[r.y] + __int_as_float(r.w)) + yv[j];
      }
      const int a = arc_b[j];
      return (cur[src_b[a]] + logw_b[a]) + yl[a];
    };
    float* orow = out + ((size_t)t * B + b) * S;
    if (tid < NL) {
      // a light state: its run in list order, by one thread
      for (int s = tid; s < S; s += NL) {
        const int j0 = off_sh[s], j1 = off_sh[s + 1], jl = max(j1 - 1, 0);
        if (j1 - j0 > HEAVY_RUN) continue;
        // LIGHT_KEPT records read whatever the run's length (past its end,
        // its last again: inside the list even for an empty run), so that
        // their loads go out together; the rest of a run in a loop
        float v[LIGHT_KEPT], m = -INFINITY;
#pragma unroll
        for (int k = 0; k < LIGHT_KEPT; ++k) {
          const float x = value(min(j0 + k, jl));
          v[k] = j0 + k < j1 ? x : -INFINITY;
          m = fmaxf(m, v[k]);
        }
        for (int j = j0 + LIGHT_KEPT; j < j1; ++j) m = fmaxf(m, value(j));
        float r = -INFINITY;
        if (m > -INFINITY) {
          float sum = 0.0f;
#pragma unroll
          for (int k = 0; k < LIGHT_KEPT; ++k)
            if (j0 + k < j1) sum += expf(v[k] - m);
          for (int j = j0 + LIGHT_KEPT; j < j1; ++j) sum += expf(value(j) - m);
          r = m + logf(sum);
        }
        nxt[s] = r;
        orow[s] = r;
      }
    } else if (ct < 0) {
      // the heavy states, one to each group of GROUP lanes (four to a warp):
      // lane g of a group takes arcs g, g + GROUP, ... of its run (the first
      // KEPT values in registers), then a butterfly over the group
      const int grp = lane / GROUP, gl = lane % GROUP, nh = heavy_sh[0];
      for (int h0 = hw * (32 / GROUP); h0 < nh; h0 += FWD_HEAVY_WARPS * (32 / GROUP)) {
        const int h = h0 + grp;
        int s = 0, j0 = 0, j1 = 0;  // a group past the last heavy state idles
        if (h < nh) {
          s = heavy_sh[1 + h];
          j0 = off_sh[s];
          j1 = off_sh[s + 1];
        }
        const int jl = max(j1 - 1, 0);
        float kept[KEPT], m = -INFINITY;
#pragma unroll
        for (int k = 0; k < KEPT; ++k) {
          const int j = j0 + gl + GROUP * k;
          const float x = value(min(j, jl));
          kept[k] = j < j1 ? x : -INFINITY;
          m = fmaxf(m, kept[k]);
        }
        for (int j = j0 + gl + GROUP * KEPT; j < j1; j += GROUP) m = fmaxf(m, value(j));
        m = group_fmax(m);
        float sum = 0.0f;
        if (m > -INFINITY) {
#pragma unroll
          for (int k = 0; k < KEPT; ++k)
            if (j0 + gl + GROUP * k < j1) sum += expf(kept[k] - m);
          for (int j = j0 + gl + GROUP * KEPT; j < j1; j += GROUP) sum += expf(value(j) - m);
        }
        sum = group_sum(sum);
        if (h < nh && gl == 0) {
          const float r = m > -INFINITY ? m + logf(sum) : -INFINITY;
          nxt[s] = r;
          orow[s] = r;
        }
      }
    } else if (STAGED) {
      // the copy warps: frame t + STAGES - 1's values into the ring entry
      // frame t - 1 has left
      stage(t + STAGES - 1);
    }
  }
  if (STAGED) wait_async_groups<0>();  // the ring's empty groups, before the block exits
}

// K8b.  One block per sequence b: threads [0, NL) one per source state
// (NL = blockDim.x - 32 * (HEAVY_WARPS + COPY_WARPS), a multiple of 32),
// then the heavy warps, then the copy warps.
// alphas [T, B, S] (frames 0 .. T-1); final_logw [B, S]; logp [B];
// by_off [B, S + 1]; by_arc [B, L]; post out [B, T, S, K].
template <bool STAGED>
__global__ void e2e_bwd_kernel(const float* __restrict__ ylocal, const float* __restrict__ alphas,
                               const int* __restrict__ src, const float* __restrict__ logw,
                               const float* __restrict__ final_logw,
                               const float* __restrict__ logp_in, const int* __restrict__ by_off,
                               const int* __restrict__ by_arc, float* __restrict__ post, int B,
                               int T, int S, int K, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const K8Layout lay = k8_layout(STAGED, L, S);
  int4* rec_sh = reinterpret_cast<int4*>(smem + lay.rec);  // (slot, src, dst, logw bits)
  float* yv_sh = reinterpret_cast<float*>(smem + lay.yv);
  float* alpha_sh = reinterpret_cast<float*>(smem + lay.alpha);
  int* off_sh = reinterpret_cast<int*>(smem + lay.off);
  int* heavy_sh = reinterpret_cast<int*>(smem + lay.heavy);  // [0]: count
  float* beta_sh = reinterpret_cast<float*>(smem + lay.beta);  // [2][S]
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int NL = nt - 32 * (HEAVY_WARPS + COPY_WARPS), NC = 32 * COPY_WARPS;
  const int hw = (tid - NL) >> 5, ct = tid - (nt - NC);  // heavy warp; copy thread
  const int A = S * K;
  const int* src_b = src + (size_t)b * A;
  const float* logw_b = logw + (size_t)b * A;
  const int* off_b = STAGED ? off_sh : by_off + (size_t)b * (S + 1);
  const int* arc_b = by_arc + (size_t)b * L;
  const float* yl_b = ylocal + (size_t)b * T * A;
  float* po_b = post + (size_t)b * T * A;
  const float lp = logp_in[b];
  const float logp = isfinite(lp) ? lp : INFINITY;
  const int n = by_off[(size_t)b * (S + 1) + S];  // the sequence's live arcs

  // frame i (t = T-1-i) of the ring, by the copy warps: its live ylocal
  // values and alpha row
  auto stage = [&](int i) {
    if (ct >= 0 && i < T) {
      const int t = T - 1 - i, buf = i % STAGES;
      const float* yl = yl_b + (size_t)t * A;
      for (int j = ct; j < n; j += NC) cp_async4(yv_sh + buf * L + j, yl + rec_sh[j].x);
      const float* arow = alphas + ((size_t)t * B + b) * S;
      for (int s = ct; s < S; s += NC) cp_async4(alpha_sh + buf * S + s, arow + s);
    }
    commit_async();  // an empty group past the last frame keeps the count
  };

  for (int s = tid; s < S; s += nt) beta_sh[s] = final_logw[(size_t)b * S + s];
  if (STAGED) {
    for (int s = tid; s <= S; s += nt) off_sh[s] = by_off[(size_t)b * (S + 1) + s];
    for (int j = tid; j < n; j += nt) {
      const int a = arc_b[j];
      rec_sh[j] = make_int4(a, src_b[a], a / K, __float_as_int(logw_b[a]));
    }
    __syncthreads();  // the records and offsets are in place
  }
  if (tid == 0) {
    int nh = 0;
    for (int s = 0; s < S; ++s)
      if (off_b[s + 1] - off_b[s] > HEAVY_RUN) heavy_sh[1 + nh++] = s;
    heavy_sh[0] = nh;
  }
  if (STAGED)
    for (int i = 0; i < STAGES - 1; ++i) stage(i);
  if (ct >= 0) zero_span(po_b + (size_t)(T - 1) * A, A, ct, NC);
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i, buf = i % STAGES;
    const float* cur = beta_sh + (i & 1) * S;
    float* nxt = beta_sh + ((i + 1) & 1) * S;
    if (STAGED) wait_async_groups<STAGES - 2>();
    // frame t's ring entry (each thread's own copies, then everyone's), the
    // beta written last frame, the heavy states and the zeros of row t are
    // all in place
    __syncthreads();
    const float* yl = yl_b + (size_t)t * A;
    const float* al = STAGED ? alpha_sh + buf * S : alphas + ((size_t)t * B + b) * S;
    float* po = po_b + (size_t)t * A;
    // arc j of the list: its slot, and its arc_w into aw
    auto arc = [&](int j, float& aw) {
      if (STAGED) {
        const int4 r = rec_sh[j];
        aw = (__int_as_float(r.w) + yv_sh[buf * L + j]) + cur[r.z];
        return r.x;
      }
      const int a = arc_b[j];
      aw = (logw_b[a] + yl[a]) + cur[a / K];
      return a;
    };
    // alpha or aw may be -inf and logp +inf: each posterior's sum is then
    // -inf (never inf - inf), and expf(-inf) is exactly 0
    if (tid < NL) {
      // a light state: its run in list order, by one thread
      for (int sp = tid; sp < S; sp += NL) {
        const int j0 = off_b[sp], j1 = off_b[sp + 1];
        if (j1 - j0 > HEAVY_RUN) continue;
        const float asp = al[sp];
        float m = -INFINITY, aw;
        for (int j = j0; j < j1; ++j) {
          const int a = arc(j, aw);
          po[a] = expf(asp + aw - logp);
          m = fmaxf(m, aw);
        }
        float r = -INFINITY;
        if (m > -INFINITY) {
          float sum = 0.0f;
          for (int j = j0; j < j1; ++j) {
            arc(j, aw);
            sum += expf(aw - m);
          }
          r = m + logf(sum);
        }
        nxt[sp] = r;
      }
    } else if (ct < 0) {
      // a heavy state: lane g takes arcs g, g + 32, ... of its run (the
      // first four arc_w kept in registers), then a butterfly
      for (int h = hw; h < heavy_sh[0]; h += HEAVY_WARPS) {
        const int sp = heavy_sh[1 + h], j0 = off_b[sp], j1 = off_b[sp + 1];
        const float asp = al[sp];
        float m = -INFINITY, aw, kept[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + lane + 32 * k;
          kept[k] = -INFINITY;
          if (j < j1) {
            const int a = arc(j, aw);
            po[a] = expf(asp + aw - logp);
            kept[k] = aw;
            m = fmaxf(m, aw);
          }
        }
        for (int j = j0 + lane + 128; j < j1; j += 32) {
          const int a = arc(j, aw);
          po[a] = expf(asp + aw - logp);
          m = fmaxf(m, aw);
        }
        m = warp_fmax(m);
        float sum = 0.0f;
        if (m > -INFINITY) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (j0 + lane + 32 * k < j1) sum += expf(kept[k] - m);
          for (int j = j0 + lane + 128; j < j1; j += 32) {
            arc(j, aw);
            sum += expf(aw - m);
          }
        }
        sum = warp_sum(sum);
        if (lane == 0) nxt[sp] = m > -INFINITY ? m + logf(sum) : -INFINITY;
      }
    } else {
      // the copy warps: frame t - STAGES + 1's inputs into the ring entry
      // frame t + 1 has left, and the next row's zeros (ordered before its
      // live stores by the next barrier)
      if (STAGED) stage(i + STAGES - 1);
      if (t > 0) zero_span(po_b + (size_t)(t - 1) * A, A, ct, NC);
    }
  }
  if (STAGED) wait_async_groups<0>();  // the ring's empty groups, before the block exits
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The most dynamic shared memory a block of these kernels may ask for on the
// current device (opt-in limit), in bytes.
int e2e_shared_limit() { return shared_limit(); }

// Bytes of dynamic shared memory a K8b block asks for: with the list staged
// (staged = 1) or beta alone (0).
int e2e_backward_shared_bytes(int staged, int L, int S) {
  const long long bytes = k8_layout(staged != 0, L, S).bytes;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// Bytes of dynamic shared memory a K8f block asks for: with the list and
// the ring staged (staged = 1) or the offsets, the heavy states and alpha
// alone (0).
int e2e_forward_shared_bytes(int staged, int L, int S) {
  const long long bytes = k8f_layout(staged != 0, L, S).bytes;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// K8f: alphas of frames 1 .. T, on `stream`; `staged` as
// e2e_forward_shared_bytes; one thread per destination state (at most 832)
// and the heavy and copy warps.
int e2e_forward(const float* ylocal, const int* src, const float* logw, const int* in_off,
                const int* in_arc, float* out, int B, int T, int S, int K, int L, int staged,
                cudaStream_t stream) {
  if (B == 0 || T == 0) return 0;
  static int granted[2] = {0, 0};
  const long long bytes = k8f_layout(staged != 0, L, S).bytes;
  const int threads = 32 * (min((S + 31) / 32, 32 - FWD_HEAVY_WARPS - COPY_WARPS) +
                            FWD_HEAVY_WARPS + COPY_WARPS);
  int err;
  if (staged) {
    if ((err = allow_shared(e2e_fwd_kernel<true>, bytes, granted[1]))) return err;
    e2e_fwd_kernel<true><<<B, threads, bytes, stream>>>(ylocal, src, logw, in_off, in_arc, out,
                                                        B, T, S, K, L);
  } else {
    if ((err = allow_shared(e2e_fwd_kernel<false>, bytes, granted[0]))) return err;
    e2e_fwd_kernel<false><<<B, threads, bytes, stream>>>(ylocal, src, logw, in_off, in_arc, out,
                                                         B, T, S, K, L);
  }
  return (int)cudaGetLastError();
}

// K8b: per-arc posteriors of frames 0 .. T-1, on `stream`; `staged` as
// e2e_backward_shared_bytes; one thread per source state (at most 896) and
// the heavy and copy warps.
int e2e_backward(const float* ylocal, const float* alphas, const int* src, const float* logw,
                 const float* final_logw, const float* logp, const int* by_off,
                 const int* by_arc, float* post, int B, int T, int S, int K, int L, int staged,
                 cudaStream_t stream) {
  if (B == 0 || T == 0) return 0;
  static int granted[2] = {0, 0};
  const long long bytes = k8_layout(staged != 0, L, S).bytes;
  const int threads =
      32 * (min((S + 31) / 32, 32 - HEAVY_WARPS - COPY_WARPS) + HEAVY_WARPS + COPY_WARPS);
  int err;
  if (staged) {
    if ((err = allow_shared(e2e_bwd_kernel<true>, bytes, granted[1]))) return err;
    e2e_bwd_kernel<true><<<B, threads, bytes, stream>>>(ylocal, alphas, src, logw, final_logw,
                                                        logp, by_off, by_arc, post, B, T, S, K,
                                                        L);
  } else {
    if ((err = allow_shared(e2e_bwd_kernel<false>, bytes, granted[0]))) return err;
    e2e_bwd_kernel<false><<<B, threads, bytes, stream>>>(ylocal, alphas, src, logw, final_logw,
                                                         logp, by_off, by_arc, post, B, T, S, K,
                                                         L);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
