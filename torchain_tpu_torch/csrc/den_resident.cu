// Denominator forward-backward of LF-MMI on the slot-dense graph, as sparse
// kernels: K1 (forward) and K2 (backward), CUDA C++ for sm_90a.
//
// Replaces the Pallas kernels of torchain_tpu/ops/den_resident.py:
//   K1  den_forward  -> _fwd_kernel_inkernel / _fwd_body (pallas_call :565)
//   K2  den_backward -> _bwd_kernel                      (pallas_call :615)
//
// Math (probability space, per-frame renormalisation, leaky HMM):
//   forward, frame t:   sigma = s_hat + leaky * sum(s_hat) * init
//                       alpha = (sigma @ V) * pe_t,  pe_t[e] = p_t[pdf(e)]
//                       c = sum(alpha); logc_t = log c; ah_t = alpha / c
//                       s_hat' = sum over the K slot slices of ah_t
//   backward, frame t (reverse; bh starts at 1, G at log1p(leaky)):
//                       occ = ah_t * bh * exp(F_t + G - logZ)
//                       gamma_t[p] = sum of occ over the live slots of pdf p
//                       v = (pe_t * bh) @ V^T;  v += leaky * sum(v * init)
//                       d = max(v) (1 if <= 0); bh = v / d in every slice
//                       G += ymax_t + log d
//
// What bounds it on the H100: V [S, K*S] is more than 99.8% zeros (12,376
// non-zeros of 9.47 M at the trigram graph, 13,672 of 31.5 M at the
// production one), so the products are a few FMAs per slot and the data
// bound is the ah stream ([T, B, K*S] f32, written by K1 and read by K2).
// What limits it in practice is the T frames of a sequence, which depend on
// each other, and within a frame the SM's shared-memory pipe (the gathers of
// sigma, w and alpha by index are random across a warp's lanes).  So one
// block owns one sequence and runs all T frames in one launch, with its
// carried state in shared memory and nothing carried between blocks (the TPU
// kernel's sequential grid over T becomes the loop inside the block):
//   K1 keeps sigma [S], alpha [K*S] and a ring of two p rows [P]; the p row
//      of frame t+1 arrives by cp.async while frame t computes.  h = sigma @ V
//      walks V by column (CSC), one column per thread, in row order.
//   K2 keeps bh [S], a ring of two ah rows [K*S] and one p row [P], each
//      next row arriving by cp.async while the frame computes.  One thread
//      per pdf sums the occupancies of its live slots in slot order (the pdf
//      CSR, no atomics); one thread per slot then leaves w = p_t[pdf] * bh in
//      the ah row; v = V @ w walks V by row (CSR), one row per thread, in
//      column order.
// V's compressed arrays (offsets int32, indices 16-bit, values f32) and the
// slot/pdf tables are copied into shared memory once per launch where they
// fit beside the carried state under the opt-in limit (both shipped graphs:
// see ops/den_resident.py), else read through L2: the choice follows from the
// sizes alone (den_shared_bytes).  A graph whose carried state alone exceeds
// the limit is refused by the wrapper before any launch.
//
// Every sum has one order: a column's or a row's entries in index order, a
// pdf's slots in slot order, the block sums as den_common.cuh takes them.
// Two launches on the same inputs give the same bits.  Dead
// slots (slot_pdf < 0) get alpha = 0 exactly and appear in no CSR row (their
// V columns are zero).

#include <limits.h>

#include "den_common.cuh"

namespace {

// Byte offsets into one block's dynamic shared memory.  The carried state
// comes first; the graph's tables follow only where they are staged.
struct Layout {
  long long state, ring, ring_stride, pring, pring_stride, red;
  long long off, off2, val, idx, idx2, idx3, bytes;
};

// K1: sigma [S], alpha [K*S], two p rows, two reduction arrays; staged:
// csc offsets [K*S + 1], values [nnz], rows u16 [nnz], slot_pdf u16 [K*S].
// K2: bh [S], two ah rows [K*S], one p row, sum and max reduction arrays;
// staged: csr offsets [S + 1], pdf offsets [P + 1], values [nnz], columns
// u16 [nnz], pdf slots u16 [live], slot_pdf u16 [K*S].
// (slot_pdf u16: 0xFFFF for a dead slot; a carried p row bounds P below it.)
__host__ __device__ inline Layout layout(bool backward, int S, int K, int P, int nnz, int live,
                                         bool staged) {
  Layout L{};
  const long long KS = (long long)K * S;
  long long o = 0;
  L.state = o;
  o += up16(4 * (long long)S);
  L.ring = o;
  L.ring_stride = up16(4 * KS);
  o += backward ? 2 * L.ring_stride : L.ring_stride;
  L.pring = o;
  L.pring_stride = up16(4 * (long long)P);
  o += backward ? L.pring_stride : 2 * L.pring_stride;
  L.red = o;
  o += 2 * 4 * MAX_WARPS;
  if (staged) {
    L.off = o;
    o += up16(4 * ((backward ? S : KS) + 1));
    L.off2 = o;  // K2: pdf offsets
    if (backward) o += up16(4 * ((long long)P + 1));
    L.val = o;
    o += up16(4 * (long long)nnz);
    L.idx = o;
    o += up16(2 * (long long)nnz);
    L.idx2 = o;  // K1: slot_pdf; K2: pdf slots
    o += up16(2 * (backward ? (long long)live : KS));
    L.idx3 = o;  // K2: slot_pdf
    if (backward) o += up16(2 * KS);
  }
  L.bytes = o;
  return L;
}

// slot_pdf staged as 16 bits (copy_u16) marks a dead slot 0xFFFF
constexpr unsigned DEAD16 = 0xFFFF;

// e mod S without a division: e - S * floor(e * m / 2^32) with
// m = floor((2^32 - 1) / S) + 1, exact for e, S < 2^16 (every index here;
// m wraps to 0 for S = 1, where the answer is 0)
__device__ __forceinline__ int mod_by(int e, int S, unsigned m) {
  return S == 1 ? 0 : e - S * (int)__umulhi((unsigned)e, m);
}

// K1.  One block per sequence b, all T frames.
//   p [T, B, P]; init [S]; CSC of V: coff [K*S + 1], crow u16 [nnz], cval
//   [nnz]; slot_pdf [K*S] (-1 = dead).  Out: ah [T, B, K*S], logc [T, B].
template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 1)
den_fwd_kernel(const float* __restrict__ p, const float* __restrict__ init,
               const int* __restrict__ coff_g, const unsigned short* __restrict__ crow_g,
               const float* __restrict__ cval_g, const int* __restrict__ spdf_g,
               float* __restrict__ ah, float* __restrict__ logc, int T, int B, int P, int S,
               int K, int nnz, float leaky, int pgran) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(false, S, K, P, nnz, 0, STAGED);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, KS = K * S;
  float* sig = (float*)(smem + L.state);
  float* alpha = (float*)(smem + L.ring);
  float* red_c = (float*)(smem + L.red);
  float* red_s = red_c + MAX_WARPS;
  auto prow = [&](int t) { return (float*)(smem + L.pring + (t & 1) * L.pring_stride); };

  copy_async(prow(0), p + (size_t)b * P, P, pgran);
  commit_async();

  const int* coff = coff_g;
  const unsigned short* crow = crow_g;
  const float* cval = cval_g;
  const unsigned short* spdf_s = nullptr;
  if constexpr (STAGED) {
    int* o = (int*)(smem + L.off);
    float* v = (float*)(smem + L.val);
    unsigned short* r = (unsigned short*)(smem + L.idx);
    unsigned short* q = (unsigned short*)(smem + L.idx2);
    copy_plain(o, coff_g, KS + 1);
    copy_plain(v, cval_g, nnz);
    copy_plain(r, crow_g, nnz);
    copy_u16(q, spdf_g, KS);
    coff = o;
    cval = v;
    crow = r;
    spdf_s = q;
  }
  auto pdf_of = [&](int e) -> int {  // -1 for a dead slot
    if constexpr (STAGED) {
      const unsigned q = spdf_s[e];
      return q == DEAD16 ? -1 : (int)q;
    } else {
      return __ldg(spdf_g + e);
    }
  };
  // sigma from s_hat (in sig): the leaky term needs the block's sum of s_hat
  // (each thread reads and writes only its own states here)
  auto leak = [&](float part) {
    if (leaky > 0.0f) {
      const float lt = leaky * block_sum(part, red_s);
      for (int s = tid; s < S; s += nt) sig[s] = fmaf(lt, __ldg(init + s), sig[s]);
    }
  };

  float part = 0.0f;  // s_hat of frame 0 is init
  for (int s = tid; s < S; s += nt) {
    const float x = __ldg(init + s);
    sig[s] = x;
    part += x;
  }
  leak(part);

  for (int t = 0; t < T; ++t) {
    const float* pt = prow(t);
    wait_async();
    __syncthreads();  // p_t, sigma (and the staged tables) in place
    if (t + 1 < T) copy_async(prow(t + 1), p + ((size_t)(t + 1) * B + b) * P, P, pgran);
    commit_async();
    float csum = 0.0f;
    for (int e = tid; e < KS; e += nt) {
      float h = 0.0f;
      const int j1 = coff[e + 1];
#pragma unroll 4
      for (int j = coff[e]; j < j1; ++j) h = fmaf(sig[crow[j]], cval[j], h);
      const int q = pdf_of(e);
      const float a = q >= 0 ? h * pt[q] : 0.0f;
      alpha[e] = a;
      csum += a;
    }
    const float c = block_sum(csum, red_c);  // also: every read of sigma done
    float* arow = ah + ((size_t)t * B + b) * KS;
    for (int e = tid; e < KS; e += nt) {
      const float x = alpha[e] / c;
      alpha[e] = x;
      __stcs(arow + e, x);
    }
    if (tid == 0) logc[(size_t)t * B + b] = logf(c);
    __syncthreads();  // alpha_hat in place
    part = 0.0f;
    for (int s = tid; s < S; s += nt) {
      float x = alpha[s];
      for (int k = 1; k < K; ++k) x += alpha[k * S + s];
      sig[s] = x;
      part += x;
    }
    leak(part);
  }
}

// K2.  One block per sequence b, frames T-1 .. 0.
//   p [T, B, P]; ah [T, B, K*S]; F, ymax [T, B]; logz [B]; init [S]; CSR
//   of V: roff [S + 1], rcol u16 [nnz], rval [nnz]; live slots per pdf:
//   qoff [P + 1], qslot [live]; slot_pdf [K*S].  Out: gamma [B, T, P].
template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 1)
den_bwd_kernel(const float* __restrict__ p, const float* __restrict__ ah,
               const float* __restrict__ F, const float* __restrict__ ymax,
               const float* __restrict__ logz, const float* __restrict__ init,
               const int* __restrict__ roff_g, const unsigned short* __restrict__ rcol_g,
               const float* __restrict__ rval_g, const int* __restrict__ qoff_g,
               const int* __restrict__ qslot_g, const int* __restrict__ spdf_g,
               float* __restrict__ gamma, int T, int B, int P, int S, int K, int nnz, int live,
               float leaky, float g0, int pgran, int agran) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(true, S, K, P, nnz, live, STAGED);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x, KS = K * S;
  const unsigned mS = 0xFFFFFFFFu / (unsigned)S + 1u;
  float* bh = (float*)(smem + L.state);
  float* pt = (float*)(smem + L.pring);
  float* red = (float*)(smem + L.red);
  auto arow_of = [&](int t) { return (float*)(smem + L.ring + (t & 1) * L.ring_stride); };
  auto fetch_ah = [&](int t) {  // frame t's ah row into its ring slot
    copy_async(arow_of(t), ah + ((size_t)t * B + b) * KS, KS, agran);
    commit_async();
  };
  auto fetch_p = [&](int t) {
    copy_async(pt, p + ((size_t)t * B + b) * P, P, pgran);
    commit_async();
  };
  fetch_ah(T - 1);
  fetch_p(T - 1);

  const int* roff = roff_g;
  const unsigned short* rcol = rcol_g;
  const float* rval = rval_g;
  const int* qoff = qoff_g;
  const unsigned short* qslot_s = nullptr;
  const unsigned short* spdf_s = nullptr;
  if constexpr (STAGED) {
    int* o = (int*)(smem + L.off);
    int* qo = (int*)(smem + L.off2);
    float* v = (float*)(smem + L.val);
    unsigned short* c = (unsigned short*)(smem + L.idx);
    unsigned short* qs = (unsigned short*)(smem + L.idx2);
    unsigned short* sp = (unsigned short*)(smem + L.idx3);
    copy_plain(o, roff_g, S + 1);
    copy_plain(qo, qoff_g, P + 1);
    copy_plain(v, rval_g, nnz);
    copy_plain(c, rcol_g, nnz);
    copy_u16(qs, qslot_g, live);
    copy_u16(sp, spdf_g, KS);
    roff = o;
    qoff = qo;
    rval = v;
    rcol = c;
    qslot_s = qs;
    spdf_s = sp;
  }
  auto slot_of = [&](int j) -> int {
    if constexpr (STAGED) return qslot_s[j];
    else return __ldg(qslot_g + j);
  };
  auto pdf_of = [&](int e) -> int {  // -1 for a dead slot
    if constexpr (STAGED) {
      const unsigned q = spdf_s[e];
      return q == DEAD16 ? -1 : (int)q;
    } else {
      return __ldg(spdf_g + e);
    }
  };

  for (int s = tid; s < S; s += nt) bh[s] = 1.0f;
  float G = g0;
  const float lz = logz[b];
  // this frame's F and ymax; the next frame's are loaded a frame ahead
  float Ft = F[(size_t)(T - 1) * B + b], yt = ymax[(size_t)(T - 1) * B + b];
  for (int t = T - 1; t >= 0; --t) {
    float* arow = arow_of(t);
    wait_async();
    __syncthreads();  // frame t's rows, bh (and the staged tables) in place
    float Fn = 0.0f, yn = 0.0f;
    if (t > 0) {
      fetch_ah(t - 1);
      Fn = F[(size_t)(t - 1) * B + b];
      yn = ymax[(size_t)(t - 1) * B + b];
    }
    const float scale = expf((Ft + G) - lz);
    float* grow = gamma + ((size_t)b * T + t) * P;
    // occupancies by pdf, each over its live slots in slot order
    for (int q = tid; q < P; q += nt) {
      float acc = 0.0f;
      const int j1 = qoff[q + 1];
#pragma unroll 4
      for (int j = qoff[q]; j < j1; ++j) {
        const int e = slot_of(j);
        acc += arow[e] * bh[mod_by(e, S, mS)] * scale;
      }
      __stcs(grow + q, acc);
    }
    if (t == 0) break;  // the pullback past frame 0 feeds nothing
    __syncthreads();    // every read of ah_t done
    // w = p_t[pdf] * bh in the ah row, on the live slots (the only ones V's
    // rows name)
    for (int e = tid; e < KS; e += nt) {
      const int q = pdf_of(e);
      if (q >= 0) arow[e] = pt[q] * bh[mod_by(e, S, mS)];
    }
    __syncthreads();  // w in place; every read of bh and of p_t done
    fetch_p(t - 1);
    float dot = 0.0f, mx = -INFINITY;
    for (int s = tid; s < S; s += nt) {
      const float in = __ldg(init + s);
      float v = 0.0f;
      const int j1 = roff[s + 1];
#pragma unroll 4
      for (int j = roff[s]; j < j1; ++j) v = fmaf(rval[j], arow[rcol[j]], v);
      bh[s] = v;
      dot = fmaf(v, in, dot);
      mx = max_nan(mx, v);
    }
    block_sum_max(dot, mx, red);  // also: every v in place
    // max(v + add) == max(v) + add: rounding is monotonic
    const float add = leaky > 0.0f ? leaky * dot : 0.0f;
    float d = leaky > 0.0f ? mx + add : mx;
    d = d > 0.0f ? d : 1.0f;
    for (int s = tid; s < S; s += nt) bh[s] = (leaky > 0.0f ? bh[s] + add : bh[s]) / d;
    G = (G + yt) + logf(d);
    Ft = Fn;
    yt = yn;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The most dynamic shared memory a block may ask for, in bytes.
int den_shared_limit() { return shared_limit(); }

// Bytes of dynamic shared memory K1 (backward = 0) or K2 (backward = 1) asks
// for: the carried state alone (staged = 0) or with the graph's tables.
int den_shared_bytes(int backward, int S, int K, int P, int nnz, int live, int staged) {
  const long long bytes = layout(backward != 0, S, K, P, nnz, live, staged != 0).bytes;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// K1: the whole forward pass, one launch on `stream`.
int den_forward(const float* p, const float* init, const int* csc_off,
                const unsigned short* csc_rows, const float* csc_vals, const int* slot_pdf,
                float* ah, float* logc, int T, int B, int P, int S, int K, int nnz, int staged,
                float leaky, cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  static int granted[2] = {0, 0};
  const long long bytes = layout(false, S, K, P, nnz, 0, staged != 0).bytes;
  const int gran = granule(p, P);
  int err;
  if (staged) {
    if ((err = allow_shared(den_fwd_kernel<true>, bytes, granted[1]))) return err;
    den_fwd_kernel<true><<<B, THREADS, bytes, stream>>>(p, init, csc_off, csc_rows, csc_vals,
                                                        slot_pdf, ah, logc, T, B, P, S, K, nnz,
                                                        leaky, gran);
  } else {
    if ((err = allow_shared(den_fwd_kernel<false>, bytes, granted[0]))) return err;
    den_fwd_kernel<false><<<B, THREADS, bytes, stream>>>(p, init, csc_off, csc_rows, csc_vals,
                                                         slot_pdf, ah, logc, T, B, P, S, K, nnz,
                                                         leaky, gran);
  }
  return (int)cudaGetLastError();
}

// K2: the whole backward pass, frames T-1 .. 0, one launch on `stream`.
// g0 is G's start (log1p(leaky), or 0).
int den_backward(const float* p, const float* ah, const float* F, const float* ymax,
                 const float* logz, const float* init, const int* csr_off,
                 const unsigned short* csr_cols, const float* csr_vals, const int* pdf_off,
                 const int* pdf_slot, const int* slot_pdf, float* gamma, int T, int B, int P,
                 int S, int K, int nnz, int live, int staged, float leaky, float g0,
                 cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  static int granted[2] = {0, 0};
  const long long bytes = layout(true, S, K, P, nnz, live, staged != 0).bytes;
  const int pgran = granule(p, P), agran = granule(ah, (long long)K * S);
  int err;
  if (staged) {
    if ((err = allow_shared(den_bwd_kernel<true>, bytes, granted[1]))) return err;
    den_bwd_kernel<true><<<B, THREADS, bytes, stream>>>(
        p, ah, F, ymax, logz, init, csr_off, csr_cols, csr_vals, pdf_off, pdf_slot, slot_pdf,
        gamma, T, B, P, S, K, nnz, live, leaky, g0, pgran, agran);
  } else {
    if ((err = allow_shared(den_bwd_kernel<false>, bytes, granted[0]))) return err;
    den_bwd_kernel<false><<<B, THREADS, bytes, stream>>>(
        p, ah, F, ymax, logz, init, csr_off, csr_cols, csr_vals, pdf_off, pdf_slot, slot_pdf,
        gamma, T, B, P, S, K, nnz, live, leaky, g0, pgran, agran);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
