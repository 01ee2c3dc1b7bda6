// Denominator forward-backward of LF-MMI on the dense Moore graph, as sparse
// kernels: K9f (forward) and K9b (backward), CUDA C++ for sm_90a.
//
// Replaces the fused Pallas kernels of torchain_tpu/ops/den_pallas.py:
//   K9f  dense_den_forward  -> _fwd_kernel (den_forward,  pallas_call :118)
//   K9b  dense_den_backward -> _bwd_kernel (den_backward, pallas_call :160)
//
// Math (probability space, per-frame renormalisation, leaky HMM; S original
// states, E expanded states, e enters original state orig(e); pe_t = p_t @
// P_mat is computed by the caller for all frames at once):
//   forward, frame t (s_hat starts at init):
//       sig[t] = s_hat                      (the carry at entry, unleaked)
//       sigma  = s_hat + leaky * sum(s_hat) * init
//       alpha  = (sigma @ V) * pe_t;  c = sum(alpha);  logc_t = log c
//       s_hat'[s] = sum of alpha[e] / c over the real e with orig(e) == s
//   backward, frame t (reverse; bh starts at 1, G at log1p(leaky)):
//       sigma   = sig[t] + leaky * sum(sig[t]) * init
//       gout[t] = pe_t * (sigma @ V) * bh * exp(fscale_t + G)
//       v = (pe_t * bh) @ V^T;  v += leaky * sum(v * init)
//       nb[e] = v[orig(e)] for the real e, 0 for the padded ones
//       d = max(nb) (1 if <= 0);  bh = nb / d;  G += ymax_t + log d
//
// What bounds it on the H100: V [S, E] is more than 99.8% zeros (12,376
// non-zeros of 9.19 M at the trigram graph), so a frame's products are a
// few FMAs per expanded state, and the data bound is the pe stream ([T, B,
// E] f32, read by both kernels), the sig stream ([T, B, S], written by K9f
// and read by K9b) and gout ([T, B, E], written by K9b).  What limits it in
// practice is the T frames of a sequence, which depend on each other, and
// within a frame the SM's shared-memory pipe (the gathers of sigma and w by
// index are random across a warp's lanes).  So, as K1/K2 (den_resident.cu),
// one block owns one sequence and runs all T frames in one launch, with its
// carried state in shared memory and nothing carried between blocks (the TPU
// kernel's loop over T stays inside the block):
//   K9f keeps sigma [S] and a ring of two pe rows [E]; alpha replaces pe_t
//       in its slot, and the pe row of frame t+1 arrives by cp.async while
//       frame t computes.  h = sigma @ V walks V by column (CSC), one column
//       per thread, in row order; s_hat' walks each original state's list of
//       real expanded states in list order.  Frame 0's carry (init) and its
//       leak are the kernel's.
//   K9b keeps bh over the original states [S] (bh[e] = bh_S[orig(e)] for a
//       real e, 0 for a padded one; 1 everywhere in the first frame), one
//       sig row [S] and a ring of two pe rows [E]; w = pe_t * bh replaces
//       pe_t in its slot.  h walks the CSC as in K9f; v = V @ w walks V by
//       row (CSR), one row per thread, in column order.  The pe row of frame
//       t-1 arrives by cp.async while frame t computes, the sig row once the
//       walk of the CSC has let go of sigma.  d is the maximum of v over the
//       states that some real expanded state enters (a bit mask per thread),
//       and 0 where padded expanded states exist: v of a state no expanded
//       state enters is in no nb.  Padded expanded states (E_mat's all-zero
//       rows, orig_of_exp pointing at state 0) get gout = 0 exactly: their V
//       columns are empty.
// V's compressed arrays (offsets int32, indices 16-bit, values f32) are copied
// into shared memory once per launch where they fit beside the carried state
// under the opt-in limit, else read through L2: the choice follows from the
// sizes alone (dense_shared_bytes; K9b stages the CSR first, then the CSC).
// At the trigram graph all of K9f's and K9b's tables fit (see
// ops/den_pallas.py).  A graph whose carried state alone exceeds the limit,
// or whose S or E needs more than 16 bits, is refused by the wrapper before
// any launch.
//
// Every sum has one order: a column's or a row's entries in index order, a
// state's expanded states in list order, the block sums as den_common.cuh
// takes them.  Two launches on the same inputs give the same bits; there are
// no atomics.

#include <limits.h>

#include "den_common.cuh"

namespace {

// which of V's compressed forms a block stages in shared memory
constexpr int CSC = 1, CSR = 2;

// Byte offsets into one block's dynamic shared memory.  The carried state
// comes first; the graph's tables follow only where they are staged.
struct Layout {
  long long state, sig, ring, ring_stride, red;
  long long roff, rval, rcol, coff, cval, crow, ooff, oexp, bytes;
};

// K9f: sigma [S], two pe rows [E], two reduction arrays; staged (CSC): csc
// offsets [E + 1], values [nnz], rows u16 [nnz], orig_offsets [S + 1],
// orig_exps u16 [real_exp].
// K9b: bh [S], one sig row [S], two pe rows [E], a sum and a sum-and-max
// reduction array; staged (CSR): csr offsets [S + 1], values, columns u16;
// (CSC): csc offsets, values, rows u16.
__host__ __device__ inline Layout layout(bool backward, int S, int E, int nnz, int real_exp,
                                         int staged) {
  Layout L{};
  long long o = 0;
  L.state = o;
  o += up16(4LL * S);
  L.sig = o;
  if (backward) o += up16(4LL * S);
  L.ring = o;
  L.ring_stride = up16(4LL * E);
  o += 2 * L.ring_stride;
  L.red = o;
  o += (backward ? 3 : 2) * 4 * MAX_WARPS;
  if (backward && (staged & CSR)) {
    L.roff = o;
    o += up16(4LL * (S + 1));
    L.rval = o;
    o += up16(4LL * nnz);
    L.rcol = o;
    o += up16(2LL * nnz);
  }
  if (staged & CSC) {
    L.coff = o;
    o += up16(4LL * (E + 1));
    L.cval = o;
    o += up16(4LL * nnz);
    L.crow = o;
    o += up16(2LL * nnz);
    if (!backward) {
      L.ooff = o;
      o += up16(4LL * (S + 1));
      L.oexp = o;
      o += up16(2LL * real_exp);
    }
  }
  L.bytes = o;
  return L;
}

// K9f.  One block per sequence b, all T frames.
//   pe [T, B, E]; init [S]; CSC of V: coff [E + 1], crow u16 [nnz], cval
//   [nnz]; orig_offsets [S + 1] / orig_exps [real_exp]: the real expanded
//   states of each original state.  Out: logc [T, B], sig [T, B, S].
template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 1)
dense_fwd_kernel(const float* __restrict__ pe, const float* __restrict__ init,
                 const int* __restrict__ coff_g, const unsigned short* __restrict__ crow_g,
                 const float* __restrict__ cval_g, const int* __restrict__ ooff_g,
                 const int* __restrict__ oexp_g, float* __restrict__ logc,
                 float* __restrict__ sig_out, int T, int B, int S, int E, int nnz,
                 int real_exp, float leaky, int gran) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(false, S, E, nnz, real_exp, STAGED ? CSC : 0);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  float* sig = (float*)(smem + L.state);
  float* red_c = (float*)(smem + L.red);
  float* red_s = red_c + MAX_WARPS;
  auto row = [&](int t) { return (float*)(smem + L.ring + (t & 1) * L.ring_stride); };

  copy_async(row(0), pe + (size_t)b * E, E, gran);
  commit_async();

  const int* coff = coff_g;
  const unsigned short* crow = crow_g;
  const float* cval = cval_g;
  const int* ooff = ooff_g;
  const unsigned short* oexp_s = nullptr;
  if constexpr (STAGED) {
    int* o = (int*)(smem + L.coff);
    float* v = (float*)(smem + L.cval);
    unsigned short* r = (unsigned short*)(smem + L.crow);
    int* oo = (int*)(smem + L.ooff);
    unsigned short* oe = (unsigned short*)(smem + L.oexp);
    copy_plain(o, coff_g, E + 1);
    copy_plain(v, cval_g, nnz);
    copy_plain(r, crow_g, nnz);
    copy_plain(oo, ooff_g, S + 1);
    copy_u16(oe, oexp_g, real_exp);
    coff = o;
    cval = v;
    crow = r;
    ooff = oo;
    oexp_s = oe;
  }
  auto exp_of = [&](int j) -> int {
    if constexpr (STAGED) return oexp_s[j];
    else return __ldg(oexp_g + j);
  };
  // sigma from s_hat (in sig): the leaky term needs the block's sum of s_hat
  // (each thread reads and writes only its own states here)
  auto leak = [&](float part) {
    if (leaky > 0.0f) {
      const float lt = leaky * block_sum(part, red_s);
      for (int s = tid; s < S; s += nt) sig[s] = fmaf(lt, __ldg(init + s), sig[s]);
    }
  };

  float part = 0.0f;  // the carry of frame 0 is init
  for (int s = tid; s < S; s += nt) {
    const float x = __ldg(init + s);
    sig[s] = x;
    __stcs(sig_out + (size_t)b * S + s, x);
    part += x;
  }
  leak(part);

  for (int t = 0; t < T; ++t) {
    float* a = row(t);  // pe_t, then alpha
    wait_async();
    __syncthreads();  // pe_t, sigma (and the staged tables) in place
    if (t + 1 < T) copy_async(row(t + 1), pe + ((size_t)(t + 1) * B + b) * E, E, gran);
    commit_async();
    float csum = 0.0f;
    for (int e = tid; e < E; e += nt) {
      float h = 0.0f;
      const int j1 = coff[e + 1];
#pragma unroll 4
      for (int j = coff[e]; j < j1; ++j) h = fmaf(sig[crow[j]], cval[j], h);
      const float x = h * a[e];
      a[e] = x;
      csum += x;
    }
    const float c = block_sum(csum, red_c);  // also: alpha in place, sigma read
    if (tid == 0) logc[(size_t)t * B + b] = logf(c);
    if (t + 1 == T) break;
    float* out = sig_out + ((size_t)(t + 1) * B + b) * S;
    part = 0.0f;
    for (int s = tid; s < S; s += nt) {
      float x = 0.0f;
      const int j1 = ooff[s + 1];
      for (int j = ooff[s]; j < j1; ++j) x += a[exp_of(j)] / c;
      sig[s] = x;
      __stcs(out + s, x);
      part += x;
    }
    leak(part);
  }
}

// K9b.  One block per sequence b, frames T-1 .. 0.
//   pe [T, B, E]; sig [T, B, S]; fscale, ymax [T, B]; init [S]; CSC and CSR
//   of V; orig16 [E] (orig_of_exp as u16); orig_offsets [S + 1].
//   Out: gout [T, B, E].
template <bool CSC_STAGED, bool CSR_STAGED>
__global__ void __launch_bounds__(THREADS, 1)
dense_bwd_kernel(const float* __restrict__ pe, const float* __restrict__ sig_in,
                 const float* __restrict__ fscale, const float* __restrict__ ymax,
                 const float* __restrict__ init, const int* __restrict__ coff_g,
                 const unsigned short* __restrict__ crow_g, const float* __restrict__ cval_g,
                 const int* __restrict__ roff_g, const unsigned short* __restrict__ rcol_g,
                 const float* __restrict__ rval_g, const unsigned short* __restrict__ orig16,
                 const int* __restrict__ ooff_g, float* __restrict__ gout, int T, int B, int S,
                 int E, int nnz, int real_exp, float leaky, float g0, int pgran, int sgran) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(true, S, E, nnz, real_exp,
                          (CSC_STAGED ? CSC : 0) | (CSR_STAGED ? CSR : 0));
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  float* bh = (float*)(smem + L.state);  // over the original states
  float* sg = (float*)(smem + L.sig);    // sig_t, then sigma
  float* red_l = (float*)(smem + L.red);
  float* red = red_l + MAX_WARPS;
  auto row = [&](int t) { return (float*)(smem + L.ring + (t & 1) * L.ring_stride); };
  auto fetch_sig = [&](int t) {
    copy_async(sg, sig_in + ((size_t)t * B + b) * S, S, sgran);
    commit_async();
  };
  copy_async(row(T - 1), pe + ((size_t)(T - 1) * B + b) * E, E, pgran);
  fetch_sig(T - 1);

  const int* coff = coff_g;
  const unsigned short* crow = crow_g;
  const float* cval = cval_g;
  const int* roff = roff_g;
  const unsigned short* rcol = rcol_g;
  const float* rval = rval_g;
  if constexpr (CSR_STAGED) {
    int* o = (int*)(smem + L.roff);
    float* v = (float*)(smem + L.rval);
    unsigned short* c = (unsigned short*)(smem + L.rcol);
    copy_plain(o, roff_g, S + 1);
    copy_plain(v, rval_g, nnz);
    copy_plain(c, rcol_g, nnz);
    roff = o;
    rval = v;
    rcol = c;
  }
  if constexpr (CSC_STAGED) {
    int* o = (int*)(smem + L.coff);
    float* v = (float*)(smem + L.cval);
    unsigned short* r = (unsigned short*)(smem + L.crow);
    copy_plain(o, coff_g, E + 1);
    copy_plain(v, cval_g, nnz);
    copy_plain(r, crow_g, nnz);
    coff = o;
    cval = v;
    crow = r;
  }
  // bit k: state tid + k * THREADS is entered by a real expanded state
  // (S < 2^16 = 64 * THREADS, so 64 bits hold a thread's states)
  unsigned long long entered = 0;
  for (int s = tid, k = 0; s < S; s += nt, ++k)
    if (__ldg(ooff_g + s + 1) > __ldg(ooff_g + s)) entered |= 1ull << k;

  float G = g0;
  // this frame's fscale and ymax; the next frame's are loaded a frame ahead
  float Ft = fscale[(size_t)(T - 1) * B + b], yt = ymax[(size_t)(T - 1) * B + b];
  for (int t = T - 1; t >= 0; --t) {
    float* w = row(t);  // pe_t, then w = pe_t * bh
    wait_async();
    __syncthreads();  // frame t's rows, bh (and the staged tables) in place
    float Fn = 0.0f, yn = 0.0f;
    if (t > 0) {
      copy_async(row(t - 1), pe + ((size_t)(t - 1) * B + b) * E, E, pgran);
      commit_async();
      Fn = fscale[(size_t)(t - 1) * B + b];
      yn = ymax[(size_t)(t - 1) * B + b];
    }
    if (leaky > 0.0f) {
      float part = 0.0f;
      for (int s = tid; s < S; s += nt) part += sg[s];
      const float lt = leaky * block_sum(part, red_l);
      for (int s = tid; s < S; s += nt) sg[s] = fmaf(lt, __ldg(init + s), sg[s]);
      __syncthreads();  // sigma in place
    }
    const float scale = expf(Ft + G);
    const bool first = t == T - 1;
    float* grow = gout + ((size_t)t * B + b) * E;
    for (int e = tid; e < E; e += nt) {
      float h = 0.0f;
      const int j1 = coff[e + 1];
#pragma unroll 4
      for (int j = coff[e]; j < j1; ++j) h = fmaf(sg[crow[j]], cval[j], h);
      const float be = first ? 1.0f : (e < real_exp ? bh[__ldg(orig16 + e)] : 0.0f);
      const float p = w[e];
      __stcs(grow + e, p * h * be * scale);
      w[e] = p * be;
    }
    if (t == 0) break;  // the pullback past frame 0 feeds nothing
    __syncthreads();    // w in place; every read of sigma and of bh done
    fetch_sig(t - 1);
    float dot = 0.0f, mx = -INFINITY;
    for (int s = tid, k = 0; s < S; s += nt, ++k) {
      float v = 0.0f;
      const int j1 = roff[s + 1];
#pragma unroll 4
      for (int j = roff[s]; j < j1; ++j) v = fmaf(rval[j], w[rcol[j]], v);
      bh[s] = v;
      dot = fmaf(v, __ldg(init + s), dot);
      if ((entered >> k) & 1ull) mx = max_nan(mx, v);
    }
    block_sum_max(dot, mx, red);  // also: every v in place
    // max(v + add) == max(v) + add: rounding is monotonic
    const float add = leaky > 0.0f ? leaky * dot : 0.0f;
    float d = leaky > 0.0f ? mx + add : mx;
    if (real_exp < E) d = max_nan(d, 0.0f);  // the padded expanded states' nb
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
int dense_shared_limit() { return shared_limit(); }

// Bytes of dynamic shared memory K9f (backward = 0) or K9b (backward = 1)
// asks for with the compressed forms `staged` names (CSC = 1, CSR = 2;
// 0: the carried state alone).
int dense_shared_bytes(int backward, int S, int E, int nnz, int real_exp, int staged) {
  const long long bytes = layout(backward != 0, S, E, nnz, real_exp, staged).bytes;
  return bytes > INT_MAX ? INT_MAX : (int)bytes;
}

// K9f: the whole forward pass, one launch on `stream`.  staged: 1 (CSC and
// the orig lists in shared memory) or 0.
int dense_den_forward(const float* pe, const float* init, const int* csc_off,
                      const unsigned short* csc_rows, const float* csc_vals,
                      const int* orig_off, const int* orig_exps, float* logc, float* sig,
                      int T, int B, int S, int E, int nnz, int real_exp, int staged,
                      float leaky, cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  static int granted[2] = {0, 0};
  const long long bytes = layout(false, S, E, nnz, real_exp, staged ? CSC : 0).bytes;
  const auto kernel = staged ? dense_fwd_kernel<true> : dense_fwd_kernel<false>;
  if (const int err = allow_shared(kernel, bytes, granted[staged ? 1 : 0])) return err;
  kernel<<<B, THREADS, bytes, stream>>>(pe, init, csc_off, csc_rows, csc_vals, orig_off,
                                        orig_exps, logc, sig, T, B, S, E, nnz, real_exp, leaky,
                                        granule(pe, E));
  return (int)cudaGetLastError();
}

// K9b: the whole backward pass, frames T-1 .. 0, one launch on `stream`.
// staged: CSC | CSR (3), CSR (2) or 0; g0 is G's start (log1p(leaky), or 0).
int dense_den_backward(const float* pe, const float* sig, const float* fscale,
                       const float* ymax, const float* init, const int* csc_off,
                       const unsigned short* csc_rows, const float* csc_vals,
                       const int* csr_off, const unsigned short* csr_cols,
                       const float* csr_vals, const unsigned short* orig16,
                       const int* orig_off, float* gout, int T, int B, int S, int E, int nnz,
                       int real_exp, int staged, float leaky, float g0, cudaStream_t stream) {
  if (T == 0 || B == 0) return 0;
  if (staged != (CSC | CSR) && staged != CSR && staged != 0) return (int)cudaErrorInvalidValue;
  static int granted[4] = {0, 0, 0, 0};
  const long long bytes = layout(true, S, E, nnz, real_exp, staged).bytes;
  const auto kernel = staged == (CSC | CSR) ? dense_bwd_kernel<true, true>
                      : staged == CSR       ? dense_bwd_kernel<false, true>
                                            : dense_bwd_kernel<false, false>;
  if (const int err = allow_shared(kernel, bytes, granted[staged])) return err;
  kernel<<<B, THREADS, bytes, stream>>>(pe, sig, fscale, ymax, init, csc_off, csc_rows,
                                        csc_vals, csr_off, csr_cols, csr_vals, orig16, orig_off,
                                        gout, T, B, S, E, nnz, real_exp, leaky, g0,
                                        granule(pe, E), granule(sig, S));
  return (int)cudaGetLastError();
}

}  // extern "C"
