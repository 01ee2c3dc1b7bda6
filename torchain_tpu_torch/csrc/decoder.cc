// Token-passing Viterbi decoder — native core.
//
// Behavioral reference: the best-path slice of Kaldi's
// latgen-faster-mapped / faster-decoder (kaldi/src/decoder/), operating on
// the packed arc arrays produced by
// torchain_tpu_torch.eval.decoder.make_decoding_graph (same dst-sorted layout as
// the numpy implementation, which remains the reference in tests).
// Exposed through a flat C ABI consumed via ctypes — the same boundary
// style torchain's bridge used for Kaldi (extern "C" over opaque data),
// but with no framework dependency on either side.
//
// Input-epsilon (non-emitting) arcs — real Kaldi HCLGs carry them as
// word-boundary / LM-backoff arcs — are supported by the *_eps entry
// points: the eps arc list arrives pre-sorted by topological level of its
// source within the eps subgraph (decoder.py _pack_eps_arcs), so ONE
// in-order relaxation sweep per frame boundary is exact (Kaldi's
// ProcessNonemitting step, [K decoder/lattice-faster-decoder.cc]).
//
// Built by torchain_tpu_torch/eval/native.py at first use (g++ -O3
// -march=native -fPIC -std=c++17 -shared, into torchain_tpu_torch/build/).
// A copy of the JAX package's csrc/decoder.cc: the same C ABI, the same
// results.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {
constexpr float kNegInf = -std::numeric_limits<float>::infinity();
}

extern "C" {

// Bumped whenever any symbol's signature changes; the Python bridge
// rebuilds a library older than this source, so this is a belt-and-braces
// guard for hand-copied binaries.
int tt_abi_version(void) { return 3; }

// Returns 0 on success, nonzero on error.  out_phones must have room for T
// entries; *out_len receives the number of phones written.
int tt_viterbi_decode(int num_states, int num_arcs, int num_pdfs, int num_frames,
                      const int32_t* src, const int32_t* dst, const int32_t* pdf,
                      const float* weight, const int32_t* olabel,
                      const float* final_logw,
                      const float* loglikes,  // [T, P] row-major
                      float beam, int use_final,
                      int32_t* out_phones, int32_t* out_len, float* out_score) {
  if (num_states <= 0 || num_arcs <= 0 || num_frames <= 0) return 1;
  const int S = num_states, A = num_arcs, T = num_frames, P = num_pdfs;

  std::vector<double> tokens(S, kNegInf), next(S, kNegInf);
  tokens[0] = 0.0;
  std::vector<int32_t> backptr(static_cast<size_t>(T) * S, -1);

  for (int t = 0; t < T; ++t) {
    const float* ll = loglikes + static_cast<size_t>(t) * P;
    std::fill(next.begin(), next.end(), kNegInf);
    int32_t* bp = backptr.data() + static_cast<size_t>(t) * S;
    double best = kNegInf;
    for (int a = 0; a < A; ++a) {
      const double ts = tokens[src[a]];
      if (ts == kNegInf) continue;
      const double score = ts + weight[a] + ll[pdf[a]];
      const int d = dst[a];
      if (score > next[d]) {
        next[d] = score;
        bp[d] = a;
        if (score > best) best = score;
      }
    }
    if (best == kNegInf) return 2;  // all tokens died
    const double cutoff = best - beam;
    for (int s = 0; s < S; ++s)
      if (next[s] < cutoff) next[s] = kNegInf;
    tokens.swap(next);
  }

  // pick the best (optionally final-weighted) end state
  int best_state = -1;
  double best_score = kNegInf;
  for (int s = 0; s < S; ++s) {
    if (tokens[s] == kNegInf) continue;
    double sc = tokens[s];
    if (use_final) {
      if (final_logw[s] == kNegInf) continue;
      sc += final_logw[s];
    }
    if (sc > best_score) {
      best_score = sc;
      best_state = s;
    }
  }
  if (best_state < 0) {  // no reachable final state: fall back to best token
    for (int s = 0; s < S; ++s) {
      if (tokens[s] > best_score) {
        best_score = tokens[s];
        best_state = s;
      }
    }
  }
  if (best_state < 0) return 3;

  // backtrace, collecting output labels (phones)
  std::vector<int32_t> rev;
  rev.reserve(T);
  int state = best_state;
  for (int t = T - 1; t >= 0; --t) {
    const int32_t a = backptr[static_cast<size_t>(t) * S + state];
    if (a < 0) return 4;
    if (olabel[a] > 0) rev.push_back(olabel[a]);
    state = src[a];
  }
  const int n = static_cast<int>(rev.size());
  for (int i = 0; i < n; ++i) out_phones[i] = rev[n - 1 - i];
  *out_len = n;
  *out_score = static_cast<float>(best_score);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Active-token Viterbi: only states alive within the beam are expanded,
// with a Kaldi-style max_active cap (adaptive beam via nth-best cutoff)
// and a token-record lattice for traceback (memory O(total live tokens),
// not O(T * S)) -- the faster-decoder behavior HCLG-scale graphs need
// (kaldi/src/decoder/faster-decoder.cc).  Arcs must be SRC-sorted with
// CSR offsets [S+1]; olabel/weight/pdf/dst aligned with that order.
// ---------------------------------------------------------------------------

namespace {

struct Rec { int32_t state; int32_t arc; int32_t prev; };

// Record arc ids >= num_arcs encode eps arcs: arc - num_arcs indexes the
// eps arrays (the emitting/eps olabel split is resolved at backtrace).

static int viterbi_active_impl(
    int num_states, int num_arcs, int num_pdfs, int num_frames,
    const int32_t* offsets, const int32_t* dst, const int32_t* pdf,
    const float* weight, const int32_t* olabel, const float* final_logw,
    int num_eps, const int32_t* eps_src, const int32_t* eps_dst,
    const float* eps_w, const int32_t* eps_olabel,
    const float* loglikes, float beam, int max_active, int use_final,
    int out_capacity,
    int32_t* out_phones, int32_t* out_len, float* out_score) {
  if (num_states <= 0 || num_arcs <= 0 || num_frames <= 0) return 1;
  const int A = num_arcs, T = num_frames, P = num_pdfs;

  // Frontier tokens live in a COMPACT entry vector + an open-addressing
  // hash keyed by graph state (faster-decoder.cc's token hash): the
  // per-candidate random touch lands in a table sized to the frontier
  // (L2-resident) instead of S-sized dense arrays (~17 MB at the 2.6M-
  // arc stress graph, where every relaxation was a DRAM miss).  Token
  // records append per SURVIVOR after each frame settles — a wide beam's
  // transient improvements never grow the record vector.
  struct Ent { double score; int32_t state; int32_t arc; int32_t prev; };
  std::vector<Rec> recs;
  recs.reserve(1 << 16);
  std::vector<Ent> cur_ents, ents;
  cur_ents.reserve(1 << 12);
  ents.reserve(1 << 12);

  uint32_t cap = 1 << 13;  // buckets (power of two), grown on demand
  std::vector<int32_t> bkt(cap, -1), bstamp(cap, -1);
  int32_t fid = 0;  // hash epoch (per expansion phase)

  auto rehash = [&]() {
    cap <<= 1;
    bkt.assign(cap, -1);
    bstamp.assign(cap, fid);
    for (int32_t i = 0; i < static_cast<int32_t>(ents.size()); ++i) {
      uint32_t h = static_cast<uint32_t>(ents[i].state) * 2654435761u
                   & (cap - 1);
      while (bkt[h] >= 0) h = (h + 1) & (cap - 1);
      bkt[h] = i;
    }
  };
  // bucket slot for state d in the current epoch (insert position or the
  // existing entry's index)
  auto slot_of = [&](int32_t d) -> int32_t* {
    uint32_t h = static_cast<uint32_t>(d) * 2654435761u & (cap - 1);
    while (true) {
      if (bstamp[h] != fid) { bstamp[h] = fid; bkt[h] = -1; }
      int32_t ei = bkt[h];
      if (ei < 0 || ents[ei].state == d) return &bkt[h];
      h = (h + 1) & (cap - 1);
    }
  };

  cur_ents.push_back(Ent{0.0, 0, -1, -1});  // start token: no record

  // one exact level-ordered relaxation sweep of the eps arcs over the
  // hashed frontier (ents + current epoch); new states join ents.
  // Sources settle (materialize a record) on first use so within-frame
  // eps chains have a predecessor record to reference.
  constexpr int32_t kSettled = -2;
  auto settle = [&](Ent& e) -> int32_t {
    if (e.arc == kSettled) return e.prev;
    const int32_t r = static_cast<int32_t>(recs.size());
    recs.push_back(Rec{e.state, e.arc, e.prev});
    e.arc = kSettled;
    e.prev = r;
    return r;
  };
  auto relax_eps = [&](double& best) {
    for (int e = 0; e < num_eps; ++e) {
      const int32_t s = eps_src[e];
      int32_t* sp = slot_of(s);
      if (*sp < 0 || ents[*sp].score == kNegInf) continue;
      const double v = ents[*sp].score + eps_w[e];
      const int32_t d = eps_dst[e];
      const int32_t srec = settle(ents[*sp]);
      int32_t* dp = slot_of(d);
      if (*dp < 0) {
        *dp = static_cast<int32_t>(ents.size());
        ents.push_back(Ent{v, d, A + e, srec});
        if (v > best) best = v;
        if (ents.size() * 2 > cap) rehash();
      } else if (v > ents[*dp].score) {
        Ent& de = ents[*dp];
        de.score = v;
        de.arc = A + e;
        de.prev = srec;
        if (v > best) best = v;
      }
    }
  };

  if (num_eps) {  // initial closure from the start state
    // seed the hash with the start token so eps arcs can find it
    ents = cur_ents;
    ++fid;
    *slot_of(0) = 0;
    double best0 = 0.0;
    cur_ents[0].arc = kSettled;  // start already "settled" (no record)
    ents[0].arc = kSettled;
    relax_eps(best0);
    for (Ent& e : ents) settle(e);
    cur_ents = ents;
  }

  std::vector<double> cand;  // scratch for max_active cutoff
  // adaptive beam (faster-decoder.cc GetCutoff): when max_active binds,
  // the next frame expands with the tightened beam so candidates that
  // cannot survive are skipped before touching the hash
  const double beam_delta = 0.5;
  double beam_eff = beam;
  for (int t = 0; t < T; ++t) {
    const float* ll = loglikes + static_cast<size_t>(t) * P;
    double ll_max = kNegInf;
    for (int p = 0; p < P; ++p)
      if (ll[p] > ll_max) ll_max = ll[p];
    ents.clear();
    ++fid;
    double best = kNegInf;
    // expand the best token first so `best` is established before the
    // wide-fanout states enumerate (faster-decoder processes best-first)
    if (!cur_ents.empty()) {
      size_t bi = 0;
      for (size_t i = 1; i < cur_ents.size(); ++i)
        if (cur_ents[i].score > cur_ents[bi].score) bi = i;
      std::swap(cur_ents[0], cur_ents[bi]);
    }
    for (const Ent& e : cur_ents) {
      const double ts = e.score;
      const int32_t prev_rec = e.prev;  // settled: record id
      const int32_t s = e.state;
      for (int32_t a = offsets[s]; a < offsets[s + 1]; ++a) {
        // arcs are weight-DESCENDING within the block (_src_csr): once
        // even the frame-max emission cannot reach the cutoff, no later
        // arc of this state can either
        if (ts + weight[a] + ll_max <= best - beam_eff) break;
        const double sc = ts + weight[a] + ll[pdf[a]];
        if (sc <= best - beam_eff) continue;  // below any final cutoff
        const int32_t d = dst[a];
        int32_t* dp = slot_of(d);
        if (*dp < 0) {
          *dp = static_cast<int32_t>(ents.size());
          ents.push_back(Ent{sc, d, a, prev_rec});
          if (sc > best) best = sc;
          if (ents.size() * 2 > cap) rehash();
        } else if (sc > ents[*dp].score) {
          Ent& de = ents[*dp];
          de.score = sc;
          de.arc = a;
          de.prev = prev_rec;
          if (sc > best) best = sc;
        }
      }
    }
    if (ents.empty() || best == kNegInf) return 2;  // all tokens died
    if (num_eps) relax_eps(best);
    double cutoff = best - beam;
    if (max_active > 0 && static_cast<int>(ents.size()) > max_active) {
      cand.clear();
      for (const Ent& e : ents) cand.push_back(e.score);
      std::nth_element(cand.begin(), cand.begin() + (max_active - 1),
                       cand.end(), std::greater<double>());
      cutoff = std::max(cutoff, cand[max_active - 1]);
    }
    beam_eff = (cutoff > best - beam)
                   ? std::min(static_cast<double>(beam),
                              best - cutoff + beam_delta)
                   : beam;
    cur_ents.clear();
    for (Ent& e : ents) {
      if (e.score >= cutoff) {
        settle(e);
        cur_ents.push_back(e);
      }
    }
  }

  int32_t best_rec = -1;
  double best_score = kNegInf;
  bool have = false;
  for (int pass = 0; pass < 2 && !have; ++pass) {
    for (const Ent& e : cur_ents) {
      double sc = e.score;
      if (use_final && pass == 0) {
        if (final_logw[e.state] == kNegInf) continue;
        sc += final_logw[e.state];
      }
      if (sc > best_score) {
        best_score = sc;
        best_rec = e.prev;
        have = true;
      }
    }
  }
  if (!have) return 3;

  std::vector<int32_t> rev;
  rev.reserve(T);
  for (int32_t r = best_rec; r >= 0; r = recs[r].prev) {
    const int32_t a = recs[r].arc;
    const int32_t ol = a < A ? olabel[a] : eps_olabel[a - A];
    if (ol > 0) rev.push_back(ol);
  }
  const int n = static_cast<int>(rev.size());
  if (n > out_capacity) return 5;  // caller's label buffer too small
  for (int i = 0; i < n; ++i) out_phones[i] = rev[n - 1 - i];
  *out_len = n;
  *out_score = static_cast<float>(best_score);
  return 0;
}

}  // namespace

extern "C" {

int tt_viterbi_decode_active(
    int num_states, int num_arcs, int num_pdfs, int num_frames,
    const int32_t* offsets,  // [S+1] src-sorted CSR
    const int32_t* dst, const int32_t* pdf, const float* weight,
    const int32_t* olabel, const float* final_logw,
    const float* loglikes,  // [T, P] row-major
    float beam, int max_active, int use_final,
    int32_t* out_phones, int32_t* out_len, float* out_score) {
  return viterbi_active_impl(
      num_states, num_arcs, num_pdfs, num_frames, offsets, dst, pdf, weight,
      olabel, final_logw, 0, nullptr, nullptr, nullptr, nullptr, loglikes,
      beam, max_active, use_final, num_frames, out_phones, out_len,
      out_score);
}

// Eps-aware active-token Viterbi (real-HCLG best path).  `out_capacity`
// is the label-buffer size; a path can emit more than T labels when eps
// arcs carry words, so callers size it T + (T+1) * eps_levels and get
// error 5 if even that overflows.
int tt_viterbi_decode_eps(
    int num_states, int num_arcs, int num_pdfs, int num_frames,
    const int32_t* offsets, const int32_t* dst, const int32_t* pdf,
    const float* weight, const int32_t* olabel, const float* final_logw,
    int num_eps, const int32_t* eps_src, const int32_t* eps_dst,
    const float* eps_w, const int32_t* eps_olabel,
    const float* loglikes, float beam, int max_active, int use_final,
    int out_capacity,
    int32_t* out_phones, int32_t* out_len, float* out_score) {
  return viterbi_active_impl(
      num_states, num_arcs, num_pdfs, num_frames, offsets, dst, pdf, weight,
      olabel, final_logw, num_eps, eps_src, eps_dst, eps_w, eps_olabel,
      loglikes, beam, max_active, use_final, out_capacity, out_phones,
      out_len, out_score);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Active-token LATTICE generation (latgen-faster-mapped role: produce the
// pruned hypothesis graph at decode speed, kaldi/src/decoder/
// lattice-faster-decoder.cc).  Semantics match the numpy reference
// (torchain_tpu_torch/eval/lattice.py lattice_decode): the lattice is the
// time-unrolled subgraph of (frame, state) tokens within `beam` of each
// frame's Viterbi best (plus an optional max_active nth-best cutoff the
// numpy path doesn't have), arcs carrying (graph+acoustic, acoustic)
// two-component weights and graph output labels, frame-T survivors final.
// Eps arcs (when given) appear as zero-acoustic arcs between same-boundary
// lattice states, and each lattice state records its frame index
// (state_time, fetched separately) since the lattice is then no longer
// one-arc-per-frame.  Trimmed to reachable+coreachable states natively so
// Python receives a connected lattice.  Two-call ABI: decode -> counts +
// opaque handle, fetch -> arrays, free.
// ---------------------------------------------------------------------------

namespace {

struct TtLattice {
  int32_t num_states = 0;
  std::vector<int32_t> arc_src, arc_dst, arc_olabel;
  std::vector<float> arc_w, arc_am;
  std::vector<int32_t> final_state;
  std::vector<float> final_w;
  std::vector<int32_t> state_time;
};

static void* lattice_impl(
    int num_states, int num_arcs, int num_pdfs, int num_frames,
    const int32_t* offsets, const int32_t* dst, const int32_t* pdf,
    const float* weight, const int32_t* olabel, const float* final_logw,
    // dst-sorted view for the TRANSPOSED emission pass (in-arc CSR):
    // survivors' in-arcs avoid re-enumerating the 20k+-fanout LM hub
    // states' out-arc blocks a second time
    const int32_t* dofs, const int32_t* dsrc, const int32_t* dpdf,
    const float* dweight, const int32_t* dolabel,
    int num_eps, const int32_t* eps_src, const int32_t* eps_dst,
    const float* eps_w, const int32_t* eps_olabel,
    const float* loglikes,  // [T, P] row-major
    float beam, int max_active, int use_final,
    int32_t* out_num_states, int32_t* out_num_arcs, int32_t* out_num_finals,
    int32_t* err) {
  *err = 0;
  if (num_states <= 0 || num_arcs <= 0 || num_frames <= 0) { *err = 1; return nullptr; }
  const int S = num_states, T = num_frames, P = num_pdfs;
  const bool dbg = getenv("TT_DEBUG") != nullptr;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto t_start = now();

  // forward pass: per-frame-boundary active token lists + scores (kept for
  // all boundaries -- O(total live tokens), the lattice needs them anyway)
  std::vector<std::vector<int32_t>> frame_active(T + 1);
  // per-boundary survivor degree sums, accumulated as the lists are
  // built — the emission pass picks its enumeration direction from these
  // without re-walking both frontiers every boundary
  std::vector<int64_t> bdeg_out(T + 1, 0), bdeg_in(T + 1, 0);
  // one 16-byte slot per state (score + stamp): one cache line per
  // random d-indexed touch — see viterbi_active_impl.  The S-sized token
  // tables persist across calls (thread_local) with EPOCH-offset stamps,
  // so a fresh utterance pays no multi-MB allocate+memset (~3 ms/call at
  // 740k states); stamps from earlier utterances can never collide with
  // this call's epoch+t values, and the tables re-init only on growth or
  // epoch wrap.
  struct LSlot { double score; int32_t stamp; int32_t pad; };
  static thread_local std::vector<LSlot> tls_cur, tls_nxt;
  static thread_local int32_t tls_epoch = 0;
  if (static_cast<int>(tls_cur.size()) < S ||
      tls_epoch > INT32_MAX - (T + 2)) {
    tls_cur.assign(S, LSlot{kNegInf, -1, 0});
    tls_nxt.assign(S, LSlot{kNegInf, -1, 0});
    tls_epoch = 0;
  }
  const int32_t ep = tls_epoch;
  tls_epoch += T + 1;
  std::vector<LSlot>& cur = tls_cur;
  std::vector<LSlot>& nxt = tls_nxt;
  std::vector<int32_t> nactive;
  frame_active[0].push_back(0);
  cur[0].score = 0.0;
  cur[0].stamp = ep;

  // relax the (level-sorted) eps arcs over a stamped frontier in place
  auto relax_eps = [&](std::vector<LSlot>& sl, std::vector<int32_t>& act,
                       int32_t sval, double& best) {
    for (int e = 0; e < num_eps; ++e) {
      const int32_t s = eps_src[e];
      if (sl[s].stamp != sval || sl[s].score == kNegInf) continue;
      const double v = sl[s].score + eps_w[e];
      const int32_t d = eps_dst[e];
      LSlot& ds = sl[d];
      if (ds.stamp != sval) {
        ds.stamp = sval;
        ds.score = kNegInf;
        act.push_back(d);
      }
      if (v > ds.score) {
        ds.score = v;
        if (v > best) best = v;
      }
    }
  };

  if (num_eps) {  // initial closure from the start state (stamp ep on cur)
    double best0 = 0.0;
    relax_eps(cur, frame_active[0], ep, best0);
  }
  // boundary-0 degree sums (frame_active[0] is final after the initial
  // eps closure; the emission thread consumes them immediately)
  for (int32_t s : frame_active[0])
    bdeg_out[0] += offsets[s + 1] - offsets[s];

  // ---- lattice emission (PIPELINED consumer) ------------------------------
  // Emission for boundary t only needs frame_active[t], frame_active[t+1]
  // and the degree sums — all finalized when the forward search publishes
  // boundary t+1 — so it trails the search on a second thread and the
  // utterance wall time is ~max(search, emission) instead of their sum
  // (tools/profile_stress_decode.py: ~16 + ~19 ms per 15 s utterance on
  // the million-arc stress graph).  All emission-side state (lattice ids,
  // bstamp, bitsets, the TtLattice vectors) is touched by the consumer
  // only; the producer's frame_active/bdeg writes are published with a
  // release store and read with an acquire load.  TT_NO_PIPELINE=1 runs
  // the identical loop inline after the search (debug / core-pinned
  // environments).
  //
  // Per boundary: enumerate the cheaper direction (the LM hub states
  // have 20k+ OUT-arcs, frequent words' entry states large IN-degrees;
  // both walks produce exactly the arcs between survivors).  The hot
  // test is one random membership probe per CANDIDATE arc (~2-3M per
  // utterance, ~5% hit rate), so membership lives in one-bit-per-state
  // sets (~92 KB at 740k states — L2-resident where the int32 stamp
  // array they replaced thrashed); bits are set/cleared by walking the
  // small survivor lists, never the whole table.  Lattice ids are per
  // (boundary, state); a state alive in consecutive boundaries keeps two
  // distinct ids, as the time-unrolled lattice requires.
  auto lat = new TtLattice();
  // emission scratch persists across calls too (allocated on the caller
  // thread, used by the consumer): the lid tables are written before any
  // read on every path, so stale values are harmless; bstamp gets the
  // same epoch treatment as the token stamps
  static thread_local std::vector<int32_t> tls_bstamp, tls_cur_lid,
      tls_nxt_lid;
  static thread_local int32_t tls_bepoch = 0;
  if (static_cast<int>(tls_bstamp.size()) < S ||
      tls_bepoch > INT32_MAX - (T + 2)) {
    tls_bstamp.assign(S, -1);
    tls_cur_lid.resize(S);
    tls_nxt_lid.resize(S);
    tls_bepoch = 0;
  }
  const int32_t bep = tls_bepoch;
  tls_bepoch += T + 1;
  std::vector<int32_t>& bstamp = tls_bstamp;
  std::vector<int32_t>& cur_lid = tls_cur_lid;
  std::vector<int32_t>& nxt_lid = tls_nxt_lid;
  for (int32_t s : frame_active[0]) {  // state 0 first -> lattice state 0
    bstamp[s] = bep;
    cur_lid[s] = lat->num_states++;
    lat->state_time.push_back(0);
  }
  auto emit_eps = [&](int32_t boundary, const std::vector<int32_t>& lid_s,
                      const std::vector<int32_t>& lid_d) {
    for (int e = 0; e < num_eps; ++e) {
      const int32_t s = eps_src[e], d = eps_dst[e];
      if (bstamp[s] != boundary || bstamp[d] != boundary) continue;
      lat->arc_src.push_back(lid_s[s]);
      lat->arc_dst.push_back(lid_d[d]);
      lat->arc_olabel.push_back(eps_olabel[e]);
      lat->arc_w.push_back(eps_w[e]);
      lat->arc_am.push_back(0.0f);
    }
  };
  if (num_eps) emit_eps(bep, cur_lid, cur_lid);
  const size_t BW = (static_cast<size_t>(S) + 63) / 64;
  static thread_local std::vector<uint64_t> tls_cur_live, tls_nxt_live;
  tls_cur_live.assign(BW, 0);  // ~92 KB at 740k states: cheap to re-zero
  tls_nxt_live.assign(BW, 0);
  std::vector<uint64_t>& cur_live = tls_cur_live;
  std::vector<uint64_t>& nxt_live = tls_nxt_live;
  auto bit_set = [](std::vector<uint64_t>& b, int32_t s) {
    b[static_cast<size_t>(s) >> 6] |= (1ULL << (s & 63));
  };
  auto bit_test = [](const std::vector<uint64_t>& b, int32_t s) {
    return (b[static_cast<size_t>(s) >> 6] >> (s & 63)) & 1ULL;
  };
  auto bit_clear = [](std::vector<uint64_t>& b, int32_t s) {
    b[static_cast<size_t>(s) >> 6] &= ~(1ULL << (s & 63));
  };
  for (int32_t s : frame_active[0]) bit_set(cur_live, s);

  auto emit_boundary = [&](int t) {
    const float* ll = loglikes + static_cast<size_t>(t) * P;
    for (int32_t s : frame_active[t + 1]) {
      bstamp[s] = bep + t + 1;
      nxt_lid[s] = lat->num_states++;
      lat->state_time.push_back(t + 1);
      bit_set(nxt_live, s);
    }
    const int64_t cost_fwd = bdeg_out[t], cost_bwd = bdeg_in[t + 1];
    if (cost_bwd <= cost_fwd) {
      const auto& fn = frame_active[t + 1];
      for (size_t di = 0; di < fn.size(); ++di) {
        const int32_t d = fn[di];
        if (di + 1 < fn.size())  // next survivor's arc block head
          __builtin_prefetch(&dsrc[dofs[fn[di + 1]]], 0, 1);
        const int32_t did = nxt_lid[d];
        const int32_t lo = dofs[d], hi = dofs[d + 1];
        for (int32_t a = lo; a < hi; ++a) {
          const int32_t s2 = dsrc[a];
          if (!bit_test(cur_live, s2)) continue;
          const double am = ll[dpdf[a]];
          lat->arc_src.push_back(cur_lid[s2]);
          lat->arc_dst.push_back(did);
          lat->arc_olabel.push_back(dolabel[a]);
          lat->arc_w.push_back(static_cast<float>(dweight[a] + am));
          lat->arc_am.push_back(static_cast<float>(am));
        }
      }
    } else {
      const auto& fc = frame_active[t];
      for (size_t si = 0; si < fc.size(); ++si) {
        const int32_t s2 = fc[si];
        if (si + 1 < fc.size())
          __builtin_prefetch(&dst[offsets[fc[si + 1]]], 0, 1);
        const int32_t sid = cur_lid[s2];
        const int32_t lo = offsets[s2], hi = offsets[s2 + 1];
        for (int32_t a = lo; a < hi; ++a) {
          const int32_t d = dst[a];
          if (!bit_test(nxt_live, d)) continue;
          const double am = ll[pdf[a]];
          lat->arc_src.push_back(sid);
          lat->arc_dst.push_back(nxt_lid[d]);
          lat->arc_olabel.push_back(olabel[a]);
          lat->arc_w.push_back(static_cast<float>(weight[a] + am));
          lat->arc_am.push_back(static_cast<float>(am));
        }
      }
    }
    if (num_eps) emit_eps(bep + t + 1, nxt_lid, nxt_lid);
    for (int32_t s : frame_active[t]) bit_clear(cur_live, s);
    std::swap(cur_live, nxt_live);
    std::swap(cur_lid, nxt_lid);
  };

  std::atomic<int32_t> fwd_ready{0};
  std::atomic<bool> fwd_dead{false};
  auto emit_all = [&] {
    for (int t = 0; t < T; ++t) {
      while (fwd_ready.load(std::memory_order_acquire) < t + 1) {
        if (fwd_dead.load(std::memory_order_relaxed)) return;
        std::this_thread::yield();
      }
      emit_boundary(t);
    }
  };
  const bool pipelined = getenv("TT_NO_PIPELINE") == nullptr;
  std::thread emitter;
  if (pipelined) emitter = std::thread(emit_all);
  auto fail_fwd = [&] {
    fwd_dead.store(true, std::memory_order_relaxed);
    if (emitter.joinable()) emitter.join();
    delete lat;
  };

  std::vector<double> cand;
  const double beam_delta = 0.5;  // adaptive beam; see viterbi_active_impl
  double beam_eff = beam;
  for (int t = 0; t < T; ++t) {
    const float* ll = loglikes + static_cast<size_t>(t) * P;
    double ll_max = kNegInf;
    for (int p = 0; p < P; ++p)
      if (ll[p] > ll_max) ll_max = ll[p];
    nactive.clear();
    double best = kNegInf;
    // expand the best token first so `best` is established before the
    // wide-fanout states enumerate — WITHOUT reordering frame_active
    // (the emission pass replays it and state 0 must stay first at t=0)
    const auto& fa = frame_active[t];
    size_t bi = 0;
    for (size_t i = 1; i < fa.size(); ++i)
      if (cur[fa[i]].score > cur[fa[bi]].score) bi = i;
    for (size_t ii = 0; ii < fa.size(); ++ii) {
      const int32_t s = ii == 0 ? fa[bi] : (ii == bi ? fa[0] : fa[ii]);
      if (ii + 1 < fa.size()) {  // next state's arc block head
        const int32_t sn = fa[ii + 1];
        __builtin_prefetch(&weight[offsets[sn]], 0, 1);
        __builtin_prefetch(&dst[offsets[sn]], 0, 1);
      }
      const double ts = cur[s].score;
      const int32_t a_hi = offsets[s + 1];
      for (int32_t a = offsets[s]; a < a_hi; ++a) {
        // weight-descending arc blocks (_src_csr): break when even the
        // frame-max emission cannot reach the cutoff
        if (ts + weight[a] + ll_max <= best - beam_eff) break;
        if (a + 8 < a_hi)  // hide the random token-slot touch latency
          __builtin_prefetch(&nxt[dst[a + 8]], 1, 1);
        const double sc = ts + weight[a] + ll[pdf[a]];
        if (sc <= best - beam_eff) continue;
        const int32_t d = dst[a];
        LSlot& ds = nxt[d];
        if (ds.stamp != ep + 1 + t) {
          ds.stamp = ep + 1 + t;
          ds.score = kNegInf;
          nactive.push_back(d);
        }
        if (sc > ds.score) {
          ds.score = sc;
          if (sc > best) best = sc;
        }
      }
    }
    if (nactive.empty() || best == kNegInf) {
      *err = 2;
      fail_fwd();
      return nullptr;
    }
    if (num_eps) relax_eps(nxt, nactive, ep + 1 + t, best);
    double cutoff = best - beam;
    if (max_active > 0 && static_cast<int>(nactive.size()) > max_active) {
      cand.clear();
      for (int32_t s : nactive) cand.push_back(nxt[s].score);
      std::nth_element(cand.begin(), cand.begin() + (max_active - 1),
                       cand.end(), std::greater<double>());
      cutoff = std::max(cutoff, cand[max_active - 1]);
    }
    beam_eff = (cutoff > best - beam)
                   ? std::min(static_cast<double>(beam),
                              best - cutoff + beam_delta)
                   : beam;
    auto& act = frame_active[t + 1];
    for (int32_t s : nactive) {
      if (nxt[s].score >= cutoff) {
        act.push_back(s);
        bdeg_out[t + 1] += offsets[s + 1] - offsets[s];
        bdeg_in[t + 1] += dofs[s + 1] - dofs[s];
      }
    }
    fwd_ready.store(t + 1, std::memory_order_release);
    std::swap(cur, nxt);
  }

  auto t_fwd = now();
  if (pipelined) emitter.join(); else emit_all();

  // finals: frame-T survivors; graph final weights if any reachable,
  // else weight-0 fallback (numpy lattice_decode's exact behavior)
  bool any_final = false;
  if (use_final) {
    for (int32_t s : frame_active[T])
      if (final_logw[s] != kNegInf) { any_final = true; break; }
  }
  for (int32_t s : frame_active[T]) {
    if (use_final && any_final) {
      if (final_logw[s] == kNegInf) continue;
      lat->final_state.push_back(cur_lid[s]);
      lat->final_w.push_back(final_logw[s]);
    } else {
      lat->final_state.push_back(cur_lid[s]);
      lat->final_w.push_back(0.0f);
    }
  }
  if (lat->final_state.empty()) { delete lat; *err = 3; return nullptr; }

  auto t_emit = now();
  // trim: keep states reachable from 0 AND co-reachable from a final.
  // Arcs were emitted in boundary order with all same-boundary eps arcs in
  // level order, so one forward and one reverse sweep over the arc list
  // settle both reachabilities.
  const int32_t L = lat->num_states;
  const size_t NA = lat->arc_src.size();
  std::vector<uint8_t> reach(L, 0), coreach(L, 0);
  reach[0] = 1;
  for (size_t i = 0; i < NA; ++i)
    if (reach[lat->arc_src[i]]) reach[lat->arc_dst[i]] = 1;
  for (size_t i = 0; i < lat->final_state.size(); ++i)
    coreach[lat->final_state[i]] = 1;
  for (size_t i = NA; i-- > 0;)
    if (coreach[lat->arc_dst[i]]) coreach[lat->arc_src[i]] = 1;
  std::vector<int32_t> remap(L, -1);
  int32_t nkeep = 0;
  for (int32_t s = 0; s < L; ++s)
    if (reach[s] && coreach[s]) remap[s] = nkeep++;
  if (remap[0] != 0) { delete lat; *err = 3; return nullptr; }
  size_t na_keep = 0;
  for (size_t i = 0; i < NA; ++i) {
    const int32_t s = remap[lat->arc_src[i]], d = remap[lat->arc_dst[i]];
    if (s < 0 || d < 0) continue;
    lat->arc_src[na_keep] = s;
    lat->arc_dst[na_keep] = d;
    lat->arc_olabel[na_keep] = lat->arc_olabel[i];
    lat->arc_w[na_keep] = lat->arc_w[i];
    lat->arc_am[na_keep] = lat->arc_am[i];
    ++na_keep;
  }
  lat->arc_src.resize(na_keep);
  lat->arc_dst.resize(na_keep);
  lat->arc_olabel.resize(na_keep);
  lat->arc_w.resize(na_keep);
  lat->arc_am.resize(na_keep);
  size_t nf_keep = 0;
  for (size_t i = 0; i < lat->final_state.size(); ++i) {
    const int32_t s = remap[lat->final_state[i]];
    if (s < 0) continue;
    lat->final_state[nf_keep] = s;
    lat->final_w[nf_keep] = lat->final_w[i];
    ++nf_keep;
  }
  lat->final_state.resize(nf_keep);
  lat->final_w.resize(nf_keep);
  for (int32_t s = 0; s < L; ++s)
    if (remap[s] >= 0) lat->state_time[remap[s]] = lat->state_time[s];
  lat->state_time.resize(nkeep);
  lat->num_states = nkeep;

  *out_num_states = lat->num_states;
  *out_num_arcs = static_cast<int32_t>(na_keep);
  *out_num_finals = static_cast<int32_t>(nf_keep);
  if (dbg) {
    auto ms = [](auto a, auto b) {
      return std::chrono::duration<double, std::milli>(b - a).count();
    };
    auto t_end = std::chrono::steady_clock::now();
    int64_t enum_cost = 0;
    for (int t = 0; t < T; ++t)
      enum_cost += std::min(bdeg_out[t], bdeg_in[t + 1]);
    fprintf(stderr,
            "[lat] fwd=%.1fms emit=%.1fms trim=%.1fms pre_trim=%d/%zu "
            "kept=%d/%zu enum=%lld\n",
            ms(t_start, t_fwd), ms(t_fwd, t_emit), ms(t_emit, t_end),
            L, NA, lat->num_states, lat->arc_src.size(),
            static_cast<long long>(enum_cost));
  }
  return lat;
}

}  // namespace

extern "C" {

// Returns an opaque handle (free with tt_lattice_free) or nullptr on
// failure (*err receives a nonzero code).  Arcs are SRC-sorted CSR as in
// tt_viterbi_decode_active.
void* tt_lattice_decode(
    int num_states, int num_arcs, int num_pdfs, int num_frames,
    const int32_t* offsets, const int32_t* dst, const int32_t* pdf,
    const float* weight, const int32_t* olabel, const float* final_logw,
    const int32_t* dofs, const int32_t* dsrc, const int32_t* dpdf,
    const float* dweight, const int32_t* dolabel,
    const float* loglikes,  // [T, P] row-major
    float beam, int max_active, int use_final,
    int32_t* out_num_states, int32_t* out_num_arcs, int32_t* out_num_finals,
    int32_t* err) {
  return lattice_impl(
      num_states, num_arcs, num_pdfs, num_frames, offsets, dst, pdf, weight,
      olabel, final_logw, dofs, dsrc, dpdf, dweight, dolabel, 0, nullptr,
      nullptr, nullptr, nullptr, loglikes,
      beam, max_active, use_final, out_num_states, out_num_arcs,
      out_num_finals, err);
}

// Eps-aware lattice generation (real-HCLG latgen).  Fetch state times with
// tt_lattice_fetch_times after the ordinary tt_lattice_fetch.
void* tt_lattice_decode_eps(
    int num_states, int num_arcs, int num_pdfs, int num_frames,
    const int32_t* offsets, const int32_t* dst, const int32_t* pdf,
    const float* weight, const int32_t* olabel, const float* final_logw,
    const int32_t* dofs, const int32_t* dsrc, const int32_t* dpdf,
    const float* dweight, const int32_t* dolabel,
    int num_eps, const int32_t* eps_src, const int32_t* eps_dst,
    const float* eps_w, const int32_t* eps_olabel,
    const float* loglikes, float beam, int max_active, int use_final,
    int32_t* out_num_states, int32_t* out_num_arcs, int32_t* out_num_finals,
    int32_t* err) {
  return lattice_impl(
      num_states, num_arcs, num_pdfs, num_frames, offsets, dst, pdf, weight,
      olabel, final_logw, dofs, dsrc, dpdf, dweight, dolabel, num_eps,
      eps_src, eps_dst, eps_w, eps_olabel,
      loglikes, beam, max_active, use_final, out_num_states, out_num_arcs,
      out_num_finals, err);
}

int tt_lattice_fetch(void* handle, int32_t* arc_src, int32_t* arc_dst,
                     int32_t* arc_olabel, float* arc_w, float* arc_am,
                     int32_t* final_state, float* final_w) {
  if (!handle) return 1;
  auto* lat = static_cast<TtLattice*>(handle);
  const size_t NA = lat->arc_src.size(), NF = lat->final_state.size();
  std::memcpy(arc_src, lat->arc_src.data(), NA * sizeof(int32_t));
  std::memcpy(arc_dst, lat->arc_dst.data(), NA * sizeof(int32_t));
  std::memcpy(arc_olabel, lat->arc_olabel.data(), NA * sizeof(int32_t));
  std::memcpy(arc_w, lat->arc_w.data(), NA * sizeof(float));
  std::memcpy(arc_am, lat->arc_am.data(), NA * sizeof(float));
  std::memcpy(final_state, lat->final_state.data(), NF * sizeof(int32_t));
  std::memcpy(final_w, lat->final_w.data(), NF * sizeof(float));
  return 0;
}

// Frame index of each lattice state ([num_states] int32) — meaningful for
// eps lattices, whose arcs are no longer one-per-frame.
int tt_lattice_fetch_times(void* handle, int32_t* state_time) {
  if (!handle) return 1;
  auto* lat = static_cast<TtLattice*>(handle);
  std::memcpy(state_time, lat->state_time.data(),
              lat->state_time.size() * sizeof(int32_t));
  return 0;
}

void tt_lattice_free(void* handle) {
  delete static_cast<TtLattice*>(handle);
}

// Tropical best path over a lattice given as raw arc arrays in
// TOPOLOGICAL arc order — exactly what lattice_impl emits (boundary-
// ascending, eps arcs level-ordered within each boundary; the trim
// compaction preserves order).  The walk mirrors
// eval/lattice._best_path_arrays: from state 0, follow the arc with the
// smallest |fwd + w + bwd(dst) - score| residual (arc-id order tiebreak),
// stopping when a final weight's residual is at least as good.  Writes
// the >0 output labels of the path; returns their count, or
// -1 if out_capacity is too small, -2 if the walk strands (not a trimmed
// acyclic lattice).  out_score receives bwd[0] (the best path score).
int tt_lattice_arrays_best_path(
    int32_t num_states, int32_t num_arcs,
    const int32_t* src, const int32_t* dst, const int32_t* olabel,
    const float* w,
    int32_t num_finals, const int32_t* fin_s, const float* fin_w,
    int32_t* out_labels, int32_t out_capacity, double* out_score) {
  const int32_t L = num_states;
  const int32_t NA = num_arcs;
  if (L <= 0) return -2;
  std::vector<double> fwd(L, kNegInf), bwd(L, kNegInf);
  fwd[0] = 0.0;
  for (int32_t i = 0; i < NA; ++i) {
    const double v = fwd[src[i]];
    if (v == kNegInf) continue;
    const double c = v + w[i];
    if (c > fwd[dst[i]]) fwd[dst[i]] = c;
  }
  std::vector<uint8_t> isfin(L, 0);
  std::vector<double> finw(L, kNegInf);
  for (int32_t i = 0; i < num_finals; ++i) {
    isfin[fin_s[i]] = 1;
    finw[fin_s[i]] = fin_w[i];
    bwd[fin_s[i]] = fin_w[i];
  }
  for (int32_t i = NA; i-- > 0;) {
    const double v = bwd[dst[i]];
    if (v == kNegInf) continue;
    const double c = v + w[i];
    if (c > bwd[src[i]]) bwd[src[i]] = c;
  }
  const double score = bwd[0];
  *out_score = score;
  // per-source CSR over the lattice arcs (stable counting sort keeps
  // arc-id order within a state, matching the numpy walk's tiebreak)
  std::vector<int32_t> offs(L + 1, 0), order(NA);
  for (int32_t i = 0; i < NA; ++i) ++offs[src[i] + 1];
  for (int32_t s = 0; s < L; ++s) offs[s + 1] += offs[s];
  {
    std::vector<int32_t> fill(offs.begin(), offs.end() - 1);
    for (int32_t i = 0; i < NA; ++i) order[fill[src[i]]++] = i;
  }
  int32_t s = 0, n_out = 0, steps = 0;
  while (true) {
    double best_r = std::numeric_limits<double>::infinity();
    int32_t ai = -1;
    for (int32_t k = offs[s]; k < offs[s + 1]; ++k) {
      const int32_t a = order[k];
      const double r = std::abs(fwd[s] + w[a] + bwd[dst[a]] - score);
      if (r < best_r) { best_r = r; ai = a; }
    }
    const double fin = isfin[s]
        ? std::abs(fwd[s] + finw[s] - score)
        : std::numeric_limits<double>::infinity();
    if (fin <= best_r) break;
    if (ai < 0 || steps > L) return -2;
    if (olabel[ai] > 0) {
      if (n_out >= out_capacity) return -1;
      out_labels[n_out++] = olabel[ai];
    }
    s = dst[ai];
    ++steps;
  }
  return n_out;
}

}  // extern "C"
