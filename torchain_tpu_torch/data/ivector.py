"""iVector speaker-adaptation features (Kaldi src/ivector role); a host
NumPy copy of torchain_tpu/data/ivector.py (float64, the same numbers;
one change: each extractor computes its [G, D, D] quadratic terms once,
where the JAX module recomputed them for every utterance, ~90% of the
extraction time at 100 dims and 32 Gaussians).

Behavioral reference: Kaldi's diagonal UBM + iVector extractor used by
every online chain recipe (``[K] kaldi/src/gmm/diag-gmm.{h,cc}``,
``[K] kaldi/src/ivector/ivector-extractor.{h,cc}``, driven by
``steps/online/nnet2/{train_diag_ubm,train_ivector_extractor,
extract_ivectors_online}.sh``).  The model: frame x_t drawn from mixture
component i has mean ``mu_i + M_i w`` where ``w`` (the iVector) is shared
across the utterance with prior N(0, I).  Per-utterance posterior:

    L = I + sum_i gamma_i  M_i^T Sigma_i^-1 M_i      (precision)
    b =     sum_i M_i^T Sigma_i^-1 (f_i - gamma_i mu_i)
    w_hat = L^-1 b

with zeroth/first-order stats gamma_i = sum_t p(i|x_t),
f_i = sum_t p(i|x_t) x_t.  The extractor is trained by EM on those stats.

Design notes (deliberate deviations from Kaldi, not omissions):

* Kaldi prunes each frame to its top ``num_gselect`` Gaussians before
  accumulating stats — a sparse-compute trick for 2013 CPUs.  Here the
  per-frame log-likelihood of ALL Gaussians is one augmented matmul
  ``[T, 2F+1] @ [2F+1, G]`` (dense), so no pruning.
* Kaldi re-estimates the extractor's per-Gaussian variances and folds a
  prior offset into w's first coordinate.  We keep the UBM's variances
  (a documented Kaldi option) and realize the prior-offset role as an
  explicit global iVector mean subtracted at extraction time.
* Everything is float64 numpy on the host: this is data-preparation code
  (the loader side of the house, like Kaldi's), not training-step code;
  the extracted iVectors feed the device via data.append_ivectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "DiagUbm",
    "IvectorExtractor",
    "train_diag_ubm",
    "train_ivector_extractor",
    "extract_ivector",
    "extract_ivectors_online",
    "append_corpus_ivectors",
]

_LOG_2PI = float(np.log(2.0 * np.pi))
_VAR_FLOOR = 1e-4


@dataclasses.dataclass(frozen=True)
class DiagUbm:
    """Diagonal-covariance GMM ([K] diag-gmm.h role)."""

    weights: np.ndarray  # [G]
    means: np.ndarray  # [G, F]
    vars: np.ndarray  # [G, F]

    @property
    def num_gauss(self) -> int:
        return self.weights.shape[0]

    @property
    def feat_dim(self) -> int:
        return self.means.shape[1]

    def log_likes(self, feats: np.ndarray) -> np.ndarray:
        """[T, G] per-frame per-Gaussian log-likelihood, as one augmented
        matmul: ll = x^2 . (-1/(2s)) + x . (m/s) + const_g."""
        inv_var = 1.0 / self.vars
        const = (
            np.log(self.weights)
            - 0.5
            * (
                self.feat_dim * _LOG_2PI
                + np.log(self.vars).sum(axis=1)
                + (self.means**2 * inv_var).sum(axis=1)
            )
        )  # [G]
        return (
            feats**2 @ (-0.5 * inv_var).T + feats @ (self.means * inv_var).T + const
        )

    def posteriors(self, feats: np.ndarray) -> np.ndarray:
        """[T, G] frame responsibilities p(i | x_t)."""
        ll = self.log_likes(feats)
        ll -= ll.max(axis=1, keepdims=True)
        p = np.exp(ll)
        return p / p.sum(axis=1, keepdims=True)


def train_diag_ubm(
    feats: np.ndarray,
    num_gauss: int,
    num_iters: int = 10,
    seed: int = 0,
) -> DiagUbm:
    """EM-train a diagonal UBM on pooled frames [N, F].

    Initialization follows Kaldi's gmm-global-init-from-feats strategy in
    spirit: start from the global Gaussian and distinct sampled frames as
    means, then full EM iterations (binary splitting is an optimization
    for huge G that small-G chain recipes don't need)."""
    feats = np.asarray(feats, np.float64)
    n, f = feats.shape
    if n < num_gauss:
        raise ValueError(f"need >= {num_gauss} frames, got {n}")
    rng = np.random.default_rng(seed)
    global_var = feats.var(axis=0) + _VAR_FLOOR
    # k-means init (hard Lloyd iterations) before EM: starting EM from a
    # single broad covariance makes early responsibilities near-uniform
    # and collapses the means; Kaldi avoids the same trap by interleaving
    # binary splits with EM (gmm-global-init-from-feats)
    x2 = (feats**2).sum(axis=1, keepdims=True)  # [N, 1]
    # k-means++ seeding: far-apart starting means avoid the merged-cluster
    # local optima that uniform frame sampling falls into
    means = np.empty((num_gauss, f))
    means[0] = feats[rng.integers(n)]
    best_d2 = np.full(n, np.inf)
    for i in range(1, num_gauss):
        d2_new = ((feats - means[i - 1]) ** 2).sum(axis=1)
        best_d2 = np.minimum(best_d2, d2_new)
        p = best_d2 / best_d2.sum()
        means[i] = feats[rng.choice(n, p=p)]
    for _ in range(10):
        d2 = x2 - 2.0 * feats @ means.T + (means**2).sum(axis=1)  # [N, G]
        assign = d2.argmin(axis=1)
        for i in range(num_gauss):
            sel = assign == i
            if sel.any():
                means[i] = feats[sel].mean(axis=0)
            else:
                means[i] = feats[rng.integers(n)]
    vars0 = np.tile(global_var, (num_gauss, 1))
    for i in range(num_gauss):
        sel = assign == i
        if sel.sum() > 1:
            vars0[i] = np.maximum(feats[sel].var(axis=0), _VAR_FLOOR)
    counts = np.bincount(assign, minlength=num_gauss).astype(np.float64)
    ubm = DiagUbm(
        weights=np.maximum(counts, 1.0) / np.maximum(counts, 1.0).sum(),
        means=means,
        vars=vars0,
    )
    for _ in range(num_iters):
        post = ubm.posteriors(feats)  # [N, G]
        gamma = post.sum(axis=0)  # [G]
        gamma_safe = np.maximum(gamma, 1e-10)
        new_means = (post.T @ feats) / gamma_safe[:, None]
        ex2 = (post.T @ (feats**2)) / gamma_safe[:, None]
        new_vars = np.maximum(ex2 - new_means**2, _VAR_FLOOR)
        # empty components re-seeded from random frames (Kaldi re-splits)
        dead = gamma < 1e-8
        if dead.any():
            new_means[dead] = feats[rng.choice(n, size=int(dead.sum()))]
            new_vars[dead] = global_var
            gamma[dead] = gamma.sum() / max(num_gauss, 1) * 1e-3
        ubm = DiagUbm(
            weights=gamma / gamma.sum(), means=new_means, vars=new_vars
        )
    return ubm


@dataclasses.dataclass(frozen=True)
class IvectorExtractor:
    """Total-variability model ([K] ivector-extractor.h role)."""

    ubm: DiagUbm
    m: np.ndarray  # [G, F, D] per-Gaussian total-variability matrices
    mean_offset: np.ndarray  # [D] global iVector mean (prior-offset role)

    @property
    def ivector_dim(self) -> int:
        return self.m.shape[2]

    def _quad_terms(self) -> np.ndarray:
        """[G, D, D] U_i = M_i^T Sigma_i^-1 M_i, computed once per extractor
        (the JAX package recomputes it per utterance; the same arithmetic,
        so the same bits).  Training makes a new extractor after each
        update of `m`, so a kept value is never stale where it is read."""
        quad = self.__dict__.get("_quad")
        if quad is None:
            inv_var = 1.0 / self.ubm.vars  # [G, F]
            quad = np.einsum("gfd,gf,gfe->gde", self.m, inv_var, self.m)
            object.__setattr__(self, "_quad", quad)
        return quad

    def stats(self, feats: np.ndarray):
        """Zeroth/first-order sufficient stats of one utterance."""
        post = self.ubm.posteriors(np.asarray(feats, np.float64))
        gamma = post.sum(axis=0)  # [G]
        first = post.T @ feats  # [G, F]
        return gamma, first

    def solve(self, gamma: np.ndarray, first: np.ndarray, quad=None):
        """Posterior-mean iVector and its precision from stats."""
        d = self.ivector_dim
        quad = self._quad_terms() if quad is None else quad
        prec = np.eye(d) + np.einsum("g,gde->de", gamma, quad)
        resid = first - gamma[:, None] * self.ubm.means  # [G, F]
        lin = np.einsum("gfd,gf,gf->d", self.m, 1.0 / self.ubm.vars, resid)
        return np.linalg.solve(prec, lin), prec


def train_ivector_extractor(
    ubm: DiagUbm,
    utterances: list[np.ndarray],
    ivector_dim: int,
    num_iters: int = 5,
    seed: int = 0,
) -> IvectorExtractor:
    """EM-train the total-variability matrices on a list of [T, F] utts.

    M-step: M_i = C_i A_i^-1 with A_i = sum_u gamma_i^u E[w w^T] and
    C_i = sum_u (f_i^u - gamma_i^u mu_i) E[w]^T — with diagonal Sigma the
    per-Gaussian solve is exact and Sigma cancels row-wise
    ([K] ivector-extractor.cc, IvectorExtractorStats::Update)."""
    rng = np.random.default_rng(seed)
    g, f = ubm.num_gauss, ubm.feat_dim
    m = rng.normal(scale=0.1, size=(g, f, ivector_dim))
    ext = IvectorExtractor(ubm=ubm, m=m, mean_offset=np.zeros(ivector_dim))
    stats = [ext.stats(np.asarray(u, np.float64)) for u in utterances]
    for _ in range(num_iters):
        quad = ext._quad_terms()
        a = np.zeros((g, ivector_dim, ivector_dim))
        c = np.zeros((g, f, ivector_dim))
        for gamma, first in stats:
            w, prec = ext.solve(gamma, first, quad)
            cov = np.linalg.inv(prec)
            eww = cov + np.outer(w, w)  # E[w w^T]
            a += gamma[:, None, None] * eww[None]
            resid = first - gamma[:, None] * ubm.means
            c += resid[:, :, None] * w[None, None, :]
        # per-Gaussian ridge-damped solve (empty Gaussians stay put)
        for i in range(g):
            damp = 1e-8 * max(np.trace(a[i]) / ivector_dim, 1e-12)
            m[i] = np.linalg.solve(
                a[i] + damp * np.eye(ivector_dim), c[i].T
            ).T
        ext = IvectorExtractor(ubm=ubm, m=m, mean_offset=ext.mean_offset)
    # global iVector mean -> mean_offset (Kaldi's prior-offset role):
    # extraction subtracts it so downstream features are centered
    ws = np.stack(
        [ext.solve(gamma, first, ext._quad_terms())[0] for gamma, first in stats]
    )
    return IvectorExtractor(ubm=ubm, m=m, mean_offset=ws.mean(axis=0))


def extract_ivector(
    ext: IvectorExtractor, feats: np.ndarray, posterior_scale: float = 1.0
) -> np.ndarray:
    """[D] utterance-level iVector (centered by the trained mean offset)."""
    gamma, first = ext.stats(feats)
    w, _ = ext.solve(gamma * posterior_scale, first * posterior_scale)
    return w - ext.mean_offset


def extract_ivectors_online(
    ext: IvectorExtractor,
    feats: np.ndarray,
    period: int = 10,
    posterior_scale: float = 0.1,
    max_count: float = 0.0,
) -> np.ndarray:
    """[ceil(T/period), D] causal online iVectors.

    Matches Kaldi's ivector-extract-online behavior: cumulative stats up
    to each period boundary, scaled by posterior_scale (slows adaptation,
    recipe default 0.1), optionally capped at max_count effective frames
    so very long recordings don't saturate the prior
    ([K] kaldi/src/online2/online-ivector-feature.cc role)."""
    feats = np.asarray(feats, np.float64)
    t = feats.shape[0]
    post = ext.ubm.posteriors(feats)
    quad = ext._quad_terms()
    out = []
    cum_gamma = np.zeros(ext.ubm.num_gauss)
    cum_first = np.zeros((ext.ubm.num_gauss, ext.ubm.feat_dim))
    for start in range(0, t, period):
        stop = min(start + period, t)
        p = post[start:stop]
        cum_gamma = cum_gamma + p.sum(axis=0)
        cum_first = cum_first + p.T @ feats[start:stop]
        gamma, first = cum_gamma * posterior_scale, cum_first * posterior_scale
        if max_count > 0 and gamma.sum() > max_count:
            scale = max_count / gamma.sum()
            gamma, first = gamma * scale, first * scale
        w, _ = ext.solve(gamma, first, quad)
        out.append(w - ext.mean_offset)
    return np.stack(out)


def append_corpus_ivectors(
    utts,
    ivector_dim: int = 16,
    num_gauss: int = 64,
    period: int = 10,
    posterior_scale: float = 0.1,
    max_count: float = 100.0,
    ubm_frames: int = 20000,
    seed: int = 0,
):
    """Train UBM + extractor on a corpus and return new Utterances whose
    feats carry online iVectors appended per frame.

    One-call equivalent of the Kaldi online-ivector recipe stages
    (train_diag_ubm.sh -> train_ivector_extractor.sh ->
    extract_ivectors_online.sh + nnet3's --online-ivector-dir input):
    each online iVector (computed causally every ``period`` frames) is
    repeated across its frame span and concatenated to the acoustic
    features, so downstream chunking slices both together.

    Returns (new_utts, extractor); apply the SAME extractor to eval data
    via extract_ivectors_online before decoding.
    """
    from torchain_tpu_torch.data.loader import Utterance

    rng = np.random.default_rng(seed)
    pool = np.concatenate([u.feats for u in utts], axis=0)
    if pool.shape[0] > ubm_frames:
        pool = pool[rng.choice(pool.shape[0], size=ubm_frames, replace=False)]
    ubm = train_diag_ubm(pool, num_gauss=num_gauss, seed=seed)
    ext = train_ivector_extractor(
        ubm, [u.feats for u in utts], ivector_dim, seed=seed
    )
    out = []
    for u in utts:
        ivecs = extract_ivectors_online(
            ext,
            u.feats,
            period=period,
            posterior_scale=posterior_scale,
            max_count=max_count,
        )
        per_frame = np.repeat(ivecs, period, axis=0)[: u.feats.shape[0]]
        feats = np.concatenate(
            [u.feats, per_frame.astype(u.feats.dtype)], axis=1
        )
        out.append(
            Utterance(feats=feats, alignment=u.alignment, utt_id=u.utt_id)
        )
    return out, ext
