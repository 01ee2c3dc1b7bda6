"""Denominator forward-backward on the de Bruijn lift, gather-free.

Behavioral reference: kaldi/src/chain/chain-denominator.cc
(`DenominatorComputation`, probability space with per-frame renormalization
and leaky HMM) and chain-kernels.cu (the per-arc gather/scatter loop).  Port
of torchain_tpu/ops/den_debruijn.py on the lift of graphs/debruijn.py: all
per-arc irregularity becomes dense strided tensor ops.

Per frame (probability space, Kaldi's "arbitrary scale" renormalization):

    p0, p1  = exp(y_t gathered per trailing-symbol group)   (strided slices)
    arr     = einsum('brj,rjq->bjq', a, W3)                  (shift + LM)
    u       = p0 * arr + p1 * l
    a', l'  = e_end * u, e_cont * u                          (chain topology)
    leak; kappa = sum(a' + l'); renorm; log_z += log kappa + frame max shift

The backward pass is the exact transpose with the same renormalization
constants folded in (Kaldi's BetaDash bookkeeping), emitting the occupancy
gradients gamma[t, pdf] directly; ops/chain_loss.py wires it as the
autograd backward.

It is plain PyTorch with one loop iteration per frame, as the JAX package's
is plain XLA: the contraction is a batched product (`torch.einsum`), the pdf
gathers strided slices of y, or a one-hot product where the tree's group
map is not affine.  Every product runs in full float32: the JAX package
contracts at `Precision.HIGHEST` (a product in bfloat16 or TF32 breaks the
occupancies' sum to one), so this module turns TF32 off around its own
products (`_full_float32`) whatever the caller's setting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from torchain_tpu_torch.graphs.debruijn import DeBruijnDenGraph

NEG_BIG = -1e30  # "log zero" that exps to exactly 0.0 without inf-inf NaNs


@contextlib.contextmanager
def _full_float32():
    """float32 products at full precision (no TF32), restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _supported(spec, sigma: int, tail_len: int, P: int) -> bool:
    """Whether the strided gather below takes an affine spec (base, qs, ps):
    non-negative strides in one of the layouts every ContextTree flavor
    has, every index it reads within [0, P).  Another affine map takes the
    one-hot product."""
    if spec is None:
        return False
    base, qs, ps = spec
    p = sigma - 1
    if qs < 0 or ps < 0:
        return False
    if tail_len == 1 or ps == 0:
        lo, hi = base + qs, base + qs * p
    elif qs == sigma * ps:
        lo, hi = base + qs, base + ps * sigma + ps * (p * sigma - 1)
    elif ps == sigma * qs and qs > 0:
        lo, hi = base, base + qs * (sigma * sigma - 1)
    else:
        return False
    return 0 <= lo and hi < P


@dataclasses.dataclass
class DeviceDeBruijnDenGraph:
    """Device twin of graphs.debruijn.DeBruijnDenGraph.

    The pdf gather runs as strided slices and reshapes of y where the tree's
    group -> pdf map is affine (every ContextTree flavor; spec0/spec1 carry
    (base, qstride, pstride)), else as a [P, G] one-hot product for
    arbitrary trees (onehot0/onehot1 are None where unused)."""

    W3: torch.Tensor  # f32 [sigma, D, sigma]
    onehot0: torch.Tensor | None  # f32 [P, G] or None where spec0 is affine
    onehot1: torch.Tensor | None
    init_bnd: torch.Tensor  # f32 [C]
    init_loop: torch.Tensor  # f32 [C]
    sigma: int
    m: int
    tail_len: int
    num_pdfs: int
    log_continue: float
    log_end: float
    spec0: tuple | None = None
    spec1: tuple | None = None

    @property
    def num_contexts(self) -> int:
        return self.sigma**self.m

    def to(self, device) -> "DeviceDeBruijnDenGraph":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    @staticmethod
    def from_host(g: DeBruijnDenGraph, device="cuda") -> "DeviceDeBruijnDenGraph":
        P, G = g.num_pdfs, g.num_groups
        spec0, spec1 = (s if _supported(s, g.sigma, g.tail_len, P) else None
                        for s in g.affine_pdf_specs())

        def onehot(groups):
            oh = np.zeros((P, G), dtype=np.float32)
            # q=0 groups are dead (no emission enters a boundary-tailed
            # context); they select pdf 0 but carry zero mass
            oh[groups, np.arange(G)] = 1.0
            return torch.as_tensor(oh).to(device)

        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
        return DeviceDeBruijnDenGraph(
            W3=t(g.W3),
            onehot0=None if spec0 else onehot(g.pdf0_group),
            onehot1=None if spec1 else onehot(g.pdf1_group),
            init_bnd=t(g.init_bnd),
            init_loop=t(g.init_loop),
            sigma=int(g.sigma),
            m=int(g.m),
            tail_len=int(g.tail_len),
            num_pdfs=int(g.num_pdfs),
            log_continue=float(g.log_continue),
            log_end=float(g.log_end),
            spec0=spec0,
            spec1=spec1,
        )


def _strided(y: torch.Tensor, start: int, step: int, n: int) -> torch.Tensor:
    """y[:, start + step * k] for k < n, a view (broadcast where step is 0)."""
    if step == 0:
        return y[:, start : start + 1].expand(y.shape[0], n)
    return y[:, start : start + step * (n - 1) + 1 : step]


def _gather_groups(y_t, spec, onehot, sigma: int, tail_len: int) -> torch.Tensor:
    """y_t [B, P] -> grouped log-values [B, G], G = sigma^tail_len, with
    dead (q=0) groups at NEG_BIG.  An affine spec takes strided slices and
    reshapes (no product, no gather)."""
    B = y_t.shape[0]
    p = sigma - 1
    if spec is None:
        return y_t @ onehot
    base, qs, ps = spec
    if tail_len == 1:
        vals = _strided(y_t, base + qs, qs, p)
        return torch.cat([y_t.new_full((B, 1), NEG_BIG), vals], dim=1)
    if ps == 0:
        tile = _strided(y_t, base + qs, qs, p)[:, None, :].expand(B, sigma, p)
    elif qs == sigma * ps:
        span = _strided(y_t, base + ps * sigma, ps, p * sigma)  # [B, p*sigma]
        tile = span.reshape(B, p, sigma).transpose(1, 2)  # [B, prev, q]
    else:  # ps == sigma * qs
        tile = _strided(y_t, base, qs, sigma * sigma).reshape(B, sigma, sigma)[:, :, 1:]
    dead = y_t.new_full((B, sigma, 1), NEG_BIG)
    return torch.cat([dead, tile], dim=2).reshape(B, sigma * sigma)


def _strided_add(out: torch.Tensor, start: int, step: int, vals: torch.Tensor) -> None:
    """out[:, start + step * k] += vals[:, k] (step 0: the sum of vals)."""
    if step == 0:
        out[:, start] += vals.sum(1)
    else:
        n = vals.shape[1]
        out[:, start : start + step * (n - 1) + 1 : step] += vals


def _scatter_groups(gg, spec, onehot, sigma: int, tail_len: int, P: int) -> torch.Tensor:
    """Transpose of _gather_groups: grouped values [B, G] -> pdf gradients
    [B, P] (dead q=0 groups dropped)."""
    B = gg.shape[0]
    p = sigma - 1
    if spec is None:
        return gg @ onehot.T
    base, qs, ps = spec
    out = gg.new_zeros((B, P))
    if tail_len == 1:
        _strided_add(out, base + qs, qs, gg[:, 1:])
        return out
    tile = gg.reshape(B, sigma, sigma)
    if ps == 0:
        _strided_add(out, base + qs, qs, tile[:, :, 1:].sum(1))  # reduce over prev
    elif qs == sigma * ps:
        span = tile[:, :, 1:].transpose(1, 2).reshape(B, p * sigma)
        _strided_add(out, base + ps * sigma, ps, span)
    else:  # ps == sigma * qs
        span = tile.clone()
        span[:, :, 0] = 0.0
        _strided_add(out, base, qs, span.reshape(B, sigma * sigma))
    return out


def _pdf_probs(y_t: torch.Tensor, g: DeviceDeBruijnDenGraph):
    """y_t [B, P] -> (p0, p1) [B, C] emission probabilities per context, and
    the per-sequence max shift mt [B] folded out of the exps."""
    B = y_t.shape[0]
    C = g.num_contexts
    G = g.sigma**g.tail_len
    mt = y_t.max(-1).values
    y0 = _gather_groups(y_t, g.spec0, g.onehot0, g.sigma, g.tail_len)
    y1 = _gather_groups(y_t, g.spec1, g.onehot1, g.sigma, g.tail_len)
    p0g = torch.exp(y0 - mt[:, None])
    p1g = torch.exp(y1 - mt[:, None])
    p0 = p0g[:, None, :].expand(B, C // G, G).reshape(B, C)
    p1 = p1g[:, None, :].expand(B, C // G, G).reshape(B, C)
    return p0, p1, mt


def _shift(a: torch.Tensor, g: DeviceDeBruijnDenGraph) -> torch.Tensor:
    """arr[b, (j, q)] = sum_r a[b, (r, j)] * W3[r, j, q]: follow every LM arc
    by dropping the oldest context symbol and appending q."""
    B, C = a.shape
    arr = torch.einsum("brj,rjq->bjq", a.reshape(B, g.sigma, C // g.sigma), g.W3)
    return arr.reshape(B, C)


def _shift_t(x: torch.Tensor, g: DeviceDeBruijnDenGraph) -> torch.Tensor:
    """Transpose of _shift: pull destination values back to source contexts."""
    B, C = x.shape
    out = torch.einsum("rjq,bjq->brj", g.W3, x.reshape(B, C // g.sigma, g.sigma))
    return out.reshape(B, C)


def _leak(a, l, g: DeviceDeBruijnDenGraph, leaky: float):
    if leaky <= 0.0:
        return a, l
    tot = a.sum(-1, keepdim=True) + l.sum(-1, keepdim=True)
    return a + leaky * tot * g.init_bnd, l + leaky * tot * g.init_loop


def _leak_t(ba, bl, g: DeviceDeBruijnDenGraph, leaky: float):
    """Transpose of _leak: btilde = beta + leaky * <init, beta>."""
    if leaky <= 0.0:
        return ba, bl
    inner = (ba * g.init_bnd).sum(-1, keepdim=True) + (bl * g.init_loop).sum(-1, keepdim=True)
    return ba + leaky * inner, bl + leaky * inner


def den_forward(
    y: torch.Tensor,  # [B, T, P] nnet log-prob outputs
    g: DeviceDeBruijnDenGraph,
    leaky: float = 0.0,
) -> tuple[torch.Tensor, dict]:
    """Returns (log_z [B], residuals) with residuals = dict(a, l, logk,
    logk0): a/l [T, B, C] renormalized pre-step masses, logk [T, B] per-step
    log normalizers (in the max-shifted system), logk0 [B] the initial
    one."""
    y = y.detach().float()
    B, T, _ = y.shape
    C = g.num_contexts
    e_cont, e_end = math.exp(g.log_continue), math.exp(g.log_end)
    a, l = _leak(g.init_bnd.expand(B, C), g.init_loop.expand(B, C), g, leaky)
    k0 = a.sum(-1) + l.sum(-1)
    a, l = a / k0[:, None], l / k0[:, None]
    As, Ls = y.new_empty((T, B, C)), y.new_empty((T, B, C))
    logks, mts = y.new_empty((T, B)), y.new_empty((T, B))
    with _full_float32():
        for t in range(T):
            As[t], Ls[t] = a, l
            p0, p1, mts[t] = _pdf_probs(y[:, t], g)
            u = p0 * _shift(a, g) + p1 * l
            a, l = _leak(e_end * u, e_cont * u, g, leaky)
            kt = a.sum(-1) + l.sum(-1)
            a, l = a / kt[:, None], l / kt[:, None]
            # logk stays in the SHIFTED system (kt was computed with
            # p * exp(-mt)); the occupancies are invariant under per-frame
            # operator scaling, so the backward runs in the shifted system
            # and mt enters log_z only
            logks[t] = torch.log(kt)
    log_z = torch.log(k0) + logks.sum(0) + mts.sum(0)
    return log_z, dict(a=As, l=Ls, logk=logks, logk0=torch.log(k0))


def den_backward(
    y: torch.Tensor,  # [B, T, P]
    g: DeviceDeBruijnDenGraph,
    log_z: torch.Tensor,  # [B] (unused; the scales live in the residual logks)
    res: dict,
    leaky: float = 0.0,
) -> torch.Tensor:
    """Returns gamma [B, T, P] = d(log Z)/dy by the transposed recursion
    with the forward's renormalizers folded in (BetaDash bookkeeping):

        bhat_T = 1/kappa_T;  bhat_t = E_t^T(L^T(bhat_{t+1})) / kappa_t
        gamma[t] = a_t * w * p_t * L^T(bhat_{t+1})
    """
    y = y.detach().float()
    B, T, P = y.shape
    C = g.num_contexts
    G = g.sigma**g.tail_len
    e_cont, e_end = math.exp(g.log_continue), math.exp(g.log_end)
    As, Ls, logks, logk0 = res["a"], res["l"], res["logk"], res["logk0"]
    # the kappa to divide by at reverse step t: kappa_t (the initial one at 0)
    logk_div = torch.cat([logk0[None], logks[:-1]], dim=0)  # [T, B]
    ba = torch.exp(-logks[-1])[:, None].expand(B, C)  # 1/kappa_T
    bl = ba
    gamma = y.new_empty((B, T, P))
    with _full_float32():
        for t in range(T - 1, -1, -1):
            ta, tl = _leak_t(ba, bl, g, leaky)  # btilde
            v = e_end * ta + e_cont * tl  # [B, C] the destination-side factor
            p0, p1, _ = _pdf_probs(y[:, t], g)
            arr = _shift(As[t], g)  # arrivals recomputed (cheaper than stored)
            g0 = (arr * p0 * v).reshape(B, C // G, G).sum(1)  # phone-entry arcs
            g1 = (Ls[t] * p1 * v).reshape(B, C // G, G).sum(1)  # self-loop/exit arcs
            gamma[:, t] = _scatter_groups(
                g0, g.spec0, g.onehot0, g.sigma, g.tail_len, P
            ) + _scatter_groups(g1, g.spec1, g.onehot1, g.sigma, g.tail_len, P)
            # the whole backward runs in the forward's max-shifted system
            # (shifted p's and kappas); the occupancies are invariant under
            # per-frame operator scaling, so gamma is exact
            ka = torch.exp(-logk_div[t])[:, None]
            ba = _shift_t(p0 * v, g) * ka
            bl = p1 * v * ka
    return gamma
