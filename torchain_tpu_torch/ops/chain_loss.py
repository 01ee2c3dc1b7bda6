"""The chain (LF-MMI) objective with a custom gradient — the public loss API.

Behavioral reference: kaldi/src/chain/chain-training.{h,cc}
(`ChainTrainingOptions`, `ComputeChainObjfAndDeriv`); port of
torchain_tpu/ops/chain_loss.py:

    objf     = sum_b weight_b * (num_logprob_b - den_logprob_b)
    l2_term  = -0.5 * l2_regularize * ||y||^2
    oor_term = -out_of_range_regularize * sum relu(|y| - 30)^2
    xent     = sum gamma_num . log_softmax(xent_output)  (occupancies are a
               constant target, Kaldi semantics)
    loss     = -(objf + l2_term + oor_term + xent_regularize * xent) / weight

Numeric-failure containment (chain-training.cc): sequences whose objective
or occupancies go non-finite get zero fwd-bwd gradients and a penalty
objective of -10 per frame; training continues.

Autograd never traces the recursions: `chain_logprobs` is an
autograd.Function whose backward is the denominator beta pass emitting the
occupancy gradient directly.

The numerator is chosen by the supervision's type (`DeviceSupervision`:
ops/num_scan.py; `DeviceE2eSupervision`: ops/num_e2e.py) and the
denominator by the graph's, in the JAX package's order
(`DeviceResidentDenGraph`: ops/den_resident.py; `DeviceDeBruijnDenGraph`:
ops/den_debruijn.py; `DeviceDenseDenGraph`: ops/den_dense.py or, when the
graph was built with `fused=True`, ops/den_pallas.py;
`DeviceDenTableGraph`: ops/den_table.py; `DeviceDenGraph`: ops/den_scan.py,
alpha-checkpointed where its `checkpoint_every` divides a larger T).
"""

from __future__ import annotations

import dataclasses

import torch

from torchain_tpu_torch.ops import (
    den_debruijn,
    den_dense,
    den_pallas,
    den_resident,
    den_scan,
    den_table,
    num_e2e,
    num_scan,
)
from torchain_tpu_torch.ops.device_graphs import (
    DeviceDenGraph,
    DeviceDenseDenGraph,
    DeviceSupervision,
)
from torchain_tpu_torch.ops.num_e2e import DeviceE2eSupervision


@dataclasses.dataclass(frozen=True)
class ChainLossOptions:
    """Mirrors Kaldi ChainTrainingOptions (chain-training.h ~L40)."""

    l2_regularize: float = 0.0
    leaky_hmm_coefficient: float = 0.1
    xent_regularize: float = 0.0
    out_of_range_regularize: float = 0.01
    out_of_range_limit: float = 30.0
    #: penalty objf per frame substituted on numeric failure
    failure_penalty_per_frame: float = -10.0


def _num_forward_backward(y, sup):
    """(num_logprob [B], gamma_num [B, T, P]) by supervision flavor:
    frame-synchronous tolerance lattices (NumeratorComputation) or cyclic
    e2e graphs (GenericNumeratorComputation).  Either way y is indexed once
    and both passes share the result."""
    if isinstance(sup, DeviceE2eSupervision):
        ylocal = num_e2e._arc_emissions(y, sup)
        num_logp, alphas = num_e2e.e2e_forward(y, sup, ylocal=ylocal)
        return num_logp, num_e2e.e2e_backward(y, sup, num_logp, alphas, ylocal=ylocal)
    ysmall = num_scan.vocab_gather(y, sup.frame_vocab)
    num_logp, alphas = num_scan.num_forward(y, sup, ysmall=ysmall)
    return num_logp, num_scan.num_backward(y, sup, num_logp, alphas, ysmall=ysmall)


def _den_forward(y, den, leaky):
    """(log_z [B], residuals) by graph type."""
    if isinstance(den, den_resident.DeviceResidentDenGraph):
        return den_resident.den_forward(y, den, leaky)
    if isinstance(den, den_debruijn.DeviceDeBruijnDenGraph):
        return den_debruijn.den_forward(y, den, leaky)
    if isinstance(den, DeviceDenseDenGraph):
        return (den_pallas if den.fused else den_dense).den_forward(y, den, leaky)
    if isinstance(den, den_table.DeviceDenTableGraph):
        log_z, alphas = den_table.den_forward(y, den, leaky)
        return log_z, dict(alphas=alphas)
    if isinstance(den, DeviceDenGraph):
        every, T = den.checkpoint_every, y.shape[1]
        if every and T > every and T % every == 0:
            log_z, chks = den_scan.den_forward_checkpointed(y, den, leaky, every)
            return log_z, dict(chk=chks, every=every)
        log_z, alphas = den_scan.den_forward(y, den, leaky)
        return log_z, dict(alphas=alphas)
    raise TypeError(f"no denominator recursion for {type(den).__name__}")


def _den_backward(y, den, leaky, log_z, res):
    """gamma_den [B, T, P] by graph type, from the residuals of
    `_den_forward` on the same graph."""
    if isinstance(den, den_resident.DeviceResidentDenGraph):
        return den_resident.den_backward(den, res, leaky)
    if isinstance(den, den_debruijn.DeviceDeBruijnDenGraph):
        return den_debruijn.den_backward(y, den, log_z, res, leaky)
    if isinstance(den, DeviceDenseDenGraph):
        return (den_pallas if den.fused else den_dense).den_backward(den, res, leaky)
    if isinstance(den, den_table.DeviceDenTableGraph):
        return den_table.den_backward(y, den, log_z, res["alphas"], leaky)
    if "chk" in res:
        return den_scan.den_backward_checkpointed(
            y, den, log_z, res["chk"], leaky, res["every"])
    return den_scan.den_backward(y, den, log_z, res["alphas"], leaky)


#: the graph types whose backward reads y again (the others carry what they
#: need in their residuals)
_READS_Y = (DeviceDenGraph, den_table.DeviceDenTableGraph, den_debruijn.DeviceDeBruijnDenGraph)


class _ChainLogprobs(torch.autograd.Function):
    """(num_logprob [B], den_logprob [B], gamma_num [B, T, P]).

    The forward runs the numerator forward-backward (gamma_num) and the
    denominator forward; the backward runs the denominator backward and
    returns g_num*gamma_num + g_den*gamma_den, zeroed per sequence where it
    is non-finite, then scaled by the frame weights.  gamma_num (the xent
    target) is a constant output: its cotangent is dropped."""

    @staticmethod
    def forward(ctx, y, den, sup, leaky):
        yd = y.detach().float().contiguous()
        num_logp, gamma_num = _num_forward_backward(yd, sup)
        den_logz, den_res = _den_forward(yd, den, leaky)
        ctx.den, ctx.sup, ctx.leaky, ctx.den_res = den, sup, leaky, den_res
        ctx.y_dtype = y.dtype
        needs_y = isinstance(den, _READS_Y)
        ctx.save_for_backward(gamma_num, den_logz, *((yd,) if needs_y else ()))
        ctx.mark_non_differentiable(gamma_num)
        return num_logp, den_logz, gamma_num

    @staticmethod
    def backward(ctx, g_num, g_den, _g_gamma_dropped):
        gamma_num, den_logz, *rest = ctx.saved_tensors
        gamma_den = _den_backward(
            rest[0] if rest else None, ctx.den, ctx.leaky, den_logz, ctx.den_res
        )
        ctx.den_res = None
        raw = g_num[:, None, None] * gamma_num + g_den[:, None, None] * gamma_den
        ok = (
            torch.isfinite(raw.sum((1, 2)))
            & torch.isfinite(g_num)
            & torch.isfinite(g_den)
        )
        dy = torch.where(ok[:, None, None], raw, 0.0)
        fw = ctx.sup.frame_weights
        if fw is not None:
            dy = dy * fw[:, :, None]
        return dy.to(ctx.y_dtype), None, None, None


def chain_logprobs(y, den, sup, leaky: float):
    return _ChainLogprobs.apply(y, den, sup, leaky)


def chain_loss(
    nnet_output: torch.Tensor,  # [B, T, P] chain-head outputs
    xent_output: torch.Tensor | None,  # [B, T, P] xent-head logits, or None
    den: den_resident.DeviceResidentDenGraph | den_debruijn.DeviceDeBruijnDenGraph
    | DeviceDenseDenGraph | den_table.DeviceDenTableGraph | DeviceDenGraph,
    sup: DeviceSupervision | DeviceE2eSupervision,
    opts: ChainLossOptions = ChainLossOptions(),
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Returns (loss scalar to minimize, aux dict of per-batch statistics).

    aux keys: objf (per-frame MMI objective), l2_term, oor_term, xent_objf
    (all already normalized by `weight`), weight, num_failed.

    With `mesh` (parallel.Mesh, a data axis larger than 1) the inputs are
    this rank's rows of the global batch (`parallel.shard_batch`): the
    recursions run on them as on one card, the sums are all-reduced
    (ops/sharded.py), and every rank returns the global batch's loss and
    statistics.  The loss's gradient is this rank's sums over the global
    weight, so the sum over ranks of the gradients is the gradient of the
    global loss (the train step sums them; the weight is a constant of the
    batch).  A batch the data axis does not divide is computed whole on
    every rank with mesh=None, as `shard_batch` leaves it."""
    y = nnet_output
    B, T, P = y.shape
    num_logp, den_logz, gamma_num = chain_logprobs(
        y, den, sup, opts.leaky_hmm_coefficient
    )
    seq_w = sup.weight  # [B]
    per_seq = num_logp - den_logz
    ok = torch.isfinite(per_seq)
    # where() zeroes the gradient of failed sequences
    per_seq = torch.where(ok, per_seq, opts.failure_penalty_per_frame * T)
    objf = torch.sum(seq_w * per_seq)
    weight = torch.sum(seq_w) * T

    # deriv_weights semantics ([K] nnet-chain-training.cc): the l2/oor
    # derivative rows are scaled by the frame weights while the reported
    # values stay unweighted
    fw = sup.frame_weights

    def _fw_sum(term):  # term [B, T, P] per-element contributions
        if fw is None:
            return torch.sum(term)
        w3 = fw[:, :, None]
        return torch.sum(term.detach() * (1.0 - w3) + term * w3)

    l2_term = -0.5 * opts.l2_regularize * _fw_sum(torch.square(y))
    oor = torch.clamp(torch.abs(y) - opts.out_of_range_limit, min=0.0)
    oor_term = -opts.out_of_range_regularize * _fw_sum(torch.square(oor))

    if xent_output is not None:
        # row-decomposed cross-entropy (no [B, T, P] log_softmax):
        #   sum_p tgt * log_softmax(x) = sum_p tgt*x - (sum_p tgt) * lse(x)
        x = xent_output
        xent_tgt = gamma_num * seq_w[:, None, None]
        m = torch.amax(x, dim=-1, keepdim=True).detach()
        lse = m[..., 0] + torch.log(torch.sum(torch.exp(x - m), dim=-1))  # [B, T]
        row = torch.sum(xent_tgt * x, dim=-1) - torch.sum(xent_tgt, dim=-1) * lse
        if fw is None:
            xent_objf = torch.sum(row)
        else:
            xent_objf = torch.sum(row.detach() * (1.0 - fw) + row * fw)
    else:
        xent_objf = y.new_zeros(())

    total = objf + l2_term + oor_term + opts.xent_regularize * xent_objf
    num_failed = torch.sum(~ok).float()
    if mesh is not None and mesh.data > 1:
        from torchain_tpu_torch.ops.sharded import reduce_loss_sums

        g = reduce_loss_sums(mesh, torch.stack(
            [objf, l2_term, oor_term, xent_objf, weight, num_failed]))
        weight_safe = torch.clamp(g[4], min=1e-8)
        local = -total / weight_safe
        # the value is the global loss; the gradient is this rank's part
        value = -(g[0] + g[1] + g[2] + opts.xent_regularize * g[3]) / weight_safe
        loss = local - local.detach() + value
        objf, l2_term, oor_term, xent_objf, weight, num_failed = g.unbind()
    else:
        # guard: an all-zero-weight batch must not produce inf/nan loss
        weight_safe = torch.clamp(weight, min=1e-8)
        loss = -total / weight_safe
    aux = dict(
        objf=objf / weight_safe,
        l2_term=l2_term / weight_safe,
        oor_term=oor_term / weight_safe,
        xent_objf=xent_objf / weight_safe,
        weight=weight,
        num_failed=num_failed,
    )
    return loss, aux


class ChainResults:
    """Running accumulator of chain statistics, printed per interval
    (torchain's ChainResults)."""

    def __init__(self) -> None:
        self.tot_objf = 0.0
        self.tot_l2 = 0.0
        self.tot_xent = 0.0
        self.tot_weight = 0.0
        self.tot_failed = 0.0
        self.steps = 0

    def add(self, aux: dict) -> None:
        w = float(aux["weight"])
        self.tot_objf += float(aux["objf"]) * w
        self.tot_l2 += float(aux["l2_term"]) * w
        self.tot_xent += float(aux["xent_objf"]) * w
        self.tot_weight += w
        self.tot_failed += float(aux.get("num_failed", 0.0))
        self.steps += 1

    @property
    def objf(self) -> float:
        return self.tot_objf / max(self.tot_weight, 1e-20)

    def __str__(self) -> str:
        w = max(self.tot_weight, 1e-20)
        return (
            f"chain objf/frame={self.tot_objf / w:.4f} "
            f"l2={self.tot_l2 / w:.4f} xent={self.tot_xent / w:.4f} "
            f"weight={self.tot_weight:.0f} failed_seqs={self.tot_failed:.0f}"
        )
