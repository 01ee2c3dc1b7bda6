"""TDNN-LSTM acoustic encoder (torch), port of torchain_tpu/models/lstm.py:
projected LSTM (LSTMP) and output-gate projected GRU (OPGRU) layers
interleaved with context-spliced TDNN layers.

Kaldi's chain TDNN-LSTM recipes (egs/wsj/s5/local/chain/tuning/
run_tdnn_lstm_1a.sh, LstmNonlinearityComponent and its projection) and the
norm-opgru family (egs/swbd/s5c/local/chain/tuning/run_opgru_1a.sh).  Per
LSTMP layer, with diagonal peepholes w_ic, w_fc, w_oc:

    i_t = sigmoid(W_ix x_t + W_ir r_{t-d} + w_ic . c_{t-d} + b_i)
    f_t = sigmoid(W_fx x_t + W_fr r_{t-d} + w_fc . c_{t-d} + b_f)
    c_t = f_t . c_{t-d} + i_t . tanh(W_cx x_t + W_cr r_{t-d} + b_c)
    o_t = sigmoid(W_ox x_t + W_or r_{t-d} + w_oc . c_t + b_o)
    m_t = o_t . tanh(c_t);  [r_t | p_t] = m_t W_rm;  output_t = [r_t | p_t]

The input product for all frames runs as one matrix product outside the
recurrence.  A delay-d recurrence is d independent chains over the phase
classes t mod d: time is padded to a multiple of d and folded into
[T/d, d*B, .], and the loop runs T/d steps over d*B rows.  The cell state is
float32 whatever the trunk dtype; the gate pre-activations are cast to
float32 where the JAX package's scan casts them, and rounded where XLA
rounds them (bit for bit on the CPU): the LSTMP rounds its recurrent
product to the trunk dtype and adds it to the input product in float32,
the OPGRU takes its recurrent product in float32.  The recurrence is a Python
loop of `torch.matmul` and elementwise ops (the JAX package runs a
`lax.scan` with no Pallas kernel behind it): on the card each step is about
twenty launches forward, so a deep or long recurrence is bound by the host.
`TdnnLstmConfig.lstm_unroll` is the JAX scan's unroll factor and has no
effect here.

Parameters keep flax's names and shapes (`tdnn{i}.kernel [k, in, out]`,
`BatchNorm_{i}`, `lstm{i}.w_x [C, 4*cell]`, `lstm{i}.w_r [rec, 4*cell]`,
`lstm{i}.w_rm [cell, rec + nonrec]`, `gru{i}.u_s [rec, 2*cell]`, ...), so
`convert.params_from_jax` is a renaming.  The model returns (chain_out,
xent_out): [B, T_out, num_pdfs], float32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from torchain_tpu_torch.models.tdnn import (
    Prefinal,
    TdnnConv,
    _param,
    batch_norm,
    check_lowerings,
    continuous_dropout,
)


def _phase_chains(xp: torch.Tensor, d: int) -> torch.Tensor:
    """[T, B, G] -> [ceil(T/d), d*B, G], T zero-padded to a multiple of d:
    row k holds frames k*d .. k*d + d - 1, so the chains of the d phase
    classes run side by side."""
    T, B, G = xp.shape
    Tp = -(-T // d) * d
    if Tp != T:
        xp = torch.nn.functional.pad(xp, (0, 0, 0, 0, 0, Tp - T))
    return xp.reshape(Tp // d, d * B, G)


class Lstmp(nn.Module):
    """One projected LSTM layer over a time-major [T, B, C] input; returns
    [T, B, rec_proj_dim + nonrec_proj_dim] in `dtype`.  `delay` is the
    recurrence distance in frames at this layer's frame rate."""

    def __init__(self, in_dim, cell_dim, rec_proj_dim, nonrec_proj_dim, delay=1, device=None,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.cell, self.rec, self.delay, self.dtype = cell_dim, rec_proj_dim, delay, dtype
        proj = rec_proj_dim + nonrec_proj_dim
        self.w_x = _param((in_dim, 4 * cell_dim), device, fan_in=in_dim, generator=generator)
        self.w_r = _param((rec_proj_dim, 4 * cell_dim), device, fan_in=rec_proj_dim,
                          generator=generator)
        # forget-gate bias 1.0: remember by default
        self.bias = _param((4 * cell_dim,), device)
        with torch.no_grad():
            self.bias[cell_dim:2 * cell_dim] = 1.0
        self.w_ic = _param((cell_dim,), device)
        self.w_fc = _param((cell_dim,), device)
        self.w_oc = _param((cell_dim,), device)
        self.w_rm = _param((cell_dim, proj), device, fan_in=cell_dim, generator=generator)

    def forward(self, x):  # [T, B, C]
        T, B, _ = x.shape
        d, dt, cell = self.delay, self.dtype, self.cell
        xp = _phase_chains(x.to(dt) @ self.w_x.to(dt) + self.bias.to(dt), d)
        w_r, w_rm = self.w_r.to(dt), self.w_rm.to(dt)
        c = torch.zeros(d * B, cell, dtype=torch.float32, device=x.device)
        r = torch.zeros(d * B, self.rec, dtype=dt, device=x.device)
        ys = []
        for xp_k in xp:
            # the pre-activations' sum in float32: XLA fuses the JAX scan's
            # add into its cast to float32 and does not round the sum
            gates = xp_k.float() + (r @ w_r).float()
            gi, gf, gg, go = gates.split(cell, dim=-1)
            i = torch.sigmoid(gi + self.w_ic * c)
            f = torch.sigmoid(gf + self.w_fc * c)
            c = f * c + i * torch.tanh(gg)
            o = torch.sigmoid(go + self.w_oc * c)
            rp = (o * torch.tanh(c)).to(dt) @ w_rm
            r = rp[:, : self.rec]
            ys.append(rp)
        return torch.stack(ys).reshape(-1, B, ys[0].shape[-1])[:T]


class Opgru(nn.Module):
    """One projected OPGRU layer over a time-major [T, B, C] input (Cheng et
    al. 2018): no reset gate, a diagonal recurrence u_h on the cell in the
    candidate, an output gate before the [recurrent | non-recurrent]
    projection:

        z_t = sigmoid(W_z x_t + U_z s_{t-d});  o_t = sigmoid(W_o x_t + U_o s_{t-d})
        h_t = tanh(W_h x_t + u_h . c_{t-d});  c_t = (1 - z_t) . h_t + z_t . c_{t-d}
        [r_t | p_t] = (c_t . o_t) W_rm;  s_t = r_t

    The same layout as Lstmp: the input product outside the loop, delay-d
    as phase chains, a float32 cell state."""

    def __init__(self, in_dim, cell_dim, rec_proj_dim, nonrec_proj_dim, delay=1, device=None,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.cell, self.rec, self.delay, self.dtype = cell_dim, rec_proj_dim, delay, dtype
        proj = rec_proj_dim + nonrec_proj_dim
        self.w_x = _param((in_dim, 3 * cell_dim), device, fan_in=in_dim, generator=generator)
        self.u_s = _param((rec_proj_dim, 2 * cell_dim), device, fan_in=rec_proj_dim,
                          generator=generator)
        self.bias = _param((3 * cell_dim,), device)
        self.u_h = _param((cell_dim,), device)
        self.w_rm = _param((cell_dim, proj), device, fan_in=cell_dim, generator=generator)

    def forward(self, x):  # [T, B, C]
        T, B, _ = x.shape
        d, dt, cell = self.delay, self.dtype, self.cell
        xp = _phase_chains(x.to(dt) @ self.w_x.to(dt) + self.bias.to(dt), d)
        u_s, w_rm = self.u_s.to(dt), self.w_rm.to(dt)
        c = torch.zeros(d * B, cell, dtype=torch.float32, device=x.device)
        s = torch.zeros(d * B, self.rec, dtype=dt, device=x.device)
        ys = []
        for xp_k in xp:
            # the gates take the projected state; the candidate's recurrence
            # is diagonal on the cell
            # (XLA folds the cast to float32 into the product: it is not
            # rounded to the trunk dtype)
            zz, oo = (s.float() @ u_s.float()).split(cell, dim=-1)
            gz, go, gh = xp_k.float().split(cell, dim=-1)
            z = torch.sigmoid(gz + zz)
            o = torch.sigmoid(go + oo)
            h = torch.tanh(gh + self.u_h * c)
            c = (1.0 - z) * h + z * c
            rp = (c * o).to(dt) @ w_rm
            s = rp[:, : self.rec]
            ys.append(rp)
        return torch.stack(ys).reshape(-1, B, ys[0].shape[-1])[:T]


#: the default ladder (run_tdnn_lstm_1a's): ("tdnn", kernel, dilation,
#: stride), ("lstm", delay) or ("gru", delay)
TDNN_LSTM_LAYERS = (
    ("tdnn", 5, 1, 1),
    ("tdnn", 3, 1, 3),
    ("tdnn", 3, 1, 1),
    ("lstm", 1),
    ("tdnn", 3, 3, 1),
    ("tdnn", 3, 3, 1),
    ("lstm", 1),
    ("tdnn", 3, 3, 1),
    ("tdnn", 3, 3, 1),
    ("lstm", 1),
)


@dataclasses.dataclass(frozen=True)
class TdnnLstmConfig:
    """Kaldi's tdnn-lstm chain topology: TDNN splice blocks with LSTMP (or
    OPGRU) layers interleaved."""

    num_pdfs: int = 120
    hidden_dim: int = 512
    cell_dim: int = 512
    rec_proj_dim: int = 128
    nonrec_proj_dim: int = 128
    prefinal_dim: int = 256
    #: compute dtype of the trunk (parameters stay float32)
    dtype: torch.dtype = torch.float32
    #: trunk ladder; exactly one tdnn stride equals frame_subsampling_factor,
    #: and recurrent delays are at the post-stride frame rate
    layers: tuple = TDNN_LSTM_LAYERS
    #: extra left-context output frames the recurrent state warms up on
    #: before the scored chunk (Kaldi --egs.chunk-left-context / 3); the
    #: heads score only the final T_out frames
    warmup_frames: int = 6
    bn_impl: str = "fused"
    #: the JAX scan's unroll factor; no effect in this port
    lstm_unroll: int = 1

    def __post_init__(self):
        check_lowerings(self, bn_impl=("fused", "flax"))
        for spec in self.layers:
            if spec[0] not in ("tdnn", "lstm", "gru"):
                raise ValueError(f"unknown layer {spec!r}")

    @property
    def frame_subsampling_factor(self) -> int:
        f = 1
        for spec in self.layers:
            if spec[0] == "tdnn":
                f *= spec[3]
        return f

    @property
    def context(self) -> tuple[int, int]:
        """(left, right) extra input frames: the symmetric TDNN splice
        context plus the warm-up frames (at the input rate)."""
        left = right = 0
        rate = 1
        for spec in self.layers:
            if spec[0] != "tdnn":
                continue
            _, k, dil, s = spec
            half = (k // 2) * dil * rate
            left += half
            rate *= s
            right += half
        return left + self.warmup_frames * rate, right


class TDNNLSTM(nn.Module):
    """TDNN-LSTM trunk with chain + xent heads (float32 outputs).  The TDNN
    layers are VALID convolutions (`TdnnConv`) with relu, batchnorm and
    continuous dropout; the recurrent layers run time-major and are followed
    by continuous dropout; the first `warmup_frames` output frames are cut
    before the heads."""

    def __init__(self, cfg: TdnnLstmConfig, feat_dim: int, device="cuda", generator=None):
        super().__init__()
        self.config = cfg
        dt, in_dim = cfg.dtype, feat_dim
        for li, spec in enumerate(cfg.layers):
            if spec[0] == "tdnn":
                _, k, dil, s = spec
                setattr(self, f"tdnn{li}", TdnnConv(in_dim, cfg.hidden_dim, k, dil, s, device,
                                                    generator, dt))
                setattr(self, f"BatchNorm_{li}", batch_norm(cfg.hidden_dim, cfg.bn_impl, device))
                in_dim = cfg.hidden_dim
            else:
                kind, delay = spec
                cls = Lstmp if kind == "lstm" else Opgru
                setattr(self, f"{kind}{li}", cls(in_dim, cfg.cell_dim, cfg.rec_proj_dim,
                                                 cfg.nonrec_proj_dim, delay, device, generator,
                                                 dt))
                in_dim = cfg.rec_proj_dim + cfg.nonrec_proj_dim
        self.chain_head = Prefinal(in_dim, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt,
                                   cfg.bn_impl)
        self.xent_head = Prefinal(in_dim, cfg.prefinal_dim, cfg.num_pdfs, device, generator, dt,
                                  cfg.bn_impl)

    def forward(self, feats, train: bool = False, dropout_rate=None, generator=None):
        """feats [B, T_in, F] -> (chain, xent) [B, T_out, num_pdfs]."""
        cfg = self.config
        x = feats.to(cfg.dtype)
        for li, spec in enumerate(cfg.layers):
            if spec[0] == "tdnn":
                x = torch.relu(getattr(self, f"tdnn{li}")(x))
                x = getattr(self, f"BatchNorm_{li}")(x, train)
            else:
                x = getattr(self, f"{spec[0]}{li}")(x.transpose(0, 1)).transpose(0, 1)
            x = continuous_dropout(x, dropout_rate, train, generator)
        if cfg.warmup_frames:
            x = x[:, cfg.warmup_frames :]  # score only the chunk
        return self.chain_head(x, train), self.xent_head(x, train)
