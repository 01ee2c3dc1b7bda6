"""Denominator forward-backward on the dense Moore graph with the fused
kernels K9f (forward) and K9b (backward).

Port of torchain_tpu/ops/den_pallas.py, whose file name it keeps so that
the counterpart is found; nothing of Pallas is inside.  The same math and
the same residuals (`p, pe, ymax, logc, sigma_hats, log_z`) as
ops/den_dense.py (Moore factorization, probability space with per-frame
renormalization, rank-1 leaky HMM), with the whole frame recursion of each
pass in one call:

  * K9f `dense_forward_kernel`: pe [T, B, E] -> logc [T, B], sigma_hats
    [T, B, S] (the carry at entry of each frame);
  * K9b `dense_backward_kernel`: -> gout [T, B, E], the occupancies over
    expanded states, scaled so that gamma = gout @ P_mat^T.

The emission product pe = p @ P_mat and the reduction of gout to pdfs stay
outside, as `torch.matmul` over all frames at once (in the JAX package
they are XLA's).  On a CUDA tensor each pass is one launch of
csrc/den_dense.cu, which walks V's compressed forms (one block per
sequence, all frames inside the block); on a CPU tensor the plain PyTorch
version beside it runs the same recursion with the dense V.  Both index
with `orig_of_exp` where ops/den_dense.py multiplies the one-hot E_mat, and
both leave the padded expanded states (e >= real_exp, which `orig_of_exp`
points at state 0 but E_mat leaves empty) out of it.  There is no other
fallback: a graph whose carried state does not fit a block's shared memory,
or whose S or E needs more than 16 bits, is refused (`shared_plan`).
"""

from __future__ import annotations

import math

import torch

from torchain_tpu_torch import kernels
from torchain_tpu_torch.ops.den_dense import leak, leak_t
from torchain_tpu_torch.ops.den_resident import INDEX16_LIMIT
from torchain_tpu_torch.ops.device_graphs import DeviceDenseDenGraph

# ---------------------------------------------------------------------------
# The kernels' shared memory
# ---------------------------------------------------------------------------

#: V's compressed forms a K9 block can stage in shared memory, as bits of the
#: library's `staged`: by expanded state (CSC) and by original state (CSR)
CSC, CSR = 1, 2

#: (device, direction, sizes) -> (bytes, staged), asked of the library once
_PLANS: dict[tuple, tuple[int, int]] = {}


def shared_plan(g: DeviceDenseDenGraph, backward: int, device) -> tuple[int, int]:
    """Bytes of shared memory a K9f (backward=0) or K9b (1) block asks for,
    and which of V's compressed forms are staged there (`CSC`, `CSR` bits;
    what is not staged is read through L2): as many as fit beside the
    carried state under the device's opt-in limit, K9b's CSR before its CSC.
    At the trigram graph's Moore form (S 2176, E 4224 of which 4156 real,
    12,376 non-zeros; H100 limit 232,448 bytes) all of it is staged:

        K9f  carried 42,752 + CSC 91,168 + orig lists 17,040 = 150,960
        K9b  carried 51,584 + CSR 82,976 + CSC 91,168 = 225,728

    (K9f carries sigma [S] and two pe rows [E]; K9b bh [S], one sig row
    [S] and two pe rows; each also its reduction arrays.  A compressed form
    is its int32 offsets, f32 values and 16-bit indices; K9f's orig lists
    are orig_offsets and orig_exps as 16 bits.)  Raises ValueError where S
    or E needs more than 16 bits or the carried state alone exceeds the
    limit, before the library is asked anything in the first case."""
    S, E, real, nnz = g.num_orig, g.num_exp, g.real_exp, g.nnz
    what = "dense_den_backward" if backward else "dense_den_forward"
    if max(S, E) >= INDEX16_LIMIT:
        raise ValueError(
            f"{what}: S={S} and E={E} must both be below {INDEX16_LIMIT}: the kernels"
            " index states with 16 bits"
        )
    key = (device.index, backward, S, E, nnz, real)
    plan = _PLANS.get(key)
    if plan is None:
        need = kernels.entry("den_dense", "dense_shared_bytes")
        limit = kernels.entry("den_dense", "dense_shared_limit")()
        carried = need(backward, S, E, nnz, real, 0)
        if carried > limit:
            raise ValueError(
                f"{what}: the carried state of a sequence (S={S}, E={E}) needs {carried}"
                f" bytes of shared memory, more than the {limit} a block may have"
            )
        plan = (carried, 0)
        for staged in ((CSC | CSR, CSR) if backward else (CSC,)):
            nbytes = need(backward, S, E, nnz, real, staged)
            if nbytes <= limit:
                plan = (nbytes, staged)
                break
        _PLANS[key] = plan
    return plan


def _check_graph(g: DeviceDenseDenGraph, backward: bool) -> None:
    S, E, nnz = g.num_orig, g.num_exp, g.nnz
    kernels.check_tensor("init_orig", g.init_orig, torch.float32, (S,))
    kernels.check_tensor("orig_offsets", g.orig_offsets, torch.int32, (S + 1,))
    kernels.check_tensor("csc_offsets", g.csc_offsets, torch.int32, (E + 1,))
    kernels.check_tensor("csc_rows", g.csc_rows, torch.int16, (nnz,))
    kernels.check_tensor("csc_vals", g.csc_vals, torch.float32, (nnz,))
    if backward:
        kernels.check_tensor("csr_offsets", g.csr_offsets, torch.int32, (S + 1,))
        kernels.check_tensor("csr_cols", g.csr_cols, torch.int16, (nnz,))
        kernels.check_tensor("csr_vals", g.csr_vals, torch.float32, (nnz,))
        kernels.check_tensor("orig16", g.orig16, torch.int16, (E,))
    else:
        kernels.check_tensor("orig_exps", g.orig_exps, torch.int32, (g.real_exp,))


# ---------------------------------------------------------------------------
# K9f: forward.  Kernel wrapper and its plain version (same signature).
# ---------------------------------------------------------------------------


def _real_orig(g: DeviceDenseDenGraph) -> torch.Tensor:
    """Original state of each REAL expanded state, int64 [real_exp]."""
    return g.orig_of_exp[: g.real_exp].long()


def dense_forward_plain(pe: torch.Tensor, g: DeviceDenseDenGraph, leaky: float):
    """Plain PyTorch K9f.  pe [T, B, E] -> (logc [T, B], sigma_hats
    [T, B, S])."""
    T, B, _ = pe.shape
    orig = _real_orig(g)
    sigma = g.init_orig.expand(B, g.num_orig)
    logc = pe.new_empty((T, B))
    sig = pe.new_empty((T, B, g.num_orig))
    for t in range(T):
        sig[t] = sigma
        alpha = (leak(sigma, g.init_orig, leaky) @ g.V) * pe[t]
        c = alpha.sum(-1, keepdim=True)
        logc[t] = torch.log(c[:, 0])
        # segment sum over each original state's real expanded states
        sigma = pe.new_zeros((B, g.num_orig)).index_add_(
            1, orig, (alpha / c)[:, : g.real_exp]
        )
    return logc, sig


def dense_forward_kernel(pe: torch.Tensor, g: DeviceDenseDenGraph, leaky: float):
    """K9f.  Same contract as dense_forward_plain; one launch of
    csrc/den_dense.cu:dense_den_forward on a CUDA tensor."""
    if pe.device.type == "cpu":
        return dense_forward_plain(pe, g, leaky)
    T, B, E = pe.shape
    S = g.num_orig
    kernels.check_tensor("pe", pe, torch.float32, (T, B, g.num_exp))
    _, staged = shared_plan(g, 0, pe.device)  # first: a graph too large raises here
    _check_graph(g, backward=False)
    logc = torch.empty((T, B), device=pe.device, dtype=torch.float32)
    sig = torch.empty((T, B, S), device=pe.device, dtype=torch.float32)
    if T == 0 or B == 0:
        return logc, sig
    err = kernels.entry("den_dense", "dense_den_forward")(
        pe.data_ptr(), g.init_orig.data_ptr(), g.csc_offsets.data_ptr(), g.csc_rows.data_ptr(),
        g.csc_vals.data_ptr(), g.orig_offsets.data_ptr(), g.orig_exps.data_ptr(),
        logc.data_ptr(), sig.data_ptr(), T, B, S, E, g.nnz, g.real_exp, staged, float(leaky),
        kernels.stream_of(pe.device),
    )
    if err:
        kernels.check(kernels.library("den_dense"), err, "dense_den_forward")
    dense_forward_kernel.launches += 1
    return logc, sig


dense_forward_kernel.launches = 0


# ---------------------------------------------------------------------------
# K9b: backward.
# ---------------------------------------------------------------------------


def dense_backward_plain(pe, g: DeviceDenseDenGraph, sig, fscale, ymax_t, leaky: float):
    """Plain PyTorch K9b.  pe [T, B, E], sig [T, B, S], fscale and ymax_t
    [T, B] (fscale = F_{t-1} + ymax_t - log_z) -> gout [T, B, E]."""
    T, B, E = pe.shape
    init = g.init_orig
    orig = _real_orig(g)
    bh = pe.new_ones((B, E))
    G = pe.new_full((B, 1), math.log1p(leaky) if leaky > 0.0 else 0.0)
    gout = pe.new_empty((T, B, E))
    for t in range(T - 1, -1, -1):
        ah = pe[t] * (leak(sig[t], init, leaky) @ g.V)
        gout[t] = ah * bh * torch.exp(fscale[t][:, None] + G)
        v = leak_t((pe[t] * bh) @ g.V.T, init, leaky)  # [B, S]
        nb = pe.new_zeros((B, E))  # 0 on the padded expanded states
        nb[:, : g.real_exp] = v[:, orig]
        d = nb.max(-1, keepdim=True).values
        d = torch.where(d > 0, d, torch.ones_like(d))
        bh = nb / d
        G = G + ymax_t[t][:, None] + torch.log(d)
    return gout


def dense_backward_kernel(pe, g: DeviceDenseDenGraph, sig, fscale, ymax_t, leaky: float):
    """K9b.  Same contract as dense_backward_plain; one launch of
    csrc/den_dense.cu:dense_den_backward on a CUDA tensor."""
    if pe.device.type == "cpu":
        return dense_backward_plain(pe, g, sig, fscale, ymax_t, leaky)
    T, B, E = pe.shape
    S = g.num_orig
    kernels.check_tensor("pe", pe, torch.float32, (T, B, g.num_exp))
    kernels.check_tensor("sigma_hats", sig, torch.float32, (T, B, S))
    kernels.check_tensor("fscale", fscale, torch.float32, (T, B))
    kernels.check_tensor("ymax", ymax_t, torch.float32, (T, B))
    _, staged = shared_plan(g, 1, pe.device)
    _check_graph(g, backward=True)
    gout = torch.empty((T, B, E), device=pe.device, dtype=torch.float32)
    if T == 0 or B == 0:
        return gout
    # G's start rounded to float32 as the plain version's new_full rounds it
    g0 = math.log1p(leaky) if leaky > 0.0 else 0.0
    err = kernels.entry("den_dense", "dense_den_backward")(
        pe.data_ptr(), sig.data_ptr(), fscale.data_ptr(), ymax_t.data_ptr(),
        g.init_orig.data_ptr(), g.csc_offsets.data_ptr(), g.csc_rows.data_ptr(),
        g.csc_vals.data_ptr(), g.csr_offsets.data_ptr(), g.csr_cols.data_ptr(),
        g.csr_vals.data_ptr(), g.orig16.data_ptr(), g.orig_offsets.data_ptr(), gout.data_ptr(),
        T, B, S, E, g.nnz, g.real_exp, staged, float(leaky), g0, kernels.stream_of(pe.device),
    )
    if err:
        kernels.check(kernels.library("den_dense"), err, "dense_den_backward")
    dense_backward_kernel.launches += 1
    return gout


dense_backward_kernel.launches = 0


# ---------------------------------------------------------------------------
# host-facing forward / backward (the JAX package's signatures)
# ---------------------------------------------------------------------------


def den_forward(y: torch.Tensor, g: DeviceDenseDenGraph, leaky: float = 0.0):
    """Drop-in replacement for den_dense.den_forward: y [B, T, P] ->
    (log_z [B], residuals); the residuals also carry pe."""
    y = y.detach().float()
    ymax = y.max(-1).values  # [B, T]
    p = torch.exp(y - ymax[..., None])
    pe = (p.transpose(0, 1) @ g.P_mat).contiguous()  # [T, B, E], all frames at once
    logc, sig = dense_forward_kernel(pe, g, leaky)
    log_z = logc.sum(0) + ymax.sum(-1)
    if leaky > 0.0:
        log_z = log_z + math.log1p(leaky)
    res = dict(p=p, pe=pe, ymax=ymax, logc=logc, sigma_hats=sig, log_z=log_z)
    return log_z, res


def den_backward(g: DeviceDenseDenGraph, res: dict, leaky: float = 0.0):
    """Drop-in replacement for den_dense.den_backward: gamma [B, T, P]."""
    ymax_t = res["ymax"].T.contiguous()  # [T, B]
    F = torch.cumsum(res["logc"] + ymax_t, 0)
    F_prev = torch.cat([F.new_zeros((1, F.shape[1])), F[:-1]])
    fscale = F_prev + ymax_t - res["log_z"]  # [T, B]
    gout = dense_backward_kernel(res["pe"], g, res["sigma_hats"], fscale, ymax_t, leaky)
    return torch.einsum("tbe,pe->btp", gout, g.P_mat)
