"""Numerator recursions, each as one kernel: the steady frames of the
frame-synchronous supervision, K3 (forward) and K4 (backward), and the
flat-start (e2e) supervision's cyclic graphs, K8f and K8b (further down).

Behavioral reference: kaldi/src/chain/chain-numerator.cc
(`NumeratorComputation`).  Port of torchain_tpu/ops/num_resident.py
(`steady_forward`, `steady_backward`): the log-semiring alpha/beta
recursions over the packed per-frame arc tensors for frames 1..T-1, the
whole frame loop inside one launch.  Frame 0 (the normalization FST's wide
initial fan-in) stays outside, in ops/num_scan.py, at the full arc width.

  * K3 `steady_forward`: next[s] = lse_k(alpha[src[s, k]] + logw[s, k]
    + ysm[t, lpdf[s, k]]) over the arcs with src >= 0; a state without
    arcs gets -inf.
  * K4 `steady_backward`, frames in reverse: arc_w = logw + ysm[lpdf]
    + beta[s]; post = exp(alpha[src] + arc_w - log_p); gsm[w] = sum of post
    over the arcs with lpdf == w; beta_prev[s'] = lse of arc_w over the
    arcs with src == s'.  A sequence whose log_p is not finite gets
    exactly zero occupancies.

On a CUDA tensor each is one launch of csrc/num_resident.cu (one thread
block per sequence); on a CPU tensor the plain PyTorch version beside it
runs the same recursion as a loop over frames.  There is no other
fallback.

K3 and K4 read only the live arcs, listed per sequence frame by frame,
with per-frame offsets (K4) and per-frame destination offsets (K3).
`kernel_tables` makes them from the int64 tables the plain path indexes
with, once, when a batch is placed (`DeviceSupervision.with_kernel_tables`),
and the wrappers take the result as `pre`.
"""

from __future__ import annotations

import torch

from torchain_tpu_torch import kernels

NEG_INF = float("-inf")

def emit(ysm: torch.Tensor, pdf_local: torch.Tensor) -> torch.Tensor:
    """ysm [B, W], pdf_local [B, S, K] -> emission log-probs [B, S, K]."""
    B = ysm.shape[0]
    return ysm.gather(1, pdf_local.reshape(B, -1)).view(pdf_local.shape)


def select_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x [B, S], src [B, S, K] (values in [0, S), -1 = pad) -> [B, S, K]
    with x[b, src[b, s, k]] (pad slots yield -inf)."""
    B = x.shape[0]
    sel = x.gather(1, src.clamp(min=0).reshape(B, -1)).view(src.shape)
    return torch.where(src >= 0, sel, NEG_INF)


def forward_step(alpha, ysm, src, lpdf, logw):
    """One frame of the alpha recursion: alpha [B, S] -> next alpha [B, S]."""
    vals = select_src(alpha, src) + torch.where(src >= 0, logw + emit(ysm, lpdf), 0.0)
    return torch.logsumexp(vals, dim=-1)


def backward_step(beta, ysm, src, lpdf, logw, alpha_t, log_p):
    """One frame of the beta recursion.  beta [B, S]: log-betas of the
    frame's destination states; alpha_t [B, S]: alphas of its source
    states.  Returns (beta of the source states [B, S], vocabulary-space
    occupancies of the frame [B, W']) with W' = ysm.shape[-1]."""
    S, W = beta.shape[1], ysm.shape[-1]
    valid = torch.isfinite(log_p)
    safe_logp = torch.where(valid, log_p, 0.0)
    arc_w = torch.where(src >= 0, logw + emit(ysm, lpdf), NEG_INF) + beta[:, :, None]
    hit_src = src[..., None] == torch.arange(S, device=beta.device)  # [B, S, K, S']
    prev = torch.logsumexp(
        torch.where(hit_src, arc_w[..., None], NEG_INF), dim=(1, 2)
    )  # [B, S'], stabilized per source state
    post = torch.where(
        valid[:, None, None],
        torch.exp(select_src(alpha_t, src) + arc_w - safe_logp[:, None, None]),
        0.0,
    )  # [B, S, K] per-arc occupancies
    hit_w = lpdf[..., None] == torch.arange(W, device=beta.device)  # [B, S, K, W]
    gsm = torch.where(hit_w, post[..., None], 0.0).sum((1, 2))
    return prev, gsm


def kernel_tables(src, lpdf, logw):
    """The steady tables as K3 and K4 read them, from src, lpdf (any integer
    dtype, src -1 = pad) and logw, each [B, T-1, S, Kr]:

      arc_off int32 [B, T]: where each frame's live arcs start in its
        sequence's list, and (last column) one past the list's end (K4);
      arcs int32 [B, L, 4]: each sequence's live slots (src >= 0), frame by
        frame in slot order, as (src, dst = slot // Kr, lpdf, logw's float32
        bits); L is the longest list of the batch, at least 1, and a shorter
        list ends in zeros (K3, K4);
      dst_off int32 [B, T-1, S+1]: where the run of each destination state
        (its in-arcs: slot order is destination order) of each frame starts
        in its sequence's list, and (last column) one past the frame's last
        record (K3).

    Sizing the list reads one number back to the host (a sync): call it
    where a batch is placed, not inside a step."""
    src32 = src.to(torch.int32)
    B, Tm1, S, Kr = src32.shape
    A = S * Kr
    live = (src32 >= 0).reshape(B, Tm1 * A)
    per_dst = live.view(B, Tm1 * S, Kr).sum(-1)
    ends = torch.cumsum(per_dst, 1).view(B, Tm1, S)
    dst_off = torch.zeros((B, Tm1, S + 1), device=src.device, dtype=torch.int32)
    dst_off[:, :, 1:] = ends
    dst_off[:, 1:, 0] = ends[:, :-1, -1]
    arc_off = torch.zeros((B, Tm1 + 1), device=src.device, dtype=torch.int32)
    arc_off[:, 1:] = ends[:, :, -1]
    L = max(1, int(arc_off[:, -1].max())) if B else 1
    dst = torch.arange(S, device=src.device, dtype=torch.int32).repeat_interleave(Kr)
    rec = torch.stack(
        [src32.reshape(B, Tm1, A), dst.expand(B, Tm1, A),
         lpdf.to(torch.int32).reshape(B, Tm1, A),
         logw.to(torch.float32).contiguous().view(torch.int32).reshape(B, Tm1, A)], -1,
    ).reshape(B, Tm1 * A, 4)
    # each live slot's place in its sequence's list; pads go to column L,
    # which is dropped
    pos = torch.where(live, torch.cumsum(live, 1) - 1, L)
    arcs = torch.zeros((B, L + 1, 4), device=src.device, dtype=torch.int32)
    arcs.scatter_(1, pos[..., None].expand(B, Tm1 * A, 4), rec)
    return arc_off, arcs[:, :L].contiguous(), dst_off


def _rows(ysm: torch.Tensor, like: torch.Tensor, B: int, Tm1: int) -> torch.Tensor:
    """ysm [B, T-1, W] checked against `like`'s device, with unit stride
    along W (a time slice of the [B, T, W] gather is taken as it is: the
    kernels get its strides)."""
    if ysm.device != like.device or ysm.dtype != torch.float32 or ysm.shape[:2] != (B, Tm1):
        raise TypeError(f"ysm: expected float32 [{B}, {Tm1}, W] on {like.device}")
    return ysm if ysm.stride(-1) == 1 else ysm.contiguous()


def _steady_bwd_threads(S: int, W: int) -> int:
    """K4's block: warps for the S source states, then warps for the W
    vocabulary slots (taken from the top), so that the two scans of a frame
    run in different warps."""
    return min(1024, 32 * (-(-S // 32) + -(-W // 32)))


# ---------------------------------------------------------------------------
# K3: forward
# ---------------------------------------------------------------------------


def steady_forward_plain(alpha1, src, lpdf, logw, ysm):
    """Plain PyTorch K3: the alpha recursion as a loop over frames.  Index
    tables of any integer dtype."""
    src, lpdf = src.long(), lpdf.long()
    alpha, rest = alpha1, []
    for t in range(src.shape[1]):
        alpha = forward_step(alpha, ysm[:, t], src[:, t], lpdf[:, t], logw[:, t])
        rest.append(alpha)
    if not rest:
        return alpha1, alpha1.new_empty((0,) + tuple(alpha1.shape))
    return alpha, torch.stack(rest)


#: (kernel, device index, sizes, plan asked for, limit) -> (bytes, staged)
#: of K3's, K4's, K8f's and K8b's blocks
_PLANS: dict[tuple, tuple[int, int]] = {}
#: the opt-in shared-memory limit by (library entry, device index)
_LIMITS: dict[tuple, int] = {}
#: the library entry that gives K3's and K4's shared-memory limit
NUM_LIMIT = ("num_resident", "num_shared_limit")


def shared_limit(entry: tuple, device) -> int:
    """Bytes of shared memory a numerator kernel's block may ask for on
    `device` (its opt-in limit), read once through the library `entry`.  The
    one limit the plans are held to: a test lowers it to make the sizes
    choose the unstaged plan."""
    key = (entry, device.index)
    limit = _LIMITS.get(key)
    if limit is None:
        limit = _LIMITS[key] = kernels.entry(*entry)()
    return limit


def _plan(key: tuple, need, staged: int | None, what: str, device,
          limit_entry=NUM_LIMIT) -> tuple[int, int]:
    """(bytes, staged) of a block whose shared memory takes need(p) bytes
    in plan p: 1 (the sequence's list staged) wherever that fits under
    `shared_limit`, else 0, unless `staged` asks for one plan; raises
    ValueError with `what` where the plan does not fit."""
    limit = shared_limit(limit_entry, device)
    key = (*key, limit)
    plan = _PLANS.get(key)
    if plan is None:
        sizes = {p: need(p) for p in (0, 1)}
        if staged is None:
            staged = int(sizes[1] <= limit)
        if sizes[staged] > limit:
            raise ValueError(
                f"{what} need {sizes[staged]} bytes of shared memory, more than the {limit}"
                " a block may have"
            )
        plan = _PLANS[key] = (sizes[staged], staged)
    return plan


def steady_forward_plan(L: int, Tm1: int, S: int, W: int, device) -> tuple[int, int]:
    """Bytes of shared memory a K3 block asks for, and whether it stages its
    sequence's live list, destination offsets and ysm rows there (1) or
    reads them from device memory each frame and keeps only alpha there
    (0): staged wherever that fits under `shared_limit`.  At the shipped
    shapes (H100, limit 232,448 bytes) it is staged: 14,528 bytes at
    trigram.  Raises ValueError where the plan does not fit."""
    need = kernels.entry("num_resident", "steady_fwd_shared_bytes")
    return _plan(("fwd", device.index, L, Tm1, S, W), lambda p: need(p, L, Tm1, S, W), None,
                 f"steady_forward: {S} states and {L} live arcs", device)


def steady_forward(
    alpha1: torch.Tensor,  # [B, S] alpha after the frame-0 step
    src: torch.Tensor,  # [B, T-1, S, Kr] steady slice (any integer dtype)
    lpdf: torch.Tensor,  # [B, T-1, S, Kr]
    logw: torch.Tensor,  # [B, T-1, S, Kr] f32
    ysm: torch.Tensor,  # [B, T-1, W] f32 emissions of frames 1..T-1
    pre: tuple | None = None,  # kernel_tables(src, lpdf, logw)
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3.  Returns (aT [B, S], alphas_rest [T-1, B, S]).  Launches
    csrc/num_resident.cu:num_steady_forward on a CUDA tensor, which walks
    the live-arc list of `pre` by destination; without `pre` the list is
    built here (one host sync, see `kernel_tables`).  Both plans
    (`steady_forward_plan`) give the same bits."""
    if alpha1.device.type == "cpu":
        return steady_forward_plain(alpha1, src, lpdf, logw, ysm)
    B, Tm1, S, Kr = src.shape
    W = ysm.shape[-1]
    kernels.check_tensor("alpha1", alpha1, torch.float32, (B, S))
    ysm = _rows(ysm, alpha1, B, Tm1)
    if Tm1 == 0:
        return alpha1, alpha1.new_empty((0, B, S))
    if pre is None:
        pre = kernel_tables(src, lpdf, logw)
    _, arcs, dst_off = pre
    L = arcs.shape[1]
    kernels.check_tensor("arcs", arcs, torch.int32, (B, L, 4))
    kernels.check_tensor("dst_off", dst_off, torch.int32, (B, Tm1, S + 1))
    dev = alpha1.device
    _, staged = steady_forward_plan(L, Tm1, S, W, dev)
    out = torch.empty((Tm1, B, S), device=dev, dtype=torch.float32)
    lib = kernels.library("num_resident")
    err = lib.num_steady_forward(
        arcs.data_ptr(), dst_off.data_ptr(), L, ysm.data_ptr(), ysm.stride(0), ysm.stride(1),
        alpha1.data_ptr(), out.data_ptr(), B, Tm1, S, W, staged,
        min(1024, 32 * -(-S // 32)), kernels.stream_of(dev),
    )
    kernels.check(lib, err, "num_steady_forward")
    steady_forward.launches += 1
    return out[-1], out


steady_forward.launches = 0


# ---------------------------------------------------------------------------
# K4: backward
# ---------------------------------------------------------------------------


def steady_backward_plain(src, lpdf, logw, ysm, alphas, final_logw, log_p):
    """Plain PyTorch K4: the beta recursion as a reverse loop over frames."""
    src, lpdf = src.long(), lpdf.long()
    Tm1 = src.shape[1]
    beta, gsm = final_logw, [None] * Tm1
    for t in range(Tm1 - 1, -1, -1):
        beta, gsm[t] = backward_step(
            beta, ysm[:, t], src[:, t], lpdf[:, t], logw[:, t], alphas[t], log_p
        )
    if not gsm:
        return final_logw, final_logw.new_empty((0, ysm.shape[0], ysm.shape[-1]))
    return beta, torch.stack(gsm)


def steady_plan(L: int, Tm1: int, S: int, A: int, W: int, device,
                staged: int | None = None) -> tuple[int, int]:
    """Bytes of shared memory a K4 block asks for, and whether it stages
    its sequence's whole live list there (1) or streams each frame's records
    through two buffers of A = S * Kr records (0): staged wherever that fits
    under `shared_limit`, unless `staged` asks for one plan.  At the
    shipped shapes (H100, limit 232,448 bytes) the list is staged.  The
    streamed plan takes about 40 bytes an arc slot, so it holds up to about
    5,800 slots on the H100; raises ValueError where the plan does not fit."""
    need = kernels.entry("num_resident", "steady_shared_bytes")
    return _plan(("bwd", device.index, L, Tm1, S, A, W, staged),
                 lambda p: need(p, L, Tm1, S, A, W), staged,
                 f"steady_backward: S*Kr = {A} arc slots", device)


def steady_backward(
    src: torch.Tensor,  # [B, T-1, S, Kr] steady slice (frames 1..T-1)
    lpdf: torch.Tensor,
    logw: torch.Tensor,
    ysm: torch.Tensor,  # [B, T-1, W] emissions of frames 1..T-1
    alphas: torch.Tensor,  # [T-1, B, S] alphas of frames 1..T-1 (sources)
    final_logw: torch.Tensor,  # [B, S]
    log_p: torch.Tensor,  # [B] (may be non-finite)
    pre: tuple | None = None,  # kernel_tables(src, lpdf, logw)
    staged: int | None = None,  # K4's plan; None: chosen by size (steady_plan)
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4.  Returns (beta1 [B, S], gsm_rest [T-1, B, W]).  Launches
    csrc/num_resident.cu:num_steady_backward on a CUDA tensor, which walks
    the live-arc list of `pre`; without `pre` the list is built here (one
    host sync, see `kernel_tables`).  Both plans give the same bits."""
    if final_logw.device.type == "cpu":
        return steady_backward_plain(src, lpdf, logw, ysm, alphas, final_logw, log_p)
    B, Tm1, S, Kr = src.shape
    W = ysm.shape[-1]
    kernels.check_tensor("final_logw", final_logw, torch.float32, (B, S))
    kernels.check_tensor("alphas", alphas, torch.float32, (Tm1, B, S))
    kernels.check_tensor("log_p", log_p, torch.float32, (B,))
    ysm = _rows(ysm, final_logw, B, Tm1)
    if Tm1 == 0:
        return final_logw, final_logw.new_empty((0, B, W))
    if pre is None:
        pre = kernel_tables(src, lpdf, logw)
    arc_off, arcs, _ = pre
    L = arcs.shape[1]
    kernels.check_tensor("arc_off", arc_off, torch.int32, (B, Tm1 + 1))
    kernels.check_tensor("arcs", arcs, torch.int32, (B, L, 4))
    dev = final_logw.device
    _, staged = steady_plan(L, Tm1, S, S * Kr, W, dev, staged)
    gsm = torch.empty((Tm1, B, W), device=dev, dtype=torch.float32)
    beta1 = torch.empty((B, S), device=dev, dtype=torch.float32)
    lib = kernels.library("num_resident")
    err = lib.num_steady_backward(
        arcs.data_ptr(), arc_off.data_ptr(), L, ysm.data_ptr(), ysm.stride(0), ysm.stride(1),
        alphas.data_ptr(), final_logw.data_ptr(), log_p.data_ptr(), gsm.data_ptr(),
        beta1.data_ptr(), B, Tm1, S, S * Kr, W, staged, _steady_bwd_threads(S, W),
        kernels.stream_of(dev),
    )
    kernels.check(lib, err, "num_steady_backward")
    steady_backward.launches += 1
    return beta1, gsm


steady_backward.launches = 0


# ---------------------------------------------------------------------------
# K8f / K8b: the flat-start (e2e) recursions over cyclic per-sequence graphs
# whose tables are constant over time.  Port of torchain_tpu/ops/
# num_resident.py (`e2e_forward_resident`, `e2e_backward_resident`):
#
#   * K8f: alpha_0 = (0, -inf, ...); next[s] = lse_k(alpha[src[s, k]] +
#     logw[s, k] + ylocal[t, s, k]) over the arcs with src >= 0; -inf for a
#     state without arcs.
#   * K8b, frames in reverse, beta = final_logw: arc_w = (logw + ylocal[t])
#     + beta[s]; post[t, s, k] = exp(alpha_t[src] + arc_w - log_p);
#     beta_prev[s'] = lse of arc_w over the arcs with src == s'.  A sequence
#     whose log_p is not finite gets exactly zero posteriors.
#
# Emissions arrive per arc (ops/num_e2e.py `_arc_emissions`), [B, T, S, K]
# float32.  On a CUDA tensor each is one launch of csrc/num_e2e.cu (one
# thread block per sequence, all frames); on a CPU tensor the plain version
# beside it loops over frames.  The kernels read `e2e_kernel_tables(src,
# logw)`, prepared once when a batch is placed
# (`DeviceE2eSupervision.with_kernel_tables`) and taken as `pre`.
# ---------------------------------------------------------------------------


def e2e_kernel_tables(src: torch.Tensor, logw: torch.Tensor):
    """The tables of one batch as K8f/K8b read them, from src [B, S, K] (any
    integer dtype, -1 = pad) and logw [B, S, K]:

      src int32 [B, S, K], logw float32 [B, S, K];
      in_off int32 [B, S + 1], in_arc int32 [B, L]: each sequence's live
        slots (s * K + k) in slot order, which is destination order (K8f),
        and where each destination's run starts; a shorter list ends in
        zeros;
      by_off int32 [B, S + 1], by_arc int32 [B, L]: the same slots ordered
        by source state, slot order within one source, and where each
        source's run starts (K8b; the tail of a shorter list is unused).

    L is the most live slots of any sequence, at least 1.  Sizing the lists
    reads one number back to the host (a sync): call it where a batch is
    placed, not inside a step."""
    B, S, K = src.shape
    src32 = src.to(torch.int32).contiguous()
    live = (src32 >= 0).reshape(B, S * K)
    L = max(1, int(live.sum(1).max())) if B else 1
    in_off = torch.zeros((B, S + 1), device=src.device, dtype=torch.int32)
    in_off[:, 1:] = torch.cumsum(live.view(B, S, K).sum(-1), 1)
    # each live slot's place in its sequence's list; pads go to column L,
    # which is dropped
    pos = torch.where(live, torch.cumsum(live, 1) - 1, L)
    slots = torch.arange(S * K, device=src.device, dtype=torch.int32).expand(B, S * K)
    in_arc = torch.zeros((B, L + 1), device=src.device, dtype=torch.int32)
    in_arc.scatter_(1, pos, slots)
    key = torch.where(live, src32.reshape(B, S * K), S).long()
    order = torch.argsort(key, dim=1, stable=True)
    counts = torch.zeros((B, S + 1), device=src.device, dtype=torch.int64)
    counts.scatter_add_(1, key, torch.ones_like(key))
    by_off = torch.zeros((B, S + 1), device=src.device, dtype=torch.int32)
    by_off[:, 1:] = torch.cumsum(counts[:, :S], 1)
    by_arc = order[:, :L].to(torch.int32).contiguous()
    return (src32, logw.to(torch.float32).contiguous(), in_off, in_arc[:, :L].contiguous(),
            by_off, by_arc)


#: K8f and K8b reduce a run of more arcs than this with several lanes (K8f
#: a group of 8, K8b a warp), a shorter one with one thread
#: (csrc/num_e2e.cu HEAVY_RUN)
E2E_HEAVY_RUN = 4

#: the library entry that gives K8f's and K8b's shared-memory limit
E2E_LIMIT = ("num_e2e", "e2e_shared_limit")


def e2e_forward_plan(L: int, S: int, device) -> tuple[int, int]:
    """Bytes of shared memory a K8f block asks for, and whether it stages
    its sequence's live list (records and a ring of per-frame ylocal values)
    there (1) or keeps only the offsets, the heavy states and alpha there
    and reads the rest from device memory (0): staged wherever that fits
    under `shared_limit` (on the H100 up to about 7,200 live arcs a
    sequence at S = 55).  Raises ValueError where the plan does not fit."""
    need = kernels.entry("num_e2e", "e2e_forward_shared_bytes")
    return _plan(("e2e_fwd", device.index, L, S), lambda p: need(p, L, S), None,
                 f"e2e_forward_resident: {S} states and {L} live arcs", device, E2E_LIMIT)


def e2e_forward_plain(ylocal, src, logw):
    """Plain PyTorch K8f: the alpha recursion as a loop over frames."""
    B, T, S, _ = ylocal.shape
    src = src.long()
    live = src >= 0
    warc = torch.where(live, logw, 0.0)
    alpha = torch.full((B, S), NEG_INF, device=ylocal.device)
    alpha[:, 0] = 0.0
    out = ylocal.new_empty((T, B, S))
    for t in range(T):
        vals = select_src(alpha, src) + warc + torch.where(live, ylocal[:, t], 0.0)
        alpha = out[t] = torch.logsumexp(vals, dim=-1)
    return out


def e2e_forward_resident(
    ylocal: torch.Tensor,  # [B, T, S, K] f32 per-arc emission log-probs
    src: torch.Tensor,  # [B, S, K] (any integer dtype)
    logw: torch.Tensor,  # [B, S, K] f32
    pre: tuple | None = None,  # e2e_kernel_tables(src, logw)
) -> torch.Tensor:
    """K8f.  Returns the alphas of frames 1..T, [T, B, S] (the frame-0
    alpha is set inside).  Launches csrc/num_e2e.cu:e2e_forward on a CUDA
    tensor, which walks the by-destination list of `pre`; without `pre` the
    lists are built here (one host sync, see `e2e_kernel_tables`).  Both
    plans (`e2e_forward_plan`) give the same bits."""
    if ylocal.device.type == "cpu":
        return e2e_forward_plain(ylocal, src, logw)
    B, T, S, K = ylocal.shape
    kernels.check_tensor("ylocal", ylocal, torch.float32)
    if pre is None:
        pre = e2e_kernel_tables(src, logw)
    src32, logw32, in_off, in_arc, _, _ = pre
    L = in_arc.shape[-1]
    kernels.check_tensor("src", src32, torch.int32, (B, S, K))
    kernels.check_tensor("logw", logw32, torch.float32, (B, S, K))
    kernels.check_tensor("in_off", in_off, torch.int32, (B, S + 1))
    kernels.check_tensor("in_arc", in_arc, torch.int32, (B, L))
    out = torch.empty((T, B, S), device=ylocal.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out
    lib = kernels.library("num_e2e")
    _, staged = e2e_forward_plan(L, S, ylocal.device)
    err = lib.e2e_forward(
        ylocal.data_ptr(), src32.data_ptr(), logw32.data_ptr(), in_off.data_ptr(),
        in_arc.data_ptr(), out.data_ptr(), B, T, S, K, L, staged,
        kernels.stream_of(ylocal.device),
    )
    kernels.check(lib, err, "e2e_forward")
    e2e_forward_resident.launches += 1
    return out


e2e_forward_resident.launches = 0


def e2e_backward_plan(L: int, S: int, device, staged: int | None = None) -> tuple[int, int]:
    """Bytes of shared memory a K8b block asks for, and whether it stages
    its sequence's live list (records and a ring of per-frame inputs) there
    (1) or keeps only beta there and reads the rest from device memory (0):
    staged wherever that fits under the device's opt-in limit (on the H100
    up to about 7,200 live arcs a sequence at S = 55), unless `staged` asks
    for one plan.  Raises ValueError where the plan does not fit."""
    need = kernels.entry("num_e2e", "e2e_backward_shared_bytes")
    return _plan(("e2e_bwd", device.index, L, S, staged), lambda p: need(p, L, S), staged,
                 f"e2e_backward_resident: {S} states and {L} live arcs", device, E2E_LIMIT)


def e2e_backward_plain(ylocal, alphas, src, logw, final_logw, log_p):
    """Plain PyTorch K8b: the beta recursion as a reverse loop over frames."""
    B, T, S, K = ylocal.shape
    src = src.long()
    live = src >= 0
    valid = torch.isfinite(log_p)
    safe_logp = torch.where(valid, log_p, 0.0)[:, None, None]
    hit = src[..., None] == torch.arange(S, device=ylocal.device)  # [B, S, K, S']
    beta = final_logw
    post = ylocal.new_empty((B, T, S, K))
    for t in range(T - 1, -1, -1):
        arc_w = torch.where(live, logw + ylocal[:, t], NEG_INF) + beta[:, :, None]
        post[:, t] = torch.where(
            valid[:, None, None],
            torch.exp(select_src(alphas[t], src) + arc_w - safe_logp),
            0.0,
        )
        beta = torch.logsumexp(torch.where(hit, arc_w[..., None], NEG_INF), dim=(1, 2))
    return post


def e2e_backward_resident(
    ylocal: torch.Tensor,  # [B, T, S, K] f32
    alphas: torch.Tensor,  # [T, B, S] alphas of frames 0..T-1 (sources)
    src: torch.Tensor,  # [B, S, K]
    logw: torch.Tensor,  # [B, S, K]
    final_logw: torch.Tensor,  # [B, S]
    log_p: torch.Tensor,  # [B] (may be non-finite)
    pre: tuple | None = None,  # e2e_kernel_tables(src, logw)
    staged: int | None = None,  # K8b's plan; None: chosen by size (e2e_backward_plan)
) -> torch.Tensor:
    """K8b.  Returns the per-arc posteriors [B, T, S, K] (exact zeros for a
    sequence whose log_p is not finite).  Launches
    csrc/num_e2e.cu:e2e_backward on a CUDA tensor.  Both plans give the
    same bits."""
    if ylocal.device.type == "cpu":
        return e2e_backward_plain(ylocal, alphas, src, logw, final_logw, log_p)
    B, T, S, K = ylocal.shape
    kernels.check_tensor("ylocal", ylocal, torch.float32)
    kernels.check_tensor("alphas", alphas, torch.float32, (T, B, S))
    kernels.check_tensor("final_logw", final_logw, torch.float32, (B, S))
    kernels.check_tensor("log_p", log_p, torch.float32, (B,))
    if pre is None:
        pre = e2e_kernel_tables(src, logw)
    src32, logw32, _, _, by_off, by_arc = pre
    L = by_arc.shape[-1]
    kernels.check_tensor("src", src32, torch.int32, (B, S, K))
    kernels.check_tensor("logw", logw32, torch.float32, (B, S, K))
    kernels.check_tensor("by_off", by_off, torch.int32, (B, S + 1))
    kernels.check_tensor("by_arc", by_arc, torch.int32, (B, L))
    # written in full by the kernel, its pad slots as zeros
    post = torch.empty((B, T, S, K), device=ylocal.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return post
    lib = kernels.library("num_e2e")
    _, staged = e2e_backward_plan(L, S, ylocal.device, staged)
    err = lib.e2e_backward(
        ylocal.data_ptr(), alphas.data_ptr(), src32.data_ptr(), logw32.data_ptr(),
        final_logw.data_ptr(), log_p.data_ptr(), by_off.data_ptr(), by_arc.data_ptr(),
        post.data_ptr(), B, T, S, K, L, staged, kernels.stream_of(ylocal.device),
    )
    kernels.check(lib, err, "e2e_backward")
    e2e_backward_resident.launches += 1
    return post


e2e_backward_resident.launches = 0
