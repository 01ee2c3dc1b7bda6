#!/usr/bin/env python3
"""Drive the PyTorch port (torchain_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--kernels-only] [--profile] [--out DIR]

Phases, in order; any failure exits non-zero before the last line:

  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from torchain_tpu_torch/csrc (eight sources,
     one nvcc each, in parallel) and print the build time and each kernel's
     register use;
  3. hold each of the fifteen kernels against its plain PyTorch version on
     the card and time it device-only (CUDA events, the calls queued behind
     a sleep of the card; 3 rounds, medians), in turns with one PyTorch
     library call computing the same function where one exists, beside the
     kernel's bound: the six chain-loss kernels of the standard supervision
     at the shapes of both graphs (B=128, T_out=50; the bench's trigram
     graph, P=80, and its production graph, a 4-gram phone LM over a
     left-biphone tree, P=1680; K5 and K6 also at P=83, and with the host's
     microseconds per call),
     the flat-start numerator kernels at the e2e batches of both corpora,
     the fused dense-denominator kernels at the trigram graph's Moore form
     (also against the matrix-product recursion of ops/den_dense.py), the
     attention and feed-forward kernels at the conformer's shapes (qkv
     [128, 50, 768], 4 heads; xn [6400, 256], F=1024) with bfloat16 and with
     float32 operands, and the shared-memory probe against the device's
     opt-in limit;
  4. six paths, each a full-width model trained for a few steps with the
     LF-MMI chain loss on one replayed batch through `make_train_step`:
     (a) TDNN-F (9 layers, hidden 768, bottleneck 96, prefinal 256) on the
     trigram graph with a float32 trunk, (b) the same on the production
     graph with a bfloat16 trunk, (c) the conformer (8 blocks x 256, 4
     heads, F=1024, conv kernel 15, bfloat16 trunk) on the trigram graph,
     (d) the same with the fused feed-forward (`ffn_impl="fused"`), (e)
     flat-start training: (a)'s model on whole-utterance e2e supervision
     (`E2eChainDataset`), (f) (a) with the dense Moore denominator in its
     fused form.  Every kernel launch counter is zeroed just before a path
     and read just after, each kernel of that path must have moved and no
     other, and the loss must fall; (d)'s first loss must agree with (c)'s
     and (f)'s with (a)'s;
  5. a reference check on a small input for each path: the first-step loss
     and gradient norm on the card (kernels) against the CPU (plain
     versions);
  6. one JSON line of kernel records, the nvidia-smi line, and the final
     line `{"ok": true, "device": {...}}`.

It imports torch, numpy and torchain_tpu_torch only.  Without a CUDA
device, or outside a checkout of the repository, it fails.  With `--out`,
the full result is also written to DIR/chip_smoke.json (and each path's
profile table to DIR/profile_<path>.txt).
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import math
import pathlib
import subprocess
import sys
import time

#: published H100 SXM peaks (NVIDIA data sheet): float32 outside the
#: tensor cores, dense bfloat16 in the tensor cores (the peak for products
#: of bfloat16 operands, whatever unit a kernel uses), dense TF32 in the
#: tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
#: TF32 products per float32 product in K10's 3xTF32 form (hi.hi + hi.lo +
#: lo.hi): its float32 operations are bounded at PEAK_TF32_FLOPS / 3
TF32_PRODUCTS = 3

B, T_OUT = 128, 50
LAYERS = 9


def _log(*a):
    print(*a, flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls (CUDA events), after one warm-up
    call, with the calls enqueued as they come: where the host takes longer
    to enqueue a call than the card to run it, this is the host's time.
    Used for plain versions only, which are no yardstick."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls (CUDA events), with the
    calls queued behind a sleep of the card so that the host's launch
    overhead is not timed.  If the card woke before the host had queued
    every call (the start event had completed: the host was slower than
    the sleep, or the stream's queue of launches filled, as a call of a
    thousand launches does), the calls are timed again behind a sleep twice
    as long and half as many of them (at least one)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 200_000_000  # about 0.1 s
    for _ in range(6):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles, reps = 2 * cycles, max(1, reps // 2)
    raise AssertionError("the host could not queue the timed calls within the card's sleep")


def _alternate(fns: dict, reps: int, rounds: int = 3) -> dict[str, dict]:
    """Device ms of each of `fns` (name -> callable), timed in turn for
    `rounds` rounds within one call: every round times every function once.
    Returns name -> {"median": ..., "rounds": [...]}."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(_device_ms(fn, reps))
    return {name: dict(median=sorted(t)[len(t) // 2], rounds=t) for name, t in times.items()}


def _times(kernel, reps: int, library=None, plain=None, plain_reps: int = 0) -> dict:
    """A kernel's device ms, in turn with its library call where one exists
    (`_alternate`: 3 rounds, medians), and its plain version's: in the same
    turns where `plain_reps` is 0, else with `_time_ms` over `plain_reps`
    calls.  Returns the fields of a kernel record."""
    fns = dict(kernel=kernel)
    if library is not None:
        fns["library"] = library
    if not plain_reps:
        fns["plain"] = plain
    t = _alternate(fns, reps)
    out = dict(ms=t["kernel"]["median"], ms_rounds=t["kernel"]["rounds"],
               library_ms=None, timing="device, alternated")
    if library is not None:
        out.update(library_ms=t["library"]["median"], library_ms_rounds=t["library"]["rounds"])
    if plain_reps:
        out["plain_ms"] = _time_ms(plain, plain_reps)
    else:
        out.update(plain_ms=t["plain"]["median"], plain_ms_rounds=t["plain"]["rounds"])
    return out


def _captured(fn):
    """`fn` captured once as a CUDA graph: returns a callable that replays it
    (one launch, the same kernels).  For a call of more launches than the
    stream's queue holds behind `_device_ms`'s sleep."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _host_us(fn, calls: int = 200) -> float:
    """Host-clock microseconds per call, over `calls` calls enqueued on an
    idle card (the queue does not fill, so no call waits for the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _check(name: str, what: str, got, want, atol: float, rtol: float) -> dict:
    """Hold `got` (kernel) against `want` (plain version) element by element,
    |got - want| <= atol + rtol * |want|, with the same non-finite entries.
    Raises on disagreement; returns the errors for the kernels record."""
    import torch

    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{name}: {what} differs from the plain version in non-finite entries")
    diff = (got[fin] - want[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    worst = float((diff - rtol * want[fin].abs()).max()) if diff.numel() else 0.0
    _log(f"kernel {name}: {what} max_abs_err {err:.3g} (atol {atol:g}, rtol {rtol:g})")
    if not worst <= atol:
        raise AssertionError(f"{name}: {what} disagrees with the plain version")
    return dict(what=what, max_abs_err=err, atol=atol, rtol=rtol)


DEN = ("den_forward", "den_backward")
NUM = ("num_steady_forward", "num_steady_backward", "vocab_gather", "vocab_scatter")
DEN_NUM = DEN + NUM
ATTENTION = ("attention_forward", "attention_backward")
FFN = ("ffn_forward", "ffn_backward")
E2E = ("e2e_forward", "e2e_backward")
DENSE = ("dense_den_forward", "dense_den_backward")
PROBE = ("probe_smem",)

#: the paths: the two configurations of bench.py (its main one, `_build` on
#: the trigram corpus of `main`, and `production_config`) with the TDNN-F,
#: and the conformer that tools/ab_conformer5.py and tools/bench_matrix.py
#: measure on the trigram corpus, with both feed-forward lowerings; then the
#: TDNN-F on the trigram corpus with flat-start supervision
#: (`python -m torchain_tpu.cli.train --e2e`) and with the dense Moore
#: denominator in its fused form (the JAX package's TORCHAIN_USE_PALLAS=1).
#: `kernels` are those a path must launch; `sup` and `den` name the
#: supervision and the denominator form where they are not the standard ones
PATHS = {
    "trigram": dict(corpus=dict(lm_order=3, lm_extra_states=1000), dtype="float32",
                    model="tdnnf", kernels=DEN_NUM),
    "production": dict(corpus=dict(context_width=2, lm_order=4, lm_extra_states=2000),
                       dtype="bfloat16", model="tdnnf", kernels=DEN_NUM),
    "conformer": dict(corpus=dict(lm_order=3, lm_extra_states=1000), dtype="bfloat16",
                      model="conformer", ffn_impl="dense", kernels=DEN_NUM + ATTENTION),
    "conformer_ffn": dict(corpus=dict(lm_order=3, lm_extra_states=1000), dtype="bfloat16",
                          model="conformer", ffn_impl="fused",
                          kernels=DEN_NUM + ATTENTION + FFN),
    "e2e": dict(corpus=dict(lm_order=3, lm_extra_states=1000), dtype="float32",
                model="tdnnf", sup="e2e", kernels=DEN + E2E),
    "dense": dict(corpus=dict(lm_order=3, lm_extra_states=1000), dtype="float32",
                  model="tdnnf", den="dense_fused", kernels=DENSE + NUM),
}

#: the conformer of the conformer paths
CONFORMER = dict(dim=256, num_layers=8, num_heads=4)


@functools.lru_cache(maxsize=None)
def _corpus(seed: int, options: tuple):
    """The synthetic corpus over 40 phones for one graph (made once: the
    trigram one serves three paths)."""
    from torchain_tpu_torch.data import synthetic_dataset

    return synthetic_dataset(
        num_utts=2 * B,
        num_phones=40,
        feat_dim=40,
        utt_frames_out=(T_OUT, T_OUT + 10),
        seed=seed,
        **dict(options),
    )


def build_path(name: str, seed: int):
    """One configuration: the path's corpus, the full-width model config in
    the path's trunk dtype, and a dataset of T_out=50: a ChainDataset of
    chunks or, for flat-start supervision, an E2eChainDataset of whole
    utterances trimmed to that length."""
    import torch

    from torchain_tpu_torch.models import ConformerConfig, TdnnfConfig

    path = PATHS[name]
    corpus = _corpus(seed, tuple(sorted(path["corpus"].items())))
    dtype = getattr(torch, path["dtype"])
    if path["model"] == "conformer":
        cfg = ConformerConfig(num_pdfs=corpus.tree.num_pdfs, dtype=dtype,
                              ffn_impl=path["ffn_impl"], **CONFORMER)
    else:
        cfg = TdnnfConfig(
            num_pdfs=corpus.tree.num_pdfs,
            hidden_dim=768,
            bottleneck_dim=96,
            prefinal_dim=256,
            num_layers=LAYERS,
            dtype=dtype,
        )
    return corpus, cfg, make_dataset(corpus, cfg, path.get("sup") == "e2e")


def make_dataset(corpus, cfg, e2e: bool):
    """Batches of T_out=50 with the model's acoustic context."""
    from torchain_tpu_torch.data import ChainDataset, E2eChainDataset
    from torchain_tpu_torch.graphs import SupervisionOptions

    left, right = cfg.context
    common = dict(chunk_frames_out=T_OUT, left_context=left, right_context=right)
    if e2e:
        return E2eChainDataset(corpus.utts, corpus.tree, corpus.norm_fst, **common)
    return ChainDataset(
        corpus.utts, corpus.tree, corpus.norm_fst,
        sup_opts=SupervisionOptions(left_tolerance=2, right_tolerance=2), **common,
    )


def place(path: str, corpus, batch, device):
    """The path's denominator graph and the batch's supervision on `device`,
    each in the form the path names."""
    from torchain_tpu_torch.ops import (
        DeviceDenseDenGraph,
        DeviceE2eSupervision,
        DeviceSupervision,
        auto_den_graph,
    )

    if PATHS[path].get("den") == "dense_fused":
        den = DeviceDenseDenGraph.from_host(corpus.dense_den, device=device, fused=True)
    else:
        den = auto_den_graph(corpus.den_graph, device=device)
    cls = DeviceE2eSupervision if PATHS[path].get("sup") == "e2e" else DeviceSupervision
    return den, cls.from_host(batch.sup, device=device).with_kernel_tables()


def make_model(cfg, feat_dim: int, device, seed: int):
    """The path's model with weights drawn from `seed`."""
    import torch

    from torchain_tpu_torch.models import TDNNF, Conformer, ConformerConfig

    cls = Conformer if isinstance(cfg, ConformerConfig) else TDNNF
    return cls(cfg, feat_dim, device=device, generator=torch.Generator().manual_seed(seed))


def _record(measured, name, label, checks, times: dict, flops, nbytes,
            peak_flops=PEAK_F32_FLOPS, **extra):
    """Log and keep one kernel's record: its checks, its `_times`, its bound
    and any extra numbers."""
    bound_ms, bound_by = _bound(flops, nbytes, peak_flops)
    ms, lib_ms = times["ms"], times["library_ms"]
    _log(
        f"kernel {name} [{label}]: {ms:.5f} ms  plain {times['plain_ms']:.5f} ms"
        f"  bound {bound_ms:.6f} ms ({bound_by})"
        + (f"  library {lib_ms:.5f} ms" if lib_ms is not None else "")
        + "".join(f"  {k} {v:.5f}" for k, v in extra.items())
    )
    measured[name] = dict(
        max_abs_err=max(c["max_abs_err"] for c in checks),
        bound_ms=bound_ms, bound_by=bound_by, checks=checks, **times, **extra,
    )


def occupancies(rng, vocab):
    """Vocabulary-space occupancies gsm [T, B, W] for `vocab` [B, T, W]:
    random on its real slots, exactly 0.0 on its pads (the repeats of pdf 0
    after the sorted prefix), as num_backward leaves them."""
    import numpy as np
    import torch

    B, T, W = vocab.shape
    valid = torch.ones_like(vocab, dtype=torch.bool)
    valid[..., 1:] = vocab[..., 1:] > vocab[..., :-1]
    gsm = torch.as_tensor(rng.random(size=(T, B, W)).astype(np.float32), device=vocab.device)
    return torch.where(valid.transpose(0, 1), gsm, 0.0).contiguous()


def vocab_case(rng, B: int, T: int, W: int, P: int, device):
    """A vocabulary [B, T, W] int32 over P pdfs in the supervision's form
    (per row a sorted run of distinct pdfs, padded with pdf 0) and its
    occupancies [T, B, W] (0.0 on the pads).  Row (0, 0) is pads alone;
    the runs of rows with b % 3 == 1 start at pdf 0, those with b % 3 == 2
    end at pdf P - 1."""
    import numpy as np
    import torch

    n = rng.integers(1, W + 1, size=(B, T))
    n[0, 0] = 0
    real = np.arange(W) < n[..., None]
    pick = np.argsort(rng.random(size=(B, T, P)), axis=-1)[..., :W]
    v = np.sort(np.where(real, pick, P), axis=-1)
    v[1::3, :, 0] = 0
    last = np.maximum(n - 1, 0)[2::3]
    np.put_along_axis(v[2::3], last[..., None], P - 1, axis=-1)
    v = np.where(real, v, 0)
    g = np.where(real, rng.random(size=(B, T, W)), 0.0).astype(np.float32)
    return (torch.as_tensor(v, dtype=torch.int32, device=device),
            torch.as_tensor(g.transpose(1, 0, 2).copy(), device=device))


def check_vocab(y, vocab, gsm, label: str):
    """K5 and K6 against their plain versions, bit for bit.  Returns the
    two kernels' checks; raises on disagreement."""
    import torch

    from torchain_tpu_torch.ops import num_scan as ns

    P = y.shape[-1]
    ys_k = ns.vocab_gather(y, vocab)
    g_k = ns.vocab_scatter(gsm, vocab, P)
    torch.cuda.synchronize()
    return (
        [_check(f"vocab_gather [{label}]", "ysmall", ys_k, ns.vocab_gather_plain(y, vocab),
                0.0, 0.0)],
        [_check(f"vocab_scatter [{label}]", "gamma_num", g_k,
                ns.vocab_scatter_plain(gsm, vocab, P), 0.0, 0.0)],
    )


def check_kernels(den, sup, seed: int, path: str) -> dict[str, dict]:
    """Phase 3, chain loss: each of K1-K6 against its plain version at one
    graph's shapes, with times.  Returns the measurements by kernel name;
    raises on disagreement."""
    import numpy as np
    import torch

    from torchain_tpu_torch.ops import den_resident as dr
    from torchain_tpu_torch.ops import num_resident as nr
    from torchain_tpu_torch.ops import num_scan as ns

    dev = den.V.device
    P, S, K = den.num_pdfs, den.num_states, den.num_slots
    KS = K * S
    W = sup.frame_vocab.shape[-1]
    T = T_OUT
    rng = np.random.default_rng(seed)
    # log-probs of the scale a fresh network emits
    y = torch.as_tensor(rng.normal(size=(B, T, P)).astype(np.float32), device=dev)
    leaky = 0.1
    measured = {}

    def record(name, checks, times, flops, nbytes, **extra):
        _record(measured, name, path, checks, times, flops, nbytes, **extra)

    # K1: denominator forward
    yt = y.transpose(0, 1)
    ymax = yt.max(-1).values.contiguous()
    p = torch.exp(yt - ymax[..., None]).contiguous()
    args1 = (p, den.V, den.slot_pdf, den.init, leaky)
    logc_k, ah_k = dr.den_forward_kernel(*args1)
    torch.cuda.synchronize()
    logc_p, ah_p = dr.den_forward_plain(*args1)
    torch.cuda.synchronize()
    # f32 sums of S (2176 or 3968) products in another order, carried over
    # 50 frames through the per-frame renormalisation.  log c is O(1); ah
    # sums to 1 over the KS = 2 S slots of a frame, so its entries are held
    # relative to their size (atol only for entries near 0).
    checks1 = [
        _check(f"den_forward [{path}]", "logc", logc_k, logc_p, 1e-5, 0.0),
        _check(f"den_forward [{path}]", "ah", ah_k, ah_p, 1e-6, 1e-4),
    ]
    # the bound counts the products this graph needs: V's nonzeros (the
    # kernels multiply the dense V, zeros included)
    nnz = int(torch.count_nonzero(den.V))
    record(
        "den_forward", checks1,
        _times(lambda: dr.den_forward_kernel(*args1), 5,
               plain=lambda: dr.den_forward_plain(*args1), plain_reps=5),
        2.0 * T * B * nnz,
        4.0 * (T * B * P + S * KS + KS + S + T * B * KS + T * B),
    )

    # K2: denominator backward, on the plain forward's residuals
    log_z = (logc_p.sum(0) + ymax.sum(0) + math.log1p(leaky)).contiguous()
    F = torch.cumsum(logc_p + ymax, 0).contiguous()
    args2 = (p, ah_p.contiguous(), F, ymax, log_z, den.V, den.slot_pdf,
             den.pdf_offsets, den.pdf_slots, den.init, leaky)
    g_k = dr.den_backward_kernel(*args2)
    torch.cuda.synchronize()
    g_p = dr.den_backward_plain(*args2)
    torch.cuda.synchronize()
    live = int(den.pdf_slots.numel())
    # gamma sums to 1 over the P pdfs of a frame: held relative to its
    # size, as ah is
    record(
        "den_backward",
        [_check(f"den_backward [{path}]", "gamma", g_k, g_p, 1e-5, 1e-4)],
        _times(lambda: dr.den_backward_kernel(*args2), 5,
               plain=lambda: dr.den_backward_plain(*args2), plain_reps=5),
        2.0 * (T - 1) * B * nnz + 3.0 * T * B * live,
        4.0 * (T * B * P + T * B * KS + 2 * T * B + B + S * KS + KS
               + P + 1 + live + S + B * T * P),
    )

    # K5 / K6: the batch's own vocabulary, and beside it a vocabulary of an
    # odd pdf count (P=83: rows not 16-byte aligned) with rows that hold pdf
    # 0, pdf P-1, or pads alone.  Exact: copies, and sums of the same slots
    # in the same order
    vocab = sup.frame_vocab
    gsm = occupancies(rng, vocab)
    checks5, checks6 = check_vocab(y, vocab, gsm, path)
    v83, g83 = vocab_case(rng, B, T, W, 83, dev)
    y83 = torch.as_tensor(rng.normal(size=(B, T, 83)).astype(np.float32), device=dev)
    c5, c6 = check_vocab(y83, v83, g83, f"{path}, P=83")
    ys_p = ns.vocab_gather_plain(y, vocab)
    vocab64 = vocab.long()
    gather = lambda: ns.vocab_gather(y, vocab)  # noqa: E731
    gather_lib = lambda: torch.gather(y, 2, vocab64)  # noqa: E731
    # bytes: the indices and the output, and of y the 32-byte sectors the
    # gather touches (at most one per index), not the whole of y
    record(
        "vocab_gather", checks5 + c5,
        _times(gather, 50, library=gather_lib,
               plain=lambda: ns.vocab_gather_plain(y, vocab), plain_reps=50),
        0.0,
        4.0 * 2 * B * T * W + min(4.0 * B * T * P, 32.0 * B * T * W),
        host_us=_host_us(gather), library_host_us=_host_us(gather_lib),
    )
    # the library call under K6's contract: gsm [T, B, W] in, its transpose
    # taken inside the call
    scatter = lambda: ns.vocab_scatter(gsm, vocab, P)  # noqa: E731
    scatter_lib = lambda: torch.zeros((B, T, P), device=dev).scatter_add_(  # noqa: E731
        2, vocab64, gsm.transpose(0, 1))
    record(
        "vocab_scatter", checks6 + c6,
        _times(scatter, 50, library=scatter_lib,
               plain=lambda: ns.vocab_scatter_plain(gsm, vocab, P), plain_reps=50),
        1.0 * B * T * W,
        4.0 * (2 * T * B * W + B * T * P),
        host_us=_host_us(scatter), library_host_us=_host_us(scatter_lib),
    )

    # K3 / K4: the steady frames 1..T-1 on the batch's own tables, with the
    # emissions of the seeded y, alpha1 from the frame-0 step, and sequence 1
    # made impossible (no final state, so log p = -inf)
    tables = (sup.in_src_r, sup.pdf_local_r, sup.in_logw_r)
    pre = sup.kernel_pre
    Sn, Kr = sup.max_states, sup.in_src_r.shape[-1]
    Tm1 = T - 1
    a0 = torch.full((B, Sn), -math.inf, device=dev)
    a0[:, 0] = 0.0
    alpha1 = nr.forward_step(a0, ys_p[:, 0], sup.in_src0, sup.pdf_local0, sup.in_logw0)
    ysm = ys_p[:, 1:]
    aT_k, rest_k = nr.steady_forward(alpha1, *tables, ysm, pre=pre)
    torch.cuda.synchronize()
    aT_p, rest_p = nr.steady_forward_plain(alpha1, *tables, ysm)
    arcs = int((sup.in_src_r >= 0).sum())
    table_bytes = 12.0 * B * Tm1 * Sn * Kr  # int32 src, int32 lpdf, f32 logw
    # f32 log-sum-exps of a few terms per state in another order, carried
    # over 49 frames; -inf (unreachable states) in the same places.  The
    # bound is bytes, each once; the 49 dependent frames set a latency floor
    # that it does not see.
    record(
        "num_steady_forward",
        [_check(f"num_steady_forward [{path}]", "alphas", rest_k, rest_p, 1e-5, 1e-5)],
        _times(lambda: nr.steady_forward(alpha1, *tables, ysm, pre=pre), 50,
               plain=lambda: nr.steady_forward_plain(alpha1, *tables, ysm), plain_reps=5),
        4.0 * arcs + 2.0 * B * Tm1 * Sn,
        table_bytes + 4.0 * (B * Tm1 * W + B * Sn + Tm1 * B * Sn),
    )
    final = sup.final_logw.clone()
    final[1] = -math.inf
    log_p = torch.logsumexp(aT_p + final, dim=-1)
    if not (torch.isneginf(log_p[1]) and int(torch.isfinite(log_p).sum()) == B - 1):
        raise AssertionError(f"num_steady_backward [{path}]: expected one impossible sequence")
    alphas = torch.cat([alpha1[None], rest_p[:-1]])
    args4 = (*tables, ysm, alphas, final, log_p)
    beta1_k, gsm_k = nr.steady_backward(*args4, pre=pre)
    torch.cuda.synchronize()
    beta1_p, gsm_p = nr.steady_backward_plain(*args4)
    if not bool((gsm_k[:, 1] == 0).all()):
        raise AssertionError(f"num_steady_backward [{path}]: the impossible sequence has occupancies")
    # occupancies are probabilities (each frame's sum to 1): atol 1e-6
    record(
        "num_steady_backward",
        [_check(f"num_steady_backward [{path}]", "beta1", beta1_k, beta1_p, 1e-5, 1e-5),
         _check(f"num_steady_backward [{path}]", "gsm", gsm_k, gsm_p, 1e-6, 1e-5)],
        _times(lambda: nr.steady_backward(*args4, pre=pre), 50,
               plain=lambda: nr.steady_backward_plain(*args4), plain_reps=5),
        8.0 * arcs + 2.0 * B * Tm1 * (Sn + W),
        table_bytes + 4.0 * (B * Tm1 * W + Tm1 * B * Sn + B * Sn + B + Tm1 * B * W + B * Sn),
    )
    return measured


def check_conformer_kernels(seed: int, dtype_name: str) -> dict[str, dict]:
    """Phase 3, conformer: K7f, K7b, K10f and K10b against their plain
    versions at the conformer path's shapes (B=128, T=50, 4 heads of 64;
    N = B*T = 6400 rows, D=256, F=1024) with operands of one dtype, with
    times.  Returns the measurements by kernel name; raises on
    disagreement."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from torchain_tpu_torch.ops import attention as at
    from torchain_tpu_torch.ops import fused_ffn as ff

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    bf16 = dtype == torch.bfloat16
    esz = 2 if bf16 else 4
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    D, H, Fh, T = CONFORMER["dim"], CONFORMER["num_heads"], 4 * CONFORMER["dim"], T_OUT
    dh, N = D // H, B * T_OUT
    rng = np.random.default_rng(seed)
    measured = {}

    def rand(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * scale, device=dev)

    # K7f / K7b.  qkv of the scale a LayerNorm followed by a fresh Dense
    # gives, the bias of the scale of a trained table
    label = f"conformer {dtype_name}"
    qkv, g = rand(B, T, 3 * D).to(dtype), rand(B, T, D).to(dtype)
    bias = rand(H, T, T, scale=0.3)
    scale = 1.0 / math.sqrt(dh)
    out_k = at.attention_forward(qkv, bias, H, scale)
    torch.cuda.synchronize()
    out_p = at.attention_forward_plain(qkv, bias, H, scale)
    # float32: sums of 64 and 50 float32 products in another order, outputs
    # of order 1.  bfloat16: both sides round the same float32 value up to
    # that reordering, so they sit at most one rounding step (2^-8) apart
    tol = (2e-2, 1e-2) if bf16 else (5e-5, 1e-5)
    q4, k4, v4 = at._heads(qkv, H)
    bias_t = bias.to(dtype)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=bias_t[None], scale=scale)
    _record(
        measured, "attention_forward", label,
        [_check(f"attention_forward [{label}]", "out", out_k, out_p, *tol)],
        _times(lambda: at.attention_forward(qkv, bias, H, scale), 50, library=sdpa,
               plain=lambda: at.attention_forward_plain(qkv, bias, H, scale), plain_reps=20),
        4.0 * B * H * T * T * dh,
        esz * (B * T * 3 * D + B * T * D) + 4.0 * H * T * T,
        peak,
        einsum_ms=_device_ms(lambda: at.reference_relpos_attention(qkv, bias, H, scale), 20),
    )
    dqkv_k, dbias_k = at.attention_backward(qkv, bias, g, H, scale)
    torch.cuda.synchronize()
    dqkv_p, dbias_p = at.attention_backward_plain(qkv, bias, g, H, scale)
    # dbias is a float32 sum over the 128 batch rows of terms of order 0.1,
    # from the same operands on both sides
    checks = [
        _check(f"attention_backward [{label}]", "dqkv", dqkv_k, dqkv_p, *tol),
        _check(f"attention_backward [{label}]", "dbias", dbias_k, dbias_p, 1e-4, 1e-4),
    ]
    # the library's way: autograd through the einsum formulation (backward only)
    qkv_r, bias_r = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    ref_out = at.reference_relpos_attention(qkv_r, bias_r, H, scale)
    _record(
        measured, "attention_backward", label, checks,
        _times(lambda: at.attention_backward(qkv, bias, g, H, scale), 20,
               library=lambda: torch.autograd.grad(ref_out, (qkv_r, bias_r), g,
                                                   retain_graph=True),
               plain=lambda: at.attention_backward_plain(qkv, bias, g, H, scale), plain_reps=20),
        10.0 * B * H * T * T * dh,
        esz * (2 * B * T * 3 * D + B * T * D) + 8.0 * H * T * T,
        peak,
    )
    del ref_out, qkv_r, bias_r

    # K10f / K10b.  xn as a LayerNorm leaves it, weights of the scale of
    # their initialiser (variance 1 / fan-in), cast to the trunk dtype.  The
    # products run on the tensor cores: bfloat16 at its peak, float32 as
    # three TF32 products each (the bound counts the operations it does)
    xn, res, gf = rand(N, D).to(dtype), rand(N, D).to(dtype), rand(N, D).to(dtype)
    w1, w2 = rand(D, Fh, scale=D ** -0.5).to(dtype), rand(Fh, D, scale=Fh ** -0.5).to(dtype)
    b1, b2 = rand(Fh, scale=0.1), rand(D, scale=0.1)
    ffn_peak, ffn_ops = (PEAK_BF16_FLOPS, 1) if bf16 else (PEAK_TF32_FLOPS, TF32_PRODUCTS)
    o_k = ff.ffn_forward(xn, res, w1, b1, w2, b2, 0.5)
    torch.cuda.synchronize()
    o_p = ff.ffn_forward_plain(xn, res, w1, b1, w2, b2, 0.5)
    # float32: sums of 256 and 1024 products in another order
    tol = (2e-2, 1e-2) if bf16 else (1e-4, 1e-4)

    def dense_chain(x, r, a1, c1, a2, c2):
        u = x @ a1 + c1.to(dtype)
        return r + 0.5 * ((u * torch.sigmoid(u)) @ a2 + c2.to(dtype))

    def record_ffn(name, checks, kernel, plain, library, flops, nbytes):
        """Kernel, plain version and library call timed in turn, with the
        kernel's achieved rate and the share of its bound it reaches."""
        t = _times(kernel, 20, library=library, plain=plain)
        bound_ms, _ = _bound(ffn_ops * flops, nbytes, ffn_peak)
        _record(measured, name, label, checks, t, ffn_ops * flops, nbytes, ffn_peak,
                tflops=flops / t["ms"] / 1e9, bound_fraction=bound_ms / t["ms"])

    record_ffn(
        "ffn_forward", [_check(f"ffn_forward [{label}]", "out", o_k, o_p, *tol)],
        lambda: ff.ffn_forward(xn, res, w1, b1, w2, b2, 0.5),
        lambda: ff.ffn_forward_plain(xn, res, w1, b1, w2, b2, 0.5),
        lambda: dense_chain(xn, res, w1, b1, w2, b2),
        4.0 * N * D * Fh, esz * (3 * N * D + 2 * D * Fh) + 4.0 * (Fh + D),
    )
    grads_k = ff.ffn_backward(xn, gf, w1, b1, w2, 0.5)
    torch.cuda.synchronize()
    grads_p = ff.ffn_backward_plain(xn, gf, w1, b1, w2, 0.5)
    # the weight and bias gradients are float32 sums over 6400 rows (entries
    # up to ~100).  With bfloat16 operands a hidden activation or a dh that
    # sits on a rounding boundary may round the other way (the float32
    # values differ in the last bit), which moves one term of a weight
    # gradient's sum by one bfloat16 step; db1 sums the unrounded dh
    wtol = (5e-2, 1e-3) if bf16 else (1e-3, 1e-4)
    tols = dict(dx=tol, dw1=wtol, db1=(1e-3, 1e-4), dw2=wtol, db2=(1e-3, 1e-4))
    checks = [_check(f"ffn_backward [{label}]", what, a, b, *tols[what])
              for what, a, b in zip(tols, grads_k, grads_p)]
    if not all(torch.equal(a, b) for a, b in zip(ff.ffn_backward(xn, gf, w1, b1, w2, 0.5),
                                                   grads_k)):
        raise AssertionError(f"ffn_backward [{label}]: two launches differ")
    leaves = [t.clone().requires_grad_() for t in (xn, w1, b1, w2, b2)]
    chain_out = dense_chain(leaves[0], res, *leaves[1:])
    record_ffn(
        "ffn_backward", checks,
        lambda: ff.ffn_backward(xn, gf, w1, b1, w2, 0.5),
        lambda: ff.ffn_backward_plain(xn, gf, w1, b1, w2, 0.5),
        lambda: torch.autograd.grad(chain_out, leaves, gf, retain_graph=True),
        10.0 * N * D * Fh,
        esz * (3 * N * D + 2 * D * Fh) + 4.0 * (Fh + 2 * D * Fh + Fh + D),
    )
    return measured


def check_e2e_kernels(sup, seed: int, label: str) -> dict[str, dict]:
    """Phase 3, flat-start numerator: K8f and K8b against their plain
    versions on one e2e batch's own tables, with the per-arc emissions of a
    seeded y, with times.  Returns the measurements by kernel name; raises
    on disagreement."""
    import numpy as np
    import torch

    from torchain_tpu_torch.ops import num_e2e as ne
    from torchain_tpu_torch.ops import num_resident as nr

    dev = sup.in_src.device
    Bs, S, K = sup.in_src.shape
    T, P = T_OUT, sup.num_pdfs
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(rng.normal(size=(Bs, T, P)).astype(np.float32), device=dev)
    ylocal = ne._arc_emissions(y, sup)
    src, logw, pre = sup.in_src, sup.in_logw, sup.kernel_pre
    live = int((src >= 0).sum())
    measured = {}
    rest_k = nr.e2e_forward_resident(ylocal, src, logw, pre=pre)
    torch.cuda.synchronize()
    rest_p = nr.e2e_forward_plain(ylocal, src, logw)
    # f32 log-sum-exps of a few terms per state in another order, carried
    # over 50 frames; -inf (unreachable states) in the same places.  The
    # bound is bytes, each once, and of ylocal the live slots only (pad slots
    # hold nothing the function needs); operations count live arcs.  The 50
    # dependent frames set a latency floor it does not see
    table_bytes = 8.0 * Bs * S * K + 4.0 * Bs * S  # int32 src, f32 logw, int32 nk
    _record(
        measured, "e2e_forward", label,
        [_check(f"e2e_forward [{label}]", "alphas", rest_k, rest_p, 1e-5, 1e-5)],
        _times(lambda: nr.e2e_forward_resident(ylocal, src, logw, pre=pre), 20,
               plain=lambda: nr.e2e_forward_plain(ylocal, src, logw), plain_reps=3),
        4.0 * T * live + 2.0 * Bs * T * S,
        4.0 * T * live + table_bytes + 4.0 * T * Bs * S,
    )
    # sequence 1 made impossible (no final state, so log p = -inf) and
    # sequence 2 given a NaN log p: exact zeros for both
    final = sup.final_logw.clone()
    final[1] = -math.inf
    log_p = torch.logsumexp(rest_p[-1] + final, dim=-1)
    if not (torch.isneginf(log_p[1]) and int(torch.isfinite(log_p).sum()) == Bs - 1):
        raise AssertionError(f"e2e_backward [{label}]: expected one impossible sequence")
    log_p[2] = math.nan
    a0 = torch.full((1, Bs, S), -math.inf, device=dev)
    a0[:, :, 0] = 0.0
    alphas = torch.cat([a0, rest_p[:-1]])
    args = (ylocal, alphas, src, logw, final, log_p)
    post_k = nr.e2e_backward_resident(*args, pre=pre)
    torch.cuda.synchronize()
    post_p = nr.e2e_backward_plain(*args)
    if not bool((post_k[1:3] == 0).all()):
        raise AssertionError(f"e2e_backward [{label}]: a sequence without a finite log p"
                             " has posteriors")
    if not bool(torch.equal(post_k, nr.e2e_backward_resident(*args, pre=pre))):
        raise AssertionError(f"e2e_backward [{label}]: two launches differ")
    # posteriors are probabilities: exp of a float32 sum of magnitude ~100,
    # whose last bit (8e-6) becomes that relative error; the betas inside
    # differ by the order of their log-sum-exps.  Bytes: ylocal's live
    # slots read, post written in full (its pad slots are zeros the contract
    # asks for)
    by_bytes = 4.0 * (Bs * (S + 1) + pre[4].numel())
    _record(
        measured, "e2e_backward", label,
        [_check(f"e2e_backward [{label}]", "post", post_k, post_p, 1e-5, 1e-4)],
        _times(lambda: nr.e2e_backward_resident(*args, pre=pre), 20,
               plain=lambda: nr.e2e_backward_plain(*args), plain_reps=3),
        8.0 * T * live + 2.0 * Bs * T * S,
        4.0 * T * live + 4.0 * Bs * T * S * K + 8.0 * Bs * S * K + by_bytes
        + 4.0 * (T * Bs * S + Bs * S + Bs),
    )
    return measured


def dense_forward_library(pe, den, leaky: float):
    """K9f's function (pe in, logc and sigma_hats out) as the frame loop of
    ops/den_dense.py runs it: cuBLAS products with V and the one-hot E_mat."""
    import torch

    from torchain_tpu_torch.ops.den_dense import leak

    T, Bs, _ = pe.shape
    sigma = den.init_orig.expand(Bs, den.num_orig)
    logc = pe.new_empty((T, Bs))
    sig = pe.new_empty((T, Bs, den.num_orig))
    for t in range(T):
        sig[t] = sigma
        alpha = (leak(sigma, den.init_orig, leaky) @ den.V) * pe[t]
        c = alpha.sum(-1, keepdim=True)
        logc[t] = torch.log(c[:, 0])
        sigma = (alpha / c) @ den.E_mat
    return logc, sig


def dense_backward_library(pe, den, sig, fscale, ymax_t, leaky: float):
    """K9b's function (gout out) as the frame loop of ops/den_dense.py runs
    it: cuBLAS products with V^T and E_mat^T."""
    import torch

    from torchain_tpu_torch.ops.den_dense import leak, leak_t

    T, Bs, E = pe.shape
    init = den.init_orig
    bh = pe.new_ones((Bs, E))
    G = pe.new_full((Bs, 1), math.log1p(leaky) if leaky > 0.0 else 0.0)
    gout = pe.new_empty((T, Bs, E))
    for t in range(T - 1, -1, -1):
        ah = pe[t] * (leak(sig[t], init, leaky) @ den.V)
        gout[t] = ah * bh * torch.exp(fscale[t][:, None] + G)
        nb = leak_t((pe[t] * bh) @ den.V.T, init, leaky) @ den.E_mat.T
        d = nb.max(-1, keepdim=True).values
        d = torch.where(d > 0, d, torch.ones_like(d))
        bh = nb / d
        G = G + ymax_t[t][:, None] + torch.log(d)
    return gout


def check_dense_kernels(den, y, label: str) -> dict[str, dict]:
    """Phase 3, dense Moore denominator: K9f and K9b against their plain
    versions at one graph, with the pe of `y` [B, T, P] (the path's own
    network output on its batch), and the whole fused recursion
    (ops/den_pallas.py) against the matrix-product recursion of
    ops/den_dense.py.  The library form they are timed against is that
    recursion's frame loop under the kernels' own contract (pe in; gout
    out), which it must match too; it is timed as one captured CUDA graph
    (its 50 frames are some 600 launches, more than the stream's queue
    holds behind the sleep of `_device_ms`).  Returns the measurements by
    kernel name; raises on disagreement."""
    import torch

    from torchain_tpu_torch.ops import den_dense as dd
    from torchain_tpu_torch.ops import den_pallas as dp

    S, E, T = den.num_orig, den.num_exp, y.shape[1]
    leaky = 0.1
    measured = {}
    log_z, res = dp.den_forward(y, den, leaky)  # K9f
    gamma = dp.den_backward(den, res, leaky)  # K9b
    torch.cuda.synchronize()
    pe, sig_k, logc_k = res["pe"], res["sigma_hats"], res["logc"]
    logc_p, sig_p = dp.dense_forward_plain(pe, den, leaky)
    logc_l, sig_l = dense_forward_library(pe, den, leaky)
    log_z_d, res_d = dd.den_forward(y, den, leaky)
    gamma_d = dd.den_backward(den, res_d, leaky)
    nnz = int(torch.count_nonzero(den.V))
    # f32 sums of S = 2176 products in another order, carried over 50 frames
    # through the per-frame renormalisation: log c is O(1), sigma_hats sums
    # to 1 over a frame's states (held relative to its size).  log Z, the
    # sum of 50 log c and 50 ymax, is of order 100
    checks = [
        _check(f"dense_den_forward [{label}]", "logc", logc_k, logc_p, 1e-5, 0.0),
        _check(f"dense_den_forward [{label}]", "sigma_hats", sig_k, sig_p, 1e-6, 1e-4),
        _check(f"dense_den_forward [{label}]", "log_z vs den_dense", log_z, log_z_d, 1e-4, 1e-5),
        _check(f"dense_den_forward [{label}]", "logc vs library", logc_k, logc_l, 1e-5, 0.0),
        _check(f"dense_den_forward [{label}]", "sigma_hats vs library", sig_k, sig_l, 1e-6, 1e-4),
    ]
    _record(
        measured, "dense_den_forward", label, checks,
        _times(lambda: dp.dense_forward_kernel(pe, den, leaky), 5,
               library=_captured(lambda: dense_forward_library(pe, den, leaky)),
               plain=lambda: dp.dense_forward_plain(pe, den, leaky), plain_reps=5),
        2.0 * T * B * nnz,
        4.0 * (T * B * E + S * E + 2 * S + 1 + den.real_exp + T * B + T * B * S),
    )
    ymax_t = res["ymax"].T.contiguous()
    F = torch.cumsum(logc_p + ymax_t, 0)
    fscale = torch.cat([F.new_zeros((1, B)), F[:-1]]) + ymax_t - res["log_z"]
    args = (pe, den, sig_p, fscale, ymax_t, leaky)
    gout_k = dp.dense_backward_kernel(*args)
    torch.cuda.synchronize()
    gout_p = dp.dense_backward_plain(*args)
    gout_l = dense_backward_library(*args)
    # the occupancies of a frame sum to 1 over the expanded states (and
    # gamma over the pdfs): entries held relative to their size.  exp(fscale
    # + G) is O(1) only because G follows the per-frame renormalisation
    rowsum = gout_k.sum(-1)
    checks = [
        _check(f"dense_den_backward [{label}]", "gout", gout_k, gout_p, 1e-6, 1e-4),
        _check(f"dense_den_backward [{label}]", "frame sums", rowsum,
               torch.ones_like(rowsum), 1e-4, 0.0),
        _check(f"dense_den_backward [{label}]", "gamma vs den_dense", gamma, gamma_d, 1e-5, 1e-4),
        _check(f"dense_den_backward [{label}]", "gout vs library", gout_k, gout_l, 1e-6, 1e-4),
    ]
    if not bool((gout_k[..., den.real_exp:] == 0).all()):
        raise AssertionError("dense_den_backward: occupancy on a padded expanded state")
    if not bool(torch.equal(gout_k, dp.dense_backward_kernel(*args))):
        raise AssertionError("dense_den_backward: two launches differ")
    _record(
        measured, "dense_den_backward", label, checks,
        _times(lambda: dp.dense_backward_kernel(*args), 5,
               library=_captured(lambda: dense_backward_library(*args)),
               plain=lambda: dp.dense_backward_plain(*args), plain_reps=5),
        2.0 * (2 * T - 1) * B * nnz + 6.0 * T * B * E,
        4.0 * (T * B * E + S * E + S + E + T * B * S + 2 * T * B + T * B * E),
    )
    return measured


def check_probe() -> tuple[dict[str, dict], int]:
    """Phase 3, T1: the largest shared memory a block gets, found by the
    probe, against the device's opt-in limit.  Returns (the measurements by
    kernel name, the number of launches the phase made)."""
    import torch

    from torchain_tpu_torch import kernels
    from torchain_tpu_torch.tools import probe_smem as ps

    limit = kernels.library("probe_smem").probe_smem_limit()
    ps.try_size.launches = 0
    # every default size below the limit, the limit itself and 1 KiB beyond
    sizes = sorted({k for k in ps.DEFAULT_SIZES_KIB if k * 1024 < limit}
                   | {limit // 1024, limit // 1024 + 1})
    best = ps.largest(sizes, log=lambda line: _log("probe_smem: " + line))
    launches = ps.try_size.launches
    _log(f"probe_smem: largest {best} KiB; the device's opt-in limit is {limit} bytes")
    if best != limit // 1024:
        raise AssertionError(f"probe_smem: largest {best} KiB, the limit is {limit} bytes")
    x = torch.arange(1, ps.LANES + 1, dtype=torch.float32, device="cuda")
    measured = {}
    _record(
        measured, "probe_smem", f"{best} KiB",
        [_check("probe_smem", "2x + 3x", ps.try_size(x, best), ps.try_size_plain(x), 0.0, 0.0)],
        _times(lambda: ps.try_size(x, best), 50,
               plain=lambda: ps.try_size_plain(x), plain_reps=50),
        3.0 * ps.LANES, 8.0 * ps.LANES,
        largest_kib=float(best), limit_bytes=float(limit),
    )
    return measured, launches


#: the fifteen kernels: (wrapper module, wrapper, source, the TPU kernel replaced)
KERNELS = {
    "den_forward": ("ops.den_resident", "den_forward_kernel",
                    "torchain_tpu_torch/csrc/den_resident.cu",
                    "torchain_tpu/ops/den_resident.py:565"),
    "den_backward": ("ops.den_resident", "den_backward_kernel",
                     "torchain_tpu_torch/csrc/den_resident.cu",
                     "torchain_tpu/ops/den_resident.py:615"),
    "num_steady_forward": ("ops.num_resident", "steady_forward",
                           "torchain_tpu_torch/csrc/num_resident.cu",
                           "torchain_tpu/ops/num_resident.py:158"),
    "num_steady_backward": ("ops.num_resident", "steady_backward",
                            "torchain_tpu_torch/csrc/num_resident.cu",
                            "torchain_tpu/ops/num_resident.py:207"),
    "vocab_gather": ("ops.num_scan", "vocab_gather", "torchain_tpu_torch/csrc/num_vocab.cu",
                     "torchain_tpu/ops/num_scan.py:140"),
    "vocab_scatter": ("ops.num_scan", "vocab_scatter", "torchain_tpu_torch/csrc/num_vocab.cu",
                      "torchain_tpu/ops/num_scan.py:179"),
    "attention_forward": ("ops.attention", "attention_forward",
                          "torchain_tpu_torch/csrc/attention.cu",
                          "torchain_tpu/ops/attention.py:219"),
    "attention_backward": ("ops.attention", "attention_backward",
                           "torchain_tpu_torch/csrc/attention.cu",
                           "torchain_tpu/ops/attention.py:258"),
    "ffn_forward": ("ops.fused_ffn", "ffn_forward", "torchain_tpu_torch/csrc/fused_ffn.cu",
                    "torchain_tpu/ops/fused_ffn.py:200"),
    "ffn_backward": ("ops.fused_ffn", "ffn_backward", "torchain_tpu_torch/csrc/fused_ffn.cu",
                     "torchain_tpu/ops/fused_ffn.py:239"),
    "e2e_forward": ("ops.num_resident", "e2e_forward_resident",
                    "torchain_tpu_torch/csrc/num_e2e.cu",
                    "torchain_tpu/ops/num_resident.py:319"),
    "e2e_backward": ("ops.num_resident", "e2e_backward_resident",
                     "torchain_tpu_torch/csrc/num_e2e.cu",
                     "torchain_tpu/ops/num_resident.py:356"),
    "dense_den_forward": ("ops.den_pallas", "dense_forward_kernel",
                          "torchain_tpu_torch/csrc/den_dense.cu",
                          "torchain_tpu/ops/den_pallas.py:118"),
    "dense_den_backward": ("ops.den_pallas", "dense_backward_kernel",
                           "torchain_tpu_torch/csrc/den_dense.cu",
                           "torchain_tpu/ops/den_pallas.py:160"),
    "probe_smem": ("tools.probe_smem", "try_size", "torchain_tpu_torch/csrc/probe_smem.cu",
                   "tools/probe_vmem.py:27"),
}


def counters():
    """The kernel wrappers, by kernel name (each carries `.launches`)."""
    import importlib

    return {
        name: getattr(importlib.import_module(f"torchain_tpu_torch.{mod}"), fn)
        for name, (mod, fn, _, _) in KERNELS.items()
    }


def train_steps(cfg, feat_dim, feats, den, sup, steps: int, seed: int):
    """Phase 4: one path.  Returns (losses, step ms list, launches, step)."""
    import torch

    from torchain_tpu_torch.ops import ChainLossOptions
    from torchain_tpu_torch.train import create_train_state, make_train_step

    model = make_model(cfg, feat_dim, feats.device, seed)
    state = create_train_state(model, lr=1e-3)
    step = make_train_step(
        state,
        ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1,
                         xent_regularize=0.1),
        max_grad_norm=5.0,
    )
    for fn in counters().values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(feats, den, sup)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
    launches = {k: fn.launches for k, fn in counters().items()}
    return losses, times, launches, step


def profile_steps(step, feats, den, sup, n: int, out_path: pathlib.Path | None) -> dict:
    """--profile: torch.profiler over `n` more train steps.  Writes the
    per-kernel table to `out_path`, where given; returns wall and
    device-busy ms per step (device busy = the sum of the kernels' device
    time; one stream, so they do not overlap), split into the port's
    kernels, cuBLAS GEMMs and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(feats, den, sup)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    from torch.autograd import DeviceType

    # device kernels and copies only: an operator's own row repeats its
    # kernels' time, and a user annotation's device row spans them
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]
    if not kern:
        raise AssertionError("the profiler recorded no device kernels")

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    ours = ("fwd_gemm", "fwd_norm", "bwd_gamma", "bwd_gemm", "bwd_norm",
            "vocab_gather_kernel", "vocab_scatter_kernel",
            "steady_fwd_kernel", "steady_bwd_kernel",
            "attn_fwd_kernel", "attn_bwd_kernel", "dbias_reduce_kernel",
            "ffn_fwd_kernel", "ffn_bwd_rows_kernel", "ffn_bwd_weights_kernel",
            "sum_parts_kernel", "e2e_fwd_kernel", "e2e_bwd_kernel", "dense_fwd_",
            "dense_bwd_")
    is_ours = [any(k in e.key for k in ours) for e in kern]
    # cuBLAS names its Hopper bf16 kernels "nvjet_..."
    is_gemm = [not o and any(k in e.key.lower() for k in ("gemm", "sm90", "nvjet"))
               for e, o in zip(kern, is_ours)]
    busy = sum(dev_us(e) for e in kern) / 1e3 / n
    port = sum(dev_us(e) for e, o in zip(kern, is_ours) if o) / 1e3 / n
    gemm = sum(dev_us(e) for e, g in zip(kern, is_gemm) if g) / 1e3 / n
    launches = sum(e.count for e in kern) // n
    rows = sorted(kern, key=dev_us, reverse=True)
    lines = [f"{dev_us(e) / 1e3 / n:10.3f} ms/step {e.count // n:7d} launches/step  {e.key[:100]}"
             for e in rows][:40]
    if out_path is not None:
        out_path.write_text("\n".join(lines) + "\n")
    return dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                port_kernels_ms=port, library_gemm_ms=gemm, other_ms=busy - port - gemm,
                kernel_launches=launches, top=lines[:12])


#: gates of the reference check, relative, per trunk dtype.  float32: sums
#: in another order (cuBLAS vs the CPU BLAS, kernels vs plain) through 9
#: layers, the 50-frame recursions and a backward.  bfloat16: the card's and
#: the CPU's matrix products round their bfloat16 results from sums taken in
#: another order, layer after layer (on an H100 at B=8, TDNN-F: loss 2.3e-4,
#: objf 6.3e-4, gradient norm 1.3e-3).  The same gate holds the first loss of
#: the conformer with the fused feed-forward to that of the dense one
REFERENCE_RTOL = {"float32": 1e-3, "bfloat16": 1e-2}


def reference_check(cfg, feat_dim, dataset, corpus, seed: int, path: str) -> dict:
    """Phase 5: one loss + gradient on a small batch, on the card (kernels)
    and on the CPU (plain versions), from the same weights."""
    import torch

    from torchain_tpu_torch.ops import ChainLossOptions, chain_loss

    small = next(dataset.batches(8, shuffle=False))
    opts = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1,
                            xent_regularize=0.1)
    model = make_model(cfg, feat_dim, "cpu", seed + 1)
    rtol = REFERENCE_RTOL[PATHS[path]["dtype"]]
    out = dict(rtol=rtol)
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        den, sup = place(path, corpus, small, dev)
        chain, xent = m(torch.as_tensor(small.feats, device=dev), train=True)
        loss, aux = chain_loss(chain, xent, den, sup, opts)
        loss.backward()
        gn = torch.sqrt(sum(torch.sum(p.grad.double() ** 2) for p in m.parameters()))
        out[dev] = dict(loss=float(loss.detach()), objf=float(aux["objf"].detach()), grad_norm=float(gn))
    for k in ("loss", "objf", "grad_norm"):
        a, b = out["cuda"][k], out["cpu"][k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        out[f"{k}_rel_err"] = rel
        if not (math.isfinite(a) and rel <= rtol):
            raise AssertionError(f"reference check [{path}]: {k} card {a} vs cpu {b}")
    return out


def _sizes(den, sup) -> dict:
    """What a path's graph and batch measure, by their forms."""
    import torch

    from torchain_tpu_torch.ops import DeviceDenseDenGraph, DeviceE2eSupervision

    if isinstance(den, DeviceDenseDenGraph):
        sizes = dict(den_form="dense_fused" if den.fused else "dense", den_states=den.num_orig,
                     den_expanded=den.real_exp, den_expanded_padded=den.num_exp)
    else:
        sizes = dict(den_form="resident", den_states=den.real_states,
                     den_states_padded=den.num_states, den_slots=den.num_slots)
    sizes.update(pdfs=den.num_pdfs, v_bytes=den.V.numel() * 4,
                 v_nonzero=int(torch.count_nonzero(den.V)),
                 num_states=sup.max_states, num_arcs_full=sup.max_arcs)
    if isinstance(sup, DeviceE2eSupervision):
        used = (sup.in_src >= 0).any(-1).sum(-1)
        sizes.update(sup_form="e2e", arcs_live=int((sup.in_src >= 0).sum()),
                     arc_slots=sup.in_src.numel(), vocab_width=sup.vocab.shape[-1],
                     states_used_min=int(used.min()), states_used_max=int(used.max()))
    else:
        sizes.update(sup_form="chunks", num_arcs_steady=sup.in_src_r.shape[-1],
                     vocab_width=sup.frame_vocab.shape[-1],
                     steady_arcs_live=int((sup.in_src_r >= 0).sum()),
                     steady_slots=sup.in_src_r.numel())
    return sizes


def run_path(path: str, args, result: dict, checks: tuple = ()):
    """Phases 3 to 5 for one path.  Phase 3 holds the kernel groups named in
    `checks` against their plain versions at this path's corpus: "den_num"
    (K1-K6 on the path's graph and batch), "e2e" (K8f/K8b on the corpus's
    flat-start batch, the path's own where it trains on one), "dense"
    (K9f/K9b on the path's graph).  Returns (those measurements by kernel
    name, the path's launch counts by kernel name) and fills result[path]
    with the path's numbers."""
    import numpy as np
    import torch

    from torchain_tpu_torch.ops import DeviceE2eSupervision

    t0 = time.perf_counter()
    corpus, cfg, dataset = build_path(path, args.seed)
    batch = next(dataset.batches(B, shuffle=False))
    den, sup = place(path, corpus, batch, "cuda")
    feats = torch.as_tensor(batch.feats, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sizes = _sizes(den, sup)
    _log(f"path {path}: set-up {setup_s:.1f} s; feats {tuple(feats.shape)}"
         f" trunk {PATHS[path]['dtype']}; " + json.dumps(sizes))
    measured = {}
    if "den_num" in checks:
        measured.update(check_kernels(den, sup, args.seed, path))
    if "e2e" in checks:
        e2e_sup = sup
        if not isinstance(sup, DeviceE2eSupervision):
            e2e_batch = next(make_dataset(corpus, cfg, e2e=True).batches(B, shuffle=False))
            e2e_sup = DeviceE2eSupervision.from_host(e2e_batch.sup, device="cuda")
            e2e_sup = e2e_sup.with_kernel_tables()
            _log(f"e2e batch of the {path} corpus: tables {tuple(e2e_sup.in_src.shape)},"
                 f" {int((e2e_sup.in_src >= 0).sum())} live arcs")
        measured.update(check_e2e_kernels(e2e_sup, args.seed, path))
    if "dense" in checks:
        # the network output of the path's first step: its model, its batch
        with torch.no_grad():
            y, _ = make_model(cfg, corpus.feat_dim, "cuda", args.seed)(feats, train=True)
        measured.update(check_dense_kernels(den, y.float(), path))
        del y
    out = result[path] = dict(setup_s=setup_s, sizes=sizes)
    if args.kernels_only:
        return measured, {}

    # phase 4: the path itself
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches, step = train_steps(
        cfg, corpus.feat_dim, feats, den, sup, args.steps, args.seed
    )
    for i, (m, ms) in enumerate(zip(losses, times)):
        _log(f"{path} step {i}: {ms:.1f} ms  " + "  ".join(f"{k}={v:.6g}" for k, v in m.items()))
    if not all(math.isfinite(m["loss"]) for m in losses):
        raise AssertionError(f"non-finite loss on the {path} path")
    if not losses[-1]["loss"] < losses[0]["loss"]:
        raise AssertionError(f"the loss did not fall over the replayed batch ({path})")
    for name, n in launches.items():
        if name in PATHS[path]["kernels"] and n == 0:
            raise AssertionError(f"kernel {name} was not launched on the {path} path")
        if name not in PATHS[path]["kernels"] and n != 0:
            raise AssertionError(f"kernel {name} is not of the {path} path, yet it counted {n}")
    # the rate is all the audio of steps 2..N over the whole window of
    # those steps; step 1 holds cuBLAS and allocator warm-up
    window_ms = float(np.sum(times[1:]))
    audio_s = (args.steps - 1) * B * T_OUT * 3 * 0.010
    step_ms = window_ms / (args.steps - 1)
    rate = audio_s / (window_ms / 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _log(f"launches on the {path} path ({args.steps} steps): {launches}")
    _log(f"{path} steps 2..{args.steps}: {window_ms:.1f} ms for {audio_s:.0f} audio-s,"
         f" {step_ms:.2f} ms/step, {rate:.1f} audio-s/s; step 1 {times[0]:.1f} ms;"
         f" peak memory {peak_gib:.2f} GiB")
    out.update(step_ms=step_ms, step1_ms=times[0], step_ms_all=times, audio_s_per_s=rate,
               peak_memory_gib=peak_gib, losses=losses, launches=launches)

    if args.profile:
        if args.out:
            args.out.mkdir(parents=True, exist_ok=True)
        prof = profile_steps(step, feats, den, sup, 2,
                             args.out / f"profile_{path}.txt" if args.out else None)
        _log(f"{path} profile (traced steps only): wall {prof['wall_ms']:.2f} ms/step,"
             f" device busy {prof['device_busy_ms']:.2f} ms/step (traced idle share"
             f" {prof['idle_share']:.3f}) in {prof['kernel_launches']} launches/step:"
             f" port kernels {prof['port_kernels_ms']:.2f}, cuBLAS GEMMs"
             f" {prof['library_gemm_ms']:.2f}, other {prof['other_ms']:.2f} ms/step")
        for line in prof["top"]:
            _log("  " + line)
        out["profile"] = prof

    # phase 5: reference check on a small input
    ref = reference_check(cfg, corpus.feat_dim, dataset, corpus, args.seed, path)
    _log(f"{path} reference check (B=8, card vs cpu):", json.dumps(ref))
    out["reference"] = ref
    return measured, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10, help="train steps per path (>= 3)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and kernel checks)")
    ap.add_argument("--profile", action="store_true",
                    help="after each path's steps, trace 2 more with torch.profiler")
    ap.add_argument("--out", type=pathlib.Path,
                    help="directory for chip_smoke.json and profile_<path>.txt")
    args = ap.parse_args(argv)
    if args.steps < 3:
        ap.error("--steps must be at least 3")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    from torchain_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(smi)
    _log("torch", torch.__version__, "cuda", torch.version.cuda,
         "device", torch.cuda.get_device_name(0))

    # phase 2: build
    build_s = kernels.build(force=True)
    _log(f"build: {build_s:.1f} s for {len(kernels.SIGNATURES)} sources")
    for name in kernels.SIGNATURES:
        log = (kernels.BUILD / f"{name}.log").read_text()
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:  # K10's kernels by name
                entry = line.split("'")[1] if name == "fused_ffn" else ""
            if "Used" in line or "spill" in line or "Performance Loss" in line:
                _log(f"  ptxas {name}{' ' + entry if entry else ''}: {line.strip()}")
    for name in kernels.SIGNATURES:
        kernels.library(name)

    # phases 3 to 5, path by path.  `numbers` gathers one record per kernel:
    # K1-K6 and K8 the trigram corpus's numbers at the top level and the
    # production corpus's under "production"; K9 the trigram graph's (the
    # production graph has no dense form: its V would exceed what
    # `synthetic_dataset` builds); K7, K10 bfloat16 operands (the conformer
    # paths' trunk) at the top level and float32 under "float32"
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, build_s=build_s)
    launches, numbers = {}, {}
    measured, launches["trigram"] = run_path("trigram", args, result, ("den_num",))
    numbers.update(measured)
    measured, launches["production"] = run_path("production", args, result, ("den_num", "e2e"))
    second = measured
    conformer = {dt: check_conformer_kernels(args.seed, dt) for dt in ("bfloat16", "float32")}
    numbers.update({k: dict(**v, float32=conformer["float32"][k])
                    for k, v in conformer["bfloat16"].items()})
    _, launches["conformer"] = run_path("conformer", args, result)
    _, launches["conformer_ffn"] = run_path("conformer_ffn", args, result)
    measured, launches["e2e"] = run_path("e2e", args, result, ("e2e",))
    numbers.update(measured)
    measured, launches["dense"] = run_path("dense", args, result, ("dense",))
    numbers.update(measured)
    for name, m in second.items():
        numbers[name] = dict(**numbers[name], production=m)
    measured, probe_launches = check_probe()
    numbers.update(measured)
    launches["probe"] = {k: (probe_launches if k in PROBE else 0) for k in KERNELS}
    if not args.kernels_only:
        # pairs of paths that start from the same weights and batch: the two
        # feed-forward lowerings, and two independent denominators
        for a_path, b_path, what in (("conformer", "conformer_ffn", "first_loss_rel_to_dense"),
                                     ("trigram", "dense", "first_loss_rel_to_resident")):
            gate = REFERENCE_RTOL[PATHS[b_path]["dtype"]]
            a = result[a_path]["losses"][0]["loss"]
            b = result[b_path]["losses"][0]["loss"]
            rel = abs(a - b) / abs(a)
            _log(f"first loss, {a_path} {a:.6g} vs {b_path} {b:.6g}: rel {rel:.3g}"
                 f" (gate {gate:g})")
            result[b_path][what] = rel
            if not rel <= gate:
                raise AssertionError(f"the first loss of {b_path} departs from {a_path}'s")
    # `launches` is the count of the first path that must run the kernel (the
    # probe's: its own phase); every path's count is under "launches_by_path"
    must = {**{p: PATHS[p]["kernels"] for p in PATHS}, "probe": PROBE}
    records = []
    for name, (_, _, source, replaces) in KERNELS.items():
        first = next(p for p in must if name in must[p])
        by_path = {p: n.get(name, 0) for p, n in launches.items()}
        records.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=by_path[first], launches_by_path=by_path,
                            **numbers[name]))
    result["kernels"] = records

    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
