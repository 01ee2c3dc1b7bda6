#!/usr/bin/env python3
"""Drive the PyTorch port (torchain_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--seed N] [--kernels-only] [--profile] [--out DIR]

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
     left-biphone tree, P=1680; K1 and K2 also against a frame loop of
     cuSPARSE products, captured as one CUDA graph, and launched twice for
     equal bits; at the production graph also with V, p and ah in bfloat16
     against their bfloat16 plain versions, timed in turns with the float32
     kernels; K5 and K6 also at P=83, and with the host's microseconds
     per call),
     the flat-start numerator kernels at the e2e batches of both corpora,
     the fused dense-denominator kernels at the trigram graph's Moore form
     (also against the matrix-product recursion of ops/den_dense.py and its
     cuBLAS frame loop, captured as one CUDA graph; launched twice for
     equal bits), the
     attention and feed-forward kernels at the conformer's shapes (qkv
     [128, 50, 768], 4 heads; xn [6400, 256], F=1024) with bfloat16 and with
     float32 operands (K7 also at T=150 in bfloat16, and with heads 96 and
     128 wide, dim 384 and 512, at T 50 and 150 in both dtypes, each with a
     card-vs-CPU check of `fused_relpos_attention` at B=8, the host's
     microseconds per wrapper call and the device's per launch), and the
     shared-memory probe against the device's opt-in limit; K3, K4, K8f and
     K8b also on the shared-memory plan their sizes did not choose, for
     equal bits and a time in the same turns, and K10 also at D 512,
     F 2048 (rows cut into two column groups) and as one model rank's share
     of the model axis's split half-step (N 400, D 256, F 512, float32 out
     and dx);
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
     and (f)'s with (a)'s.  Then each path's step as one captured CUDA
     graph (`check_captured`, `make_train_step(..., capture=True)`): two
     batches A and B of its corpus at one set of supervision caps and one
     `L_cap`, one model with capturable Adam, captured on A; in each of 3
     rounds 10 eager and 10 captured steps on A, B, A, ... from the same
     initial state, the counters zeroed before each run; the captured
     metrics held to the eager ones (step 1 rel 1e-6, later 1e-4; a
     bfloat16 trunk 1e-5 and 1e-3); each mode's ms a step (host and card
     clocks, medians), capture seconds, the graph pool's bytes and peak
     memory; then a traced run of 2 steps of each mode (device busy,
     device and host launches): a replay runs no Python, so its kernels'
     launches are counted in its trace, by each kernel's device name, and
     must equal the eager trace's, which must equal the eager run's
     counters (this path's kernels only); on
     (e) also the eager step with the arcs' vocabulary sum as the product
     and as the `scatter_add_` it replaced (ms, peak memory, launches,
     bits run to run); on (a) also a fresh state's eager run (equal bits:
     the warm-up leaves no trace), and torch's default Adam against
     capturable Adam: closed loop, against a control started one float32
     step away, and open loop (capturable Adam fed the default's
     gradients, gated at 1.25 times the gap that computing the bias
     corrections in float32 makes).  Then (a)'s
     model and batch on the forms
     `auto_den_graph` falls through to where the slot-dense one does not
     fit (its fit test made to refuse it: the fused dense Moore form; the
     card's limit taken as below K2's carried state: the sparse scan of
     ops/den_scan.py), as many steps each, their first loss against (a)'s
     and their median step against (a)'s (with --profile, traced too),
     then on the de Bruijn lift that `auto_den_graph` takes next on the card
     given the phone LM and tree, on the padded-table form and on the scan
     with alpha checkpointed every 10 frames, and (b)'s model and batch on
     its de Bruijn lift, each with its peak memory and allocator counters;
     then training from a finished Kaldi chain prep (`check_cegs`): (a)'s
     corpus written as a binary OpenFst den.fst and a merged cegs archive
     of B sequences a record, read back through `_load_any_fst`,
     `compile_den_graph`, `auto_den_graph` and `CegsDataset`, (a)'s model
     trained as many steps on the first record (K1-K6 and no other kernel;
     the first loss against (a)'s), and its outputs for that record written
     to a binary and a text Kaldi archive and read back; then the recipe's
     entry points on that prep (`check_recipe`): `cli.train` 10 steps at
     (a)'s widths (K1-K6 and no other kernel, the semi-orthogonal constraint
     twice), the same run cut after 6 steps and resumed from its checkpoint
     (equal to the uninterrupted run within REFERENCE_RTOL), `cli.compute_prob`
     on the card (no K2) and against the CPU, and `cli.export_posteriors` on
     the card against the CPU; then decode and score (`check_decode`):
     `cli.train --synthetic-words --flat-start-ladder --decode` at (a)'s
     widths on 256 utterances (K1-K6, K8f and K8b, none in the decode
     stages; PER, WER, the best LMWT and the MBR WER), the final
     checkpoint's posteriors on the card against the CPU, the native
     decoders against the NumPy ones on the card's posteriors, and the
     standalone `cli.decode` over the exported posteriors with both
     backends, with the forward at B=1, the decoders' host time, the
     real-time factors and the HCLG build timed; then the Kaldi model files
     (`check_kaldi`): `cli.train --synthetic`'s corpus over 40 phones
     written as a Kaldi experiment dir (final.mdl, ali.1.gz, feats.ark,
     utt2spk, cmvn.ark) and read back through `cli.graphs ali-to-phones`,
     `load_kaldi_dir(cmvn="speaker")` and `cli.graphs make-den-fst`;
     `cli.train` at (a)'s widths on a tied tree of 1000 pdfs, left context
     (K1-K6) and triphone (62,917 den states: the sparse scan, K3-K6), each
     step on the card's clock and two more traced; the triphone run's
     first batch at B=8 and a lattice supervision on the card against the
     CPU; `cli.decode --tree` over the triphone tree's Kaldi file, a word
     HCLG written as HCLG.fst over transition ids through `cli.decode
     --hclg/--mdl`, and an nnet3 body behind final.mdl written and read;
     the triphone run's den graph and first batch on the scan, the
     alpha-checkpointed scan and the padded-table form (on as many
     sequences as its [B, S, K_in] temporary allows), with K_in, K_out,
     step ms, peak memory and the allocator's counters; then training from
     raw audio (`check_wav`): a synthetic raw-audio data dir of 160
     utterances (`make_wav_data_dir`, 16 kHz, 40-bin fbank; the filterbank
     on the card and on the CPU against a float64 yardstick), `cli.train
     --wav-dir --cmvn speaker --speed-perturb --ivector-dim 100
     --ivector-gauss 32 --precompile-egs 8 --save-egs --materialize-egs
     device` at (a)'s widths (K1-K6 and no other kernel; each stage's
     seconds), the forked precompile against a serial compile, the same run
     from `--load-egs` (no compile; the first loss bit for bit), the live
     loader (serial and on a pool of threads) against materialized batches
     under `Trainer.fit`, and a B=8
     batch on the card against the CPU; then every trunk, lowering and
     optimizer of the JAX package (`check_trunks`): `cli.train` on the
     trigram corpus with the TDNN-LSTM at Kaldi run_tdnn_lstm_1a's widths
     (1024, projections 256) and with its OPGRU ladder, the CNN-TDNN (Kaldi
     cnn_tdnn_1a's filters), the TDNN-F with `--optimizer adam-lowmem` and
     `ngsgd` (each optimizer's updates on the card against the CPU's from
     one gradient, and its state's bytes), the TDNN-F under impl="conv",
     time_major=False and bn_impl="flax" and the conformer under its four
     other lowerings (each first loss against its path's), one traced step
     of each new trunk, and B=8 card-vs-CPU checks of the new trunks (loss,
     objf, gradient norm, the loss's gradient on the heads' outputs); then
     data parallelism (`check_parallel`): `cli.train --distributed` under
     `torch.distributed.run --nproc-per-node 1` (NCCL, a world of one)
     against the plain `cli.train` run, and `tools/multihost_worker.py`'s
     trainer mode on two gloo ranks sharing the card against one rank on
     the same global batches, at `trigram`'s widths (B=128, 64 rows a rank,
     K1-K6 once a step on each) and with the bf16 conformer (B=8), and the
     model axis: the worker's model mode on a data 1 x model 2 mesh of two
     gloo ranks sharing the card, the bf16 conformer (B=8) sharded by
     `shard_params`, its feed-forward split over the model group (K10f/K10b
     on [256, 512] shards with the dense and the fused lowering), float32
     copies, and a float32 step at a lower threshold whose qkv, conv_in,
     attn_out and conv_out are gathered on use, each against one rank.  The
     cegs phase also times
     `Trainer.fit` over the live `CegsDataset` against
     `MaterializedBatches` of it on the card;
  5. a reference check on a small input for each path: the first-step loss
     and gradient norm on the card (kernels) against the CPU (plain
     versions); for the bfloat16 conformer paths also each parameter
     group's gradient on the card and on the CPU against a float32 CPU copy
     of the same weights, and that copy run on the card, which must agree
     with the CPU within REFERENCE_RTOL["float32"] in every group and
     whole;
  6. one JSON line of kernel records, the nvidia-smi line, and the final
     line `{"ok": true, "device": {...}}`.

It imports torch, numpy and torchain_tpu_torch only.  Without a CUDA
device, or outside a checkout of the repository, it fails.  With `--out`,
the full result is also written to DIR/chip_smoke.json (and each path's
profile table to DIR/profile_<path>.txt).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

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


def _times(kernel, reps: int, library=None, plain=None, plain_reps: int = 0,
           other=None) -> dict:
    """A kernel's device ms, in turn with its library call where one exists
    (`_alternate`: 3 rounds, medians), with `other` (the kernel on its other
    shared-memory plan) where given, and its plain version's: in the same
    turns where `plain_reps` is 0, else with `_time_ms` over `plain_reps`
    calls.  Returns the fields of a kernel record."""
    fns = dict(kernel=kernel)
    if library is not None:
        fns["library"] = library
    if other is not None:
        fns["other"] = other
    if not plain_reps:
        fns["plain"] = plain
    t = _alternate(fns, reps)
    out = dict(ms=t["kernel"]["median"], ms_rounds=t["kernel"]["rounds"],
               library_ms=None, timing="device, alternated")
    if library is not None:
        out.update(library_ms=t["library"]["median"], library_ms_rounds=t["library"]["rounds"])
    if other is not None:
        out.update(other_plan_ms=t["other"]["median"], other_plan_ms_rounds=t["other"]["rounds"])
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


def _other_plan(plan, chosen: int) -> int | None:
    """The shared-memory plan (0 or 1) that `plan(staged)` did not choose,
    where it fits the device, else None."""
    try:
        plan(1 - chosen)
    except ValueError:
        return None
    return 1 - chosen


@contextlib.contextmanager
def _limit(entry: tuple, nbytes: int):
    """The numerator kernels' shared-memory limit read through the library
    `entry` taken as `nbytes` (ops/num_resident.py `shared_limit`), so that
    their plans choose as on a card with that little."""
    from torchain_tpu_torch.ops import num_resident as nr

    real = nr.shared_limit
    nr.shared_limit = lambda e, device: nbytes if e == entry else real(e, device)
    try:
        yield
    finally:
        nr.shared_limit = real


def _unstaging_limit(entry: tuple, plan, nbytes: int, staged: int) -> int | None:
    """Where `plan()` chose the staged plan of `nbytes`, a limit one byte
    below it, under which `plan()` chooses the unstaged plan; None where the
    sizes chose the unstaged plan already."""
    if not staged:
        return None
    with _limit(entry, nbytes - 1):
        if plan()[1] != 0:
            raise AssertionError(f"a limit of {nbytes - 1} bytes still stages the list")
    return nbytes - 1


def _under(entry: tuple, nbytes: int, fn):
    """`fn` as a callable that runs under `_limit(entry, nbytes)`."""
    def call():
        with _limit(entry, nbytes):
            return fn()
    return call


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

    from torchain_tpu_torch.models import (
        CNNTDNN,
        TDNNF,
        TDNNLSTM,
        CnnTdnnConfig,
        Conformer,
        ConformerConfig,
        TdnnLstmConfig,
    )

    cls = {ConformerConfig: Conformer, TdnnLstmConfig: TDNNLSTM,
           CnnTdnnConfig: CNNTDNN}.get(type(cfg), TDNNF)
    return cls(cfg, feat_dim, device=device, generator=torch.Generator().manual_seed(seed))


def _record(measured, name, label, checks, times: dict, flops, nbytes,
            peak_flops=PEAK_F32_FLOPS, frames: int | None = None,
            log_only: dict | None = None, **extra):
    """Log and keep one kernel's record: its checks, its `_times`, its bound
    and any extra numbers measured in this run; for a kernel that loops over
    `frames` dependent frames, also its device microseconds a frame.
    `log_only` numbers (a second bound, a sizing) are logged, not kept."""
    bound_ms, bound_by = _bound(flops, nbytes, peak_flops)
    ms, lib_ms = times["ms"], times["library_ms"]
    if frames:
        extra["us_per_frame"] = ms * 1e3 / frames
    _log(
        f"kernel {name} [{label}]: {ms:.5f} ms  plain {times['plain_ms']:.5f} ms"
        f"  bound {bound_ms:.6f} ms ({bound_by})"
        + (f"  library {lib_ms:.5f} ms" if lib_ms is not None else "")
        + (f"  other plan {times['other_plan_ms']:.5f} ms {times['other_plan_ms_rounds']}"
           if "other_plan_ms" in times else "")
        + "".join(f"  {k} {v:.5f}" if isinstance(v, float) else f"  {k} {v}"
                  for k, v in {**extra, **(log_only or {})}.items())
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


def _sparse(offsets, idx, vals, shape):
    """A torch.sparse CSR matrix from a compressed form of the graph (int16
    indices hold unsigned values), its invariants checked once here."""
    import torch

    with warnings.catch_warnings():  # the CSR layout's "beta" notice
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(offsets, idx.int() & 0xFFFF, vals, size=shape,
                                       check_invariants=True)


def library_graph(den):
    """V^T and V as torch.sparse CSR matrices (the graph's CSC and CSR),
    and the pdf-by-slot one-hot [P, KS] (its pdf CSR), for the cuSPARSE
    frame loops."""
    import torch

    S, KS, P = den.num_states, den.num_states * den.num_slots, den.num_pdfs
    one = torch.ones(den.pdf_slots.numel(), device=den.V.device)
    return (_sparse(den.csc_offsets, den.csc_rows, den.csc_vals, (KS, S)),
            _sparse(den.csr_offsets, den.csr_cols, den.csr_vals, (S, KS)),
            _sparse(den.pdf_offsets, den.pdf_slots, one, (P, KS)))


def den_forward_library(p, den, leaky: float, mats):
    """K1's function (p in; logc and ah out) as a frame loop of cuSPARSE
    products (torch.sparse.mm of V^T in CSR with the transposed state);
    `mats` from library_graph."""
    import torch

    VT, _, _ = mats
    T, Bs, _ = p.shape
    S, K = den.num_states, den.num_slots
    init = den.init[:, None]
    pdf = den.slot_pdf.clamp(min=0).long()
    live = (den.slot_pdf >= 0)[:, None]
    sh = init.expand(S, Bs).contiguous()
    logc = p.new_empty((T, Bs))
    ah = p.new_empty((T, Bs, K * S))
    for t in range(T):
        sig = sh + leaky * sh.sum(0, keepdim=True) * init if leaky > 0.0 else sh
        a = torch.sparse.mm(VT, sig) * torch.where(live, p[t].T[pdf], 0.0)  # [KS, B]
        c = a.sum(0)
        logc[t] = torch.log(c)
        a = a / c
        ah[t] = a.T
        sh = a.view(K, S, Bs).sum(0)
    return logc, ah


def den_backward_library(p, ah, F, ymax, log_z, den, leaky: float, mats):
    """K2's function (gamma out) as a frame loop of cuSPARSE products: V in
    CSR for the pullback, the pdf one-hot in CSR for the occupancies."""
    import torch

    _, V, onehot = mats
    T, Bs, P = p.shape
    S, K = den.num_states, den.num_slots
    init = den.init[:, None]
    pdf = den.slot_pdf.clamp(min=0).long()
    live = (den.slot_pdf >= 0)[:, None]
    bh = p.new_ones((S, Bs))
    G = p.new_full((Bs,), math.log1p(leaky) if leaky > 0.0 else 0.0)
    gamma = p.new_empty((Bs, T, P))
    for t in range(T - 1, -1, -1):
        bhe = bh.repeat(K, 1)
        occ = ah[t].T * bhe * torch.exp(F[t] + G - log_z)
        gamma[:, t] = torch.sparse.mm(onehot, occ).T
        if t == 0:
            break
        v = torch.sparse.mm(V, torch.where(live, p[t].T[pdf], 0.0) * bhe)  # [S, B]
        if leaky > 0.0:
            v = v + leaky * (v * init).sum(0)
        d = v.max(0).values
        d = torch.where(d > 0, d, torch.ones_like(d))
        bh = v / d
        G = G + ymax[t] + torch.log(d)
    return gamma


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
    args1 = (p, den, leaky)
    for backward in (0, 1):
        what = "den_backward" if backward else "den_forward"
        nbytes, staged = dr.shared_plan(den, backward, dev)
        _log(f"kernel {what} [{path}]: {nbytes} bytes of shared memory per block,"
             f" V's compressed form {'staged there' if staged else 'read through L2'}")
    logc_k, ah_k = dr.den_forward_kernel(*args1)
    torch.cuda.synchronize()
    logc_p, ah_p = dr.den_forward_plain(*args1)
    mats = library_graph(den)
    logc_l, ah_l = den_forward_library(*args1, mats)
    torch.cuda.synchronize()
    # f32 sums of a column's few non-zeros (the plain version: of S dense
    # products) in another order, carried over 50 frames through the
    # per-frame renormalisation.  log c is O(1); ah sums to 1 over the KS =
    # 2 S slots of a frame, so its entries are held relative to their size
    # (atol only for entries near 0).
    checks1 = [
        _check(f"den_forward [{path}]", "logc", logc_k, logc_p, 1e-5, 0.0),
        _check(f"den_forward [{path}]", "ah", ah_k, ah_p, 1e-6, 1e-4),
        _check(f"den_forward [{path}]", "logc vs library", logc_k, logc_l, 1e-5, 0.0),
        _check(f"den_forward [{path}]", "ah vs library", ah_k, ah_l, 1e-6, 1e-4),
    ]
    again = dr.den_forward_kernel(*args1)
    if not (torch.equal(again[0], logc_k) and torch.equal(again[1], ah_k)):
        raise AssertionError(f"den_forward [{path}]: two launches differ")
    # the bound counts what this graph needs: V's non-zeros (values and
    # 16-bit indices) and offsets, read once
    nnz, live = den.nnz, int(den.pdf_slots.numel())
    record(
        "den_forward", checks1,
        _times(lambda: dr.den_forward_kernel(*args1), 20,
               library=_captured(lambda: den_forward_library(*args1, mats)),
               plain=lambda: dr.den_forward_plain(*args1), plain_reps=5),
        2.0 * T * B * nnz,
        4.0 * T * B * P + 4.0 * (KS + 1) + 6.0 * nnz + 4.0 * (KS + S)
        + 4.0 * (T * B * KS + T * B),
        frames=T,
    )

    # K2: denominator backward, on the plain forward's residuals
    log_z = (logc_p.sum(0) + ymax.sum(0) + math.log1p(leaky)).contiguous()
    F = torch.cumsum(logc_p + ymax, 0).contiguous()
    args2 = (p, ah_p.contiguous(), F, ymax, log_z, den, leaky)
    g_k = dr.den_backward_kernel(*args2)
    torch.cuda.synchronize()
    g_p = dr.den_backward_plain(*args2)
    g_l = den_backward_library(*args2, mats)
    torch.cuda.synchronize()
    if not torch.equal(dr.den_backward_kernel(*args2), g_k):
        raise AssertionError(f"den_backward [{path}]: two launches differ")
    # gamma sums to 1 over the P pdfs of a frame: held relative to its
    # size, as ah is
    record(
        "den_backward",
        [_check(f"den_backward [{path}]", "gamma", g_k, g_p, 1e-5, 1e-4),
         _check(f"den_backward [{path}]", "gamma vs library", g_k, g_l, 1e-5, 1e-4)],
        _times(lambda: dr.den_backward_kernel(*args2), 20,
               library=_captured(lambda: den_backward_library(*args2, mats)),
               plain=lambda: dr.den_backward_plain(*args2), plain_reps=5),
        2.0 * (T - 1) * B * nnz + 3.0 * T * B * live,
        4.0 * (T * B * P + T * B * KS + 2 * T * B + B) + 4.0 * (S + 1) + 6.0 * nnz
        + 4.0 * (P + 1 + live + S + B * T * P),
        frames=T,
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
    L = pre[1].shape[1]
    k3_bytes, k3_staged = nr.steady_forward_plan(L, Tm1, Sn, W, dev)
    _log(f"kernel num_steady_forward [{path}]: {k3_bytes} bytes of shared memory per block,"
         f" the list {'staged there' if k3_staged else 'read from device memory'}")
    aT_k, rest_k = nr.steady_forward(alpha1, *tables, ysm, pre=pre)
    torch.cuda.synchronize()
    aT_p, rest_p = nr.steady_forward_plain(alpha1, *tables, ysm)
    if not torch.equal(nr.steady_forward(alpha1, *tables, ysm, pre=pre)[1], rest_k):
        raise AssertionError(f"num_steady_forward [{path}]: two launches differ")
    # the unstaged plan, where the sizes chose the staged one (the limit
    # lowered below it): the same bits, and timed in turns
    lim3 = _unstaging_limit(nr.NUM_LIMIT, lambda: nr.steady_forward_plan(L, Tm1, Sn, W, dev),
                            k3_bytes, k3_staged)
    other3 = None if lim3 is None else _under(
        nr.NUM_LIMIT, lim3, lambda: nr.steady_forward(alpha1, *tables, ysm, pre=pre))
    if other3 is not None and not torch.equal(other3()[1], rest_k):
        raise AssertionError(f"num_steady_forward [{path}]: the two plans differ")
    arcs = int((sup.in_src_r >= 0).sum())
    table_bytes = 12.0 * B * Tm1 * Sn * Kr  # int32 src, int32 lpdf, f32 logw
    # K3 and K4 need the live arcs alone: a 16-byte record each (src, dst,
    # lpdf, logw) with per-frame offsets.  K3 reads per-destination offsets
    # beside them; a 12-byte record without dst holds the same with those,
    # so K3's bound takes the smaller of the two counts
    list_bytes = 16.0 * arcs + 4.0 * B * T
    dst_off_bytes = 16.0 * arcs + 4.0 * B * Tm1 * (Sn + 1)  # what K3 reads
    k3_list_bytes = min(list_bytes, 12.0 * arcs + 4.0 * B * Tm1 * (Sn + 1))
    # f32 log-sum-exps of a few terms per state in another order, carried
    # over 49 frames; -inf (unreachable states) in the same places.  The
    # bound is bytes, each once: the list, the ysm rows, alpha1 and the
    # alphas out (and, kept beside it, the count of what K3 reads and of
    # the dense tables the TPU kernel and the dense design before it read);
    # the 49 dependent frames set a latency floor that it does not see.
    k3_rest_bytes = 4.0 * (B * Tm1 * W + B * Sn + Tm1 * B * Sn)
    record(
        "num_steady_forward",
        [_check(f"num_steady_forward [{path}]", "alphas", rest_k, rest_p, 1e-5, 1e-5)],
        _times(lambda: nr.steady_forward(alpha1, *tables, ysm, pre=pre), 50,
               plain=lambda: nr.steady_forward_plain(alpha1, *tables, ysm), plain_reps=5,
               other=other3),
        4.0 * arcs + 2.0 * B * Tm1 * Sn,
        k3_list_bytes + k3_rest_bytes,
        frames=Tm1,
        log_only=dict(dense_tables_bound_ms=_bound(4.0 * arcs + 2.0 * B * Tm1 * Sn,
                                                   table_bytes + k3_rest_bytes)[0],
                      read_list_bound_ms=_bound(4.0 * arcs + 2.0 * B * Tm1 * Sn,
                                                dst_off_bytes + k3_rest_bytes)[0],
                      shared_bytes=k3_bytes, staged=k3_staged),
    )
    final = sup.final_logw.clone()
    final[1] = -math.inf
    log_p = torch.logsumexp(aT_p + final, dim=-1)
    if not (torch.isneginf(log_p[1]) and int(torch.isfinite(log_p).sum()) == B - 1):
        raise AssertionError(f"num_steady_backward [{path}]: expected one impossible sequence")
    alphas = torch.cat([alpha1[None], rest_p[:-1]])
    args4 = (*tables, ysm, alphas, final, log_p)
    k4_bytes, k4_staged = nr.steady_plan(L, Tm1, Sn, Sn * Kr, W, dev)
    # what placing a batch costs for K3's and K4's list: CUDA events around
    # whole calls, the host's read of the list's length included
    placement_ms = _time_ms(lambda: nr.kernel_tables(*tables), 5)
    _log(f"kernel num_steady_backward [{path}]: {arcs} live arcs, at most {L} a sequence;"
         f" {k4_bytes} bytes of shared memory per block, the list"
         f" {'staged there' if k4_staged else 'streamed frame by frame'}")
    beta1_k, gsm_k = nr.steady_backward(*args4, pre=pre)
    torch.cuda.synchronize()
    beta1_p, gsm_p = nr.steady_backward_plain(*args4)
    if not bool((gsm_k[:, 1] == 0).all()):
        raise AssertionError(f"num_steady_backward [{path}]: the impossible sequence has occupancies")
    again = nr.steady_backward(*args4, pre=pre)
    if not (torch.equal(again[0], beta1_k) and torch.equal(again[1], gsm_k)):
        raise AssertionError(f"num_steady_backward [{path}]: two launches differ")
    # the plan not chosen, where it fits: the same bits, and timed in turns
    other4 = _other_plan(lambda p: nr.steady_plan(L, Tm1, Sn, Sn * Kr, W, dev, p), k4_staged)
    if other4 is not None:
        again = nr.steady_backward(*args4, pre=pre, staged=other4)
        if not (torch.equal(again[0], beta1_k) and torch.equal(again[1], gsm_k)):
            raise AssertionError(f"num_steady_backward [{path}]: the two plans differ")
    # occupancies are probabilities (each frame's sum to 1): atol 1e-6.  The
    # bound counts the live list K4 reads (and, kept beside it, the dense
    # tables the TPU kernel and the dense design before it read)
    rest_bytes = 4.0 * (B * Tm1 * W + Tm1 * B * Sn + B * Sn + B + Tm1 * B * W + B * Sn)
    record(
        "num_steady_backward",
        [_check(f"num_steady_backward [{path}]", "beta1", beta1_k, beta1_p, 1e-5, 1e-5),
         _check(f"num_steady_backward [{path}]", "gsm", gsm_k, gsm_p, 1e-6, 1e-5)],
        _times(lambda: nr.steady_backward(*args4, pre=pre), 50,
               plain=lambda: nr.steady_backward_plain(*args4), plain_reps=5,
               other=None if other4 is None
               else lambda: nr.steady_backward(*args4, pre=pre, staged=other4)),
        8.0 * arcs + 2.0 * B * Tm1 * (Sn + W),
        list_bytes + rest_bytes,
        frames=Tm1,
        placement_ms=placement_ms,
        log_only=dict(
            dense_tables_bound_ms=_bound(8.0 * arcs + 2.0 * B * Tm1 * (Sn + W),
                                         table_bytes + rest_bytes)[0],
            shared_bytes=k4_bytes, staged=k4_staged),
    )
    return measured


#: the second attention shape: T_out of chunks of 150 output frames
T_LONG = 150
#: batch rows of the attention's card-vs-CPU check
B_CPU = 8


def check_attention(rng, Bn: int, T: int, dtype_name: str,
                    D: int = CONFORMER["dim"]) -> dict[str, dict]:
    """Phase 3, attention: K7f and K7b against their plain versions at qkv
    [Bn, T, 3 * D], 4 heads of D / 4 (64 on the conformer paths; 96 and 128
    at D 384 and 512, the kernels' wide tiles), with operands of one dtype, timed in turn
    with one library call each: `scaled_dot_product_attention` with the bias
    as its float mask, and for K7b autograd of that call with the float32 bias
    requiring a gradient, broadcast over the batch (the einsum form's autograd
    as `einsum_ms`).  Then `fused_relpos_attention` on the card against the CPU
    at B_CPU rows: its output and both gradients.  Returns the measurements
    by kernel name; raises on disagreement."""
    import torch
    import torch.nn.functional as F

    from torchain_tpu_torch.ops import attention as at

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    bf16 = dtype == torch.bfloat16
    esz = 2 if bf16 else 4
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    H = CONFORMER["num_heads"]
    dh = D // H
    measured = {}

    def rand(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype("float32") * scale, device=dev)

    # qkv of the scale a LayerNorm followed by a fresh Dense gives, the bias
    # of the scale of a trained table
    label = f"conformer {dtype_name}, T={T}" + (f", dh {dh}" if D != CONFORMER["dim"] else "")
    qkv, g = rand(Bn, T, 3 * D).to(dtype), rand(Bn, T, D).to(dtype)
    bias = rand(H, T, T, scale=0.3)
    scale = 1.0 / math.sqrt(dh)
    out_k = at.attention_forward(qkv, bias, H, scale)
    torch.cuda.synchronize()
    out_p = at.attention_forward_plain(qkv, bias, H, scale)
    # float32: sums of 64 and T float32 products in another order, outputs
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
        4.0 * Bn * H * T * T * dh,
        esz * (Bn * T * 3 * D + Bn * T * D) + 4.0 * H * T * T,
        peak,
        einsum_ms=_device_ms(lambda: at.reference_relpos_attention(qkv, bias, H, scale), 20),
        host_us=_host_us(lambda: at.attention_forward(qkv, bias, H, scale)),
    )
    dqkv_k, dbias_k = at.attention_backward(qkv, bias, g, H, scale)
    torch.cuda.synchronize()
    dqkv_p, dbias_p = at.attention_backward_plain(qkv, bias, g, H, scale)
    # dbias is a float32 sum over the batch rows of terms of order 0.1, from
    # the same operands on both sides
    checks = [
        _check(f"attention_backward [{label}]", "dqkv", dqkv_k, dqkv_p, *tol),
        _check(f"attention_backward [{label}]", "dbias", dbias_k, dbias_p, 1e-4, 1e-4),
    ]
    again = at.attention_backward(qkv, bias, g, H, scale)
    if not (torch.equal(again[0], dqkv_k) and torch.equal(again[1], dbias_k)):
        raise AssertionError(f"attention_backward [{label}]: two launches differ")
    # the one-call yardstick: SDPA's own backward, the bias gradient included
    qkv_s, bias_s = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    qs, ks, vs = at._heads(qkv_s, H)
    sdpa_out = at._merge(F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=bias_s.to(dtype)[None], scale=scale))
    # and autograd through the einsum formulation
    qkv_r, bias_r = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    ref_out = at.reference_relpos_attention(qkv_r, bias_r, H, scale)
    _record(
        measured, "attention_backward", label, checks,
        _times(lambda: at.attention_backward(qkv, bias, g, H, scale), 20,
               library=lambda: torch.autograd.grad(sdpa_out, (qkv_s, bias_s), g,
                                                   retain_graph=True),
               plain=lambda: at.attention_backward_plain(qkv, bias, g, H, scale), plain_reps=20),
        10.0 * Bn * H * T * T * dh,
        esz * (2 * Bn * T * 3 * D + Bn * T * D) + 8.0 * H * T * T,
        peak,
        einsum_ms=_device_ms(lambda: torch.autograd.grad(ref_out, (qkv_r, bias_r), g,
                                                         retain_graph=True), 20),
        host_us=_host_us(lambda: at.attention_backward(qkv, bias, g, H, scale)),
    )
    del sdpa_out, ref_out
    by_launch = attention_launches(qkv, bias, g, H, scale)
    _log(f"K7 [{label}]: device µs per call by launch {by_launch}")
    for name, rec in measured.items():
        rec["device_us_by_launch"] = {
            k: v for k, v in by_launch.items() if ("fwd" in k) == (name == "attention_forward")}

    # the autograd.Function on the card (kernels) against the CPU (plain
    # versions) at B_CPU rows: the same arithmetic in another order (bfloat16:
    # up to one rounding step of the outputs and gradients)
    grads = {}
    for d in ("cuda", "cpu"):
        q = qkv[:B_CPU].detach().to(d).clone().requires_grad_()
        bb = bias.detach().to(d).clone().requires_grad_()
        o = at.fused_relpos_attention(q, bb, H, scale)
        torch.sum(o.float() * g[:B_CPU].float().to(d)).backward()
        grads[d] = (o.detach().cpu(), q.grad.cpu(), bb.grad.cpu())
    cpu_tol = dict(out=tol, dqkv=tol, dbias=(1e-4, 1e-4))
    for what, a, c in zip(cpu_tol, grads["cuda"], grads["cpu"]):
        measured["attention_backward"]["checks"].append(
            _check(f"fused_relpos_attention [{label}, B={B_CPU}]", f"{what}, card vs cpu", a, c,
                   *cpu_tol[what]))
    return measured


def attention_launches(qkv, bias, g, H: int, scale: float, calls: int = 20) -> dict[str, float]:
    """Device µs per call of each kernel that one K7f and one K7b call
    launch (torch.profiler over `calls` calls of each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchain_tpu_torch.ops import attention as at

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            at.attention_forward(qkv, bias, H, scale)
            at.attention_backward(qkv, bias, g, H, scale)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:  # "void (anonymous namespace)::attn_fwd_kernel<...>(...)" -> attn_fwd_kernel
            name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            out[name.split("<")[0].split("(")[0] or e.key] = us / calls
    return out


def check_conformer_kernels(seed: int, dtype_name: str) -> dict[str, dict]:
    """Phase 3, conformer: K7f, K7b, K10f and K10b against their plain
    versions at the conformer path's shapes (B=128, T=50, 4 heads of 64;
    N = B*T = 6400 rows, D=256, F=1024) with operands of one dtype, with
    times; with bfloat16 also K7f and K7b at T=150 (`check_attention`), and
    K10f and K10b also at D 512, F 2048 (`check_ffn`).
    Returns the measurements by kernel name; raises on disagreement."""
    import numpy as np

    D, Fh, N = CONFORMER["dim"], 4 * CONFORMER["dim"], B * T_OUT
    label = f"conformer {dtype_name}"
    bf16 = dtype_name == "bfloat16"
    rng = np.random.default_rng(seed)
    measured = {}

    # K7f / K7b at the path's T, and for bfloat16 also at T=150 (chunks of
    # 150 output frames; the first design's K7b refused T > 117)
    measured.update(check_attention(rng, B, T_OUT, dtype_name))
    if bf16:
        second = check_attention(rng, B, T_LONG, dtype_name)
        for name, rec in second.items():
            measured[name]["second_shape"] = rec
    # and at heads 96 and 128 wide (a conformer of dim 384 or 512 with 4
    # heads), at both lengths
    for wide in (384, 512):
        for T in (T_OUT, T_LONG):
            for name, rec in check_attention(rng, B, T, dtype_name, D=wide).items():
                measured[name].setdefault("wide_heads", {})[f"dh {wide // 4}, T={T}"] = rec

    # K10f / K10b at the conformer's width, and at D 512, F 2048 (a
    # conformer of dim 512: two column groups a row tile, xn streamed)
    measured.update(check_ffn(rng, dtype_name, D, Fh, N, label))
    for name, rec in check_ffn(rng, dtype_name, *FFN_WIDE, N, f"{label}, D 512").items():
        measured[name]["d512"] = rec
    # and one model rank's share of the split half-step of the model axis's
    # path (`check_parallel` (d)): F / 2 hidden columns, float32 out and dx
    for name, rec in check_ffn(rng, dtype_name, D, Fh // MODEL_AXIS, PARALLEL_CONFORMER_B * T_OUT,
                               f"{label}, model shard", partial=True).items():
        measured[name]["model_shard"] = rec
    return measured


#: a conformer width past one block's 384 output columns: dim 512, F 2048
FFN_WIDE = (512, 2048)


def check_ffn(rng, dtype_name: str, D: int, Fh: int, N: int, label: str,
              partial: bool = False) -> dict[str, dict]:
    """K10f and K10b against their plain versions on N rows of width D
    (hidden width Fh) with operands of one dtype, with times; with
    `partial`, as one model rank's share of a split half-step (float32
    out and dx, no residual and no b2; the library call the `Dense` chain
    of that share).  Returns the measurements by kernel name; raises on
    disagreement."""
    import numpy as np
    import torch

    from torchain_tpu_torch.ops import fused_ffn as ff

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    bf16 = dtype == torch.bfloat16
    esz = 2 if bf16 else 4
    measured = {}

    def rand(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * scale, device=dev)

    # xn as a LayerNorm leaves it, weights of the scale of their initialiser
    # (variance 1 / fan-in), cast to the trunk dtype.  The products run on
    # the tensor cores: bfloat16 at its peak, float32 as three TF32 products
    # each (the bound counts the operations it does)
    xn, res, gf = rand(N, D).to(dtype), rand(N, D).to(dtype), rand(N, D).to(dtype)
    w1, w2 = rand(D, Fh, scale=D ** -0.5).to(dtype), rand(Fh, D, scale=Fh ** -0.5).to(dtype)
    b1, b2 = rand(Fh, scale=0.1), rand(D, scale=0.1)
    ffn_peak, ffn_ops = (PEAK_BF16_FLOPS, 1) if bf16 else (PEAK_TF32_FLOPS, TF32_PRODUCTS)
    pk = dict(partial=True) if partial else {}
    o_k = ff.ffn_forward(xn, res, w1, b1, w2, b2, 0.5, **pk)
    torch.cuda.synchronize()
    o_p = ff.ffn_forward_plain(xn, res, w1, b1, w2, b2, 0.5, **pk)
    # float32: sums of D and F products in another order.  A bfloat16
    # share is float32 (not rounded to bf16): only h's roundings part it
    # from the plain version (NVIDIA H100 80GB HBM3, 700 W: out 1.14e-3, dx
    # 8.09e-4), so its limit is ~3.5x those and far below its entries (~0.3)
    tol = (1e-4, 1e-4) if not bf16 else (4e-3, 0.0) if partial else (2e-2, 1e-2)

    def dense_chain(x, r, a1, c1, a2, c2):
        u = x @ a1 + c1.to(dtype)
        if partial:
            return 0.5 * ((u * torch.sigmoid(u)) @ a2).float()
        return r + 0.5 * ((u * torch.sigmoid(u)) @ a2 + c2.to(dtype))

    def record_ffn(name, checks, kernel, plain, library, flops, nbytes):
        """Kernel, plain version and library call timed in turn, with the
        kernel's achieved rate and the share of its bound it reaches."""
        t = _times(kernel, 20, library=library, plain=plain)
        bound_ms, _ = _bound(ffn_ops * flops, nbytes, ffn_peak)
        _record(measured, name, label, checks, t, ffn_ops * flops, nbytes, ffn_peak,
                tflops=flops / t["ms"] / 1e9, bound_fraction=bound_ms / t["ms"])

    # bytes: xn (and res) read, out written (float32 for a share), W1, W2
    # and the biases read once
    fwd_bytes = (esz * (N * D + 2 * D * Fh) + 4.0 * (N * D + Fh) if partial
                 else esz * (3 * N * D + 2 * D * Fh) + 4.0 * (Fh + D))
    record_ffn(
        "ffn_forward", [_check(f"ffn_forward [{label}]", "out", o_k, o_p, *tol)],
        lambda: ff.ffn_forward(xn, res, w1, b1, w2, b2, 0.5, **pk),
        lambda: ff.ffn_forward_plain(xn, res, w1, b1, w2, b2, 0.5, **pk),
        lambda: dense_chain(xn, res, w1, b1, w2, b2),
        4.0 * N * D * Fh, fwd_bytes,
    )
    grads_k = ff.ffn_backward(xn, gf, w1, b1, w2, 0.5, **pk)
    torch.cuda.synchronize()
    grads_p = ff.ffn_backward_plain(xn, gf, w1, b1, w2, 0.5, **pk)
    # the weight and bias gradients are float32 sums over 6400 rows (entries
    # up to ~100).  With bfloat16 operands a hidden activation or a dh that
    # sits on a rounding boundary may round the other way (the float32
    # values differ in the last bit), which moves one term of a weight
    # gradient's sum by one bfloat16 step; db1 sums the unrounded dh
    wtol = (5e-2, 1e-3) if bf16 else (1e-3, 1e-4)
    tols = dict(dx=tol, dw1=wtol, db1=(1e-3, 1e-4), dw2=wtol, db2=(1e-3, 1e-4))
    checks = [_check(f"ffn_backward [{label}]", what, a, b, *tols[what])
              for what, a, b in zip(tols, grads_k, grads_p)]
    if not all(torch.equal(a, b) for a, b in zip(ff.ffn_backward(xn, gf, w1, b1, w2, 0.5, **pk),
                                                   grads_k)):
        raise AssertionError(f"ffn_backward [{label}]: two launches differ")
    leaves = [t.clone().requires_grad_() for t in (xn, w1, b1, w2, b2)]
    chain_out = dense_chain(leaves[0], res, *leaves[1:])
    chain_leaves = leaves[:4] if partial else leaves
    g_chain = gf.float() if partial else gf
    # bytes: xn and g read, dx written (float32 for a share), W1, W2 and b1
    # read, the weight and bias gradients written in float32
    bwd_bytes = (esz * (2 * N * D + 2 * D * Fh) + 4.0 * (N * D + Fh + 2 * D * Fh + Fh + D)
                 if partial else
                 esz * (3 * N * D + 2 * D * Fh) + 4.0 * (Fh + 2 * D * Fh + Fh + D))
    record_ffn(
        "ffn_backward", checks,
        lambda: ff.ffn_backward(xn, gf, w1, b1, w2, 0.5, **pk),
        lambda: ff.ffn_backward_plain(xn, gf, w1, b1, w2, 0.5, **pk),
        lambda: torch.autograd.grad(chain_out, chain_leaves, g_chain, retain_graph=True),
        10.0 * N * D * Fh, bwd_bytes,
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
    L8 = pre[3].shape[1]
    k8f_bytes, k8f_staged = nr.e2e_forward_plan(L8, S, dev)
    _log(f"kernel e2e_forward [{label}]: {live} live arcs, at most {L8} a sequence;"
         f" {k8f_bytes} bytes of shared memory per block, the list"
         f" {'staged there' if k8f_staged else 'read from device memory'}")
    rest_k = nr.e2e_forward_resident(ylocal, src, logw, pre=pre)
    torch.cuda.synchronize()
    rest_p = nr.e2e_forward_plain(ylocal, src, logw)
    if not torch.equal(nr.e2e_forward_resident(ylocal, src, logw, pre=pre), rest_k):
        raise AssertionError(f"e2e_forward [{label}]: two launches differ")
    # the unstaged plan, where the sizes chose the staged one (the limit
    # lowered below it): the same bits, and timed in turns
    lim8f = _unstaging_limit(nr.E2E_LIMIT, lambda: nr.e2e_forward_plan(L8, S, dev),
                             k8f_bytes, k8f_staged)
    other8f = None if lim8f is None else _under(
        nr.E2E_LIMIT, lim8f, lambda: nr.e2e_forward_resident(ylocal, src, logw, pre=pre))
    if other8f is not None and not torch.equal(other8f(), rest_k):
        raise AssertionError(f"e2e_forward [{label}]: the two plans differ")
    # f32 log-sum-exps of a few terms per state in another order, carried
    # over 50 frames; -inf (unreachable states) in the same places.  The
    # bound is bytes, each once: of ylocal the live slots only (pad slots
    # hold nothing the function needs), the graph as the smaller of the
    # live list (src, logw and the slot of each live entry, with the
    # offsets) and the full tables (src, logw, the count of each state's
    # arcs: smaller where nearly every slot is live, as at K = 2), and the
    # alphas out (kept beside it: both counts); operations count live
    # arcs.  The 50 dependent frames set a latency floor it does not see
    live_bytes = 12.0 * live + 4.0 * Bs * (S + 1)
    table_bytes = 8.0 * Bs * S * K + 4.0 * Bs * S  # int32 src, f32 logw, int32 nk
    graph_bytes = min(live_bytes, table_bytes)
    _record(
        measured, "e2e_forward", label,
        [_check(f"e2e_forward [{label}]", "alphas", rest_k, rest_p, 1e-5, 1e-5)],
        _times(lambda: nr.e2e_forward_resident(ylocal, src, logw, pre=pre), 20,
               plain=lambda: nr.e2e_forward_plain(ylocal, src, logw), plain_reps=3,
               other=other8f),
        4.0 * T * live + 2.0 * Bs * T * S,
        4.0 * T * live + graph_bytes + 4.0 * T * Bs * S,
        frames=T,
        log_only=dict(full_tables_bound_ms=_bound(4.0 * T * live + 2.0 * Bs * T * S,
                                                  4.0 * T * live + table_bytes
                                                  + 4.0 * T * Bs * S)[0],
                      live_list_bound_ms=_bound(4.0 * T * live + 2.0 * Bs * T * S,
                                                4.0 * T * live + live_bytes
                                                + 4.0 * T * Bs * S)[0],
                      shared_bytes=k8f_bytes, staged=k8f_staged),
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
    k8_bytes, k8_staged = nr.e2e_backward_plan(L8, S, dev)
    _log(f"kernel e2e_backward [{label}]: {live} live arcs, at most {L8} a"
         f" sequence; {k8_bytes} bytes of shared memory per block, the list"
         f" {'staged there' if k8_staged else 'read from device memory'}")
    post_k = nr.e2e_backward_resident(*args, pre=pre)
    torch.cuda.synchronize()
    post_p = nr.e2e_backward_plain(*args)
    if not bool((post_k[1:3] == 0).all()):
        raise AssertionError(f"e2e_backward [{label}]: a sequence without a finite log p"
                             " has posteriors")
    if not bool(torch.equal(post_k, nr.e2e_backward_resident(*args, pre=pre))):
        raise AssertionError(f"e2e_backward [{label}]: two launches differ")
    # the plan not chosen, where it fits: the same bits, and timed in turns
    other8 = _other_plan(lambda p: nr.e2e_backward_plan(L8, S, dev, p), k8_staged)
    if other8 is not None and not bool(
            torch.equal(post_k, nr.e2e_backward_resident(*args, pre=pre, staged=other8))):
        raise AssertionError(f"e2e_backward [{label}]: the two plans differ")
    # posteriors are probabilities: exp of a float32 sum of magnitude ~100,
    # whose last bit (8e-6) becomes that relative error; the betas inside
    # differ by the order of their log-sum-exps.  Bytes: ylocal's live
    # slots read, post written in full (its pad slots are zeros the contract
    # asks for), and the graph as K8f counts it (the smaller of the live
    # list and the full tables)
    _record(
        measured, "e2e_backward", label,
        [_check(f"e2e_backward [{label}]", "post", post_k, post_p, 1e-5, 1e-4)],
        _times(lambda: nr.e2e_backward_resident(*args, pre=pre), 20,
               plain=lambda: nr.e2e_backward_plain(*args), plain_reps=3,
               other=None if other8 is None
               else lambda: nr.e2e_backward_resident(*args, pre=pre, staged=other8)),
        8.0 * T * live + 2.0 * Bs * T * S,
        4.0 * T * live + 4.0 * Bs * T * S * K + graph_bytes
        + 4.0 * (T * Bs * S + Bs * S + Bs),
        frames=T,
        log_only=dict(live_list_bound_ms=_bound(
            8.0 * T * live + 2.0 * Bs * T * S,
            4.0 * T * live + 4.0 * Bs * T * S * K + live_bytes
            + 4.0 * (T * Bs * S + Bs * S + Bs))[0], shared_bytes=k8_bytes, staged=k8_staged),
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
    holds behind the sleep of `_device_ms`).  Each kernel is launched twice
    for equal bits.  Returns the measurements by kernel name; raises on
    disagreement."""
    import torch

    from torchain_tpu_torch.ops import den_dense as dd
    from torchain_tpu_torch.ops import den_pallas as dp

    S, E, T = den.num_orig, den.num_exp, y.shape[1]
    leaky = 0.1
    measured = {}
    for backward in (0, 1):
        what = "dense_den_backward" if backward else "dense_den_forward"
        nbytes, staged = dp.shared_plan(den, backward, y.device)
        forms = " and ".join(f for f, bit in (("CSR", dp.CSR), ("CSC", dp.CSC)) if staged & bit)
        _log(f"kernel {what} [{label}]: {nbytes} bytes of shared memory per block,"
             f" V's compressed forms {forms + ' staged there' if forms else 'read through L2'}")
    log_z, res = dp.den_forward(y, den, leaky)  # K9f
    gamma = dp.den_backward(den, res, leaky)  # K9b
    torch.cuda.synchronize()
    pe, sig_k, logc_k = res["pe"], res["sigma_hats"], res["logc"]
    logc_p, sig_p = dp.dense_forward_plain(pe, den, leaky)
    logc_l, sig_l = dense_forward_library(pe, den, leaky)
    log_z_d, res_d = dd.den_forward(y, den, leaky)
    gamma_d = dd.den_backward(den, res_d, leaky)
    # f32 sums of a column's few non-zeros (the plain version and the library:
    # of S = 2176 products) in another order, carried over 50 frames through
    # the per-frame renormalisation: log c is O(1), sigma_hats sums to 1 over
    # a frame's states (held relative to its size).  log Z, the sum of 50
    # log c and 50 ymax, is of order 100
    checks = [
        _check(f"dense_den_forward [{label}]", "logc", logc_k, logc_p, 1e-5, 0.0),
        _check(f"dense_den_forward [{label}]", "sigma_hats", sig_k, sig_p, 1e-6, 1e-4),
        _check(f"dense_den_forward [{label}]", "log_z vs den_dense", log_z, log_z_d, 1e-4, 1e-5),
        _check(f"dense_den_forward [{label}]", "logc vs library", logc_k, logc_l, 1e-5, 0.0),
        _check(f"dense_den_forward [{label}]", "sigma_hats vs library", sig_k, sig_l, 1e-6, 1e-4),
    ]
    again = dp.dense_forward_kernel(pe, den, leaky)
    if not (torch.equal(again[0], logc_k) and torch.equal(again[1], sig_k)):
        raise AssertionError("dense_den_forward: two launches differ")
    # V's compressed forms: int32 offsets, f32 values and 16-bit indices
    csc = 4.0 * (E + 1) + 6.0 * den.nnz
    csr = 4.0 * (S + 1) + 6.0 * den.nnz
    _record(
        measured, "dense_den_forward", label, checks,
        _times(lambda: dp.dense_forward_kernel(pe, den, leaky), 5,
               library=_captured(lambda: dense_forward_library(pe, den, leaky)),
               plain=lambda: dp.dense_forward_plain(pe, den, leaky), plain_reps=5),
        2.0 * T * B * den.nnz,
        csc + 4.0 * (T * B * E + S + (S + 1) + den.real_exp + T * B + T * B * S),
        frames=T,
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
        2.0 * (2 * T - 1) * B * den.nnz + 6.0 * T * B * E,
        csc + csr + 2.0 * E + 4.0 * (S + 1)
        + 4.0 * (T * B * E + S + T * B * S + 2 * T * B + T * B * E),
        frames=T,
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


#: the fifteen kernels: (wrapper module, wrapper, source, the TPU kernel replaced,
#: the device kernel that one call of the wrapper launches once)
KERNELS = {
    "den_forward": ("ops.den_resident", "den_forward_kernel",
                    "torchain_tpu_torch/csrc/den_resident.cu",
                    "torchain_tpu/ops/den_resident.py:565", "den_fwd_kernel"),
    "den_backward": ("ops.den_resident", "den_backward_kernel",
                     "torchain_tpu_torch/csrc/den_resident.cu",
                     "torchain_tpu/ops/den_resident.py:615", "den_bwd_kernel"),
    "num_steady_forward": ("ops.num_resident", "steady_forward",
                           "torchain_tpu_torch/csrc/num_resident.cu",
                           "torchain_tpu/ops/num_resident.py:158", "steady_fwd_kernel"),
    "num_steady_backward": ("ops.num_resident", "steady_backward",
                            "torchain_tpu_torch/csrc/num_resident.cu",
                            "torchain_tpu/ops/num_resident.py:207", "steady_bwd_kernel"),
    "vocab_gather": ("ops.num_scan", "vocab_gather", "torchain_tpu_torch/csrc/num_vocab.cu",
                     "torchain_tpu/ops/num_scan.py:140", "vocab_gather_kernel"),
    "vocab_scatter": ("ops.num_scan", "vocab_scatter", "torchain_tpu_torch/csrc/num_vocab.cu",
                      "torchain_tpu/ops/num_scan.py:179", "vocab_scatter_kernel"),
    "attention_forward": ("ops.attention", "attention_forward",
                          "torchain_tpu_torch/csrc/attention.cu",
                          "torchain_tpu/ops/attention.py:219", "attn_fwd_kernel"),
    "attention_backward": ("ops.attention", "attention_backward",
                           "torchain_tpu_torch/csrc/attention.cu",
                           "torchain_tpu/ops/attention.py:258", "attn_bwd_cols_kernel"),
    "ffn_forward": ("ops.fused_ffn", "ffn_forward", "torchain_tpu_torch/csrc/fused_ffn.cu",
                    "torchain_tpu/ops/fused_ffn.py:200", "ffn_fwd_kernel"),
    "ffn_backward": ("ops.fused_ffn", "ffn_backward", "torchain_tpu_torch/csrc/fused_ffn.cu",
                     "torchain_tpu/ops/fused_ffn.py:239", "ffn_bwd_weights_kernel"),
    "e2e_forward": ("ops.num_resident", "e2e_forward_resident",
                    "torchain_tpu_torch/csrc/num_e2e.cu",
                    "torchain_tpu/ops/num_resident.py:319", "e2e_fwd_kernel"),
    "e2e_backward": ("ops.num_resident", "e2e_backward_resident",
                     "torchain_tpu_torch/csrc/num_e2e.cu",
                     "torchain_tpu/ops/num_resident.py:356", "e2e_bwd_kernel"),
    "dense_den_forward": ("ops.den_pallas", "dense_forward_kernel",
                          "torchain_tpu_torch/csrc/den_dense.cu",
                          "torchain_tpu/ops/den_pallas.py:118", "dense_fwd_kernel"),
    "dense_den_backward": ("ops.den_pallas", "dense_backward_kernel",
                           "torchain_tpu_torch/csrc/den_dense.cu",
                           "torchain_tpu/ops/den_pallas.py:160", "dense_bwd_kernel"),
    "probe_smem": ("tools.probe_smem", "try_size", "torchain_tpu_torch/csrc/probe_smem.cu",
                   "tools/probe_vmem.py:27", "probe_kernel"),
}


def counters():
    """The kernel wrappers, by kernel name (each carries `.launches`)."""
    import importlib

    return {
        name: getattr(importlib.import_module(f"torchain_tpu_torch.{mod}"), fn)
        for name, (mod, fn, *_) in KERNELS.items()
    }


def train_steps(cfg, feat_dim, feats, den, sup, steps: int, seed: int, after_step=None):
    """Phase 4: one path.  Returns (losses, step ms list, launches, step,
    model).  `after_step(i)`, where given, is called after step i's
    synchronize."""
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
        if after_step is not None:
            after_step(len(times) - 1)
    launches = {k: fn.launches for k, fn in counters().items()}
    return losses, times, launches, step, model


def profile_steps(step, feats, den, sup, n: int, out_path: pathlib.Path | None) -> dict:
    """--profile: torch.profiler over `n` more train steps on one batch
    (`_trace`)."""
    def run():
        for _ in range(n):
            step(feats, den, sup)

    return _trace(run, n, out_path)


def _trace(run, n: int, out_path: pathlib.Path | None = None) -> dict:
    """torch.profiler over `run()`, which makes `n` train steps.  Writes the
    per-kernel table to `out_path`, where given; returns wall and
    device-busy ms per step (device busy = the sum of the kernels' device
    time; one stream, so they do not overlap), split into the port's
    kernels, cuBLAS GEMMs and the rest, launches a step on the card and on
    the host, and `port_launches`: each kernel of KERNELS by name, the
    launches of its device kernel (one a wrapper call) in the whole run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    from torch.autograd import DeviceType

    # device kernels and copies only: an operator's own row repeats its
    # kernels' time, and a user annotation's device row spans them
    avg = prof.key_averages()
    kern = [e for e in avg
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]
    if not kern:
        raise AssertionError("the profiler recorded no device kernels")

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    ours = ("den_fwd_kernel", "den_bwd_kernel",
            "vocab_gather_kernel", "vocab_scatter_kernel",
            "steady_fwd_kernel", "steady_bwd_kernel",
            "attn_fwd_kernel", "attn_bwd_rows_kernel", "attn_bwd_cols_kernel",
            "dbias_reduce_kernel",
            "ffn_fwd_kernel", "ffn_bwd_rows_kernel", "ffn_bwd_weights_kernel",
            "sum_parts_kernel", "e2e_fwd_kernel", "e2e_bwd_kernel",
            "dense_fwd_kernel", "dense_bwd_kernel")
    is_ours = [any(k in e.key for k in ours) for e in kern]
    # cuBLAS names its Hopper bf16 kernels "nvjet_..."
    is_gemm = [not o and any(k in e.key.lower() for k in ("gemm", "sm90", "nvjet"))
               for e, o in zip(kern, is_ours)]
    busy = sum(dev_us(e) for e in kern) / 1e3 / n
    port = sum(dev_us(e) for e, o in zip(kern, is_ours) if o) / 1e3 / n
    gemm = sum(dev_us(e) for e, g in zip(kern, is_gemm) if g) / 1e3 / n
    launches = sum(e.count for e in kern) // n
    port_launches = {
        name: sum(e.count for e in kern if re.search(rf"\b{entry[4]}\b", e.key))
        for name, entry in KERNELS.items()}
    # the host's calls that put work on the card (a kernel, a copy, a fill,
    # a graph)
    host_launches = sum(e.count for e in avg
                        if e.device_type == DeviceType.CPU and e.key.startswith(
                            ("cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset",
                             "cuLaunch"))) // n
    rows = sorted(kern, key=dev_us, reverse=True)
    lines = [f"{dev_us(e) / 1e3 / n:10.3f} ms/step {e.count // n:7d} launches/step  {e.key[:100]}"
             for e in rows][:40]
    if out_path is not None:
        out_path.write_text("\n".join(lines) + "\n")
    return dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                port_kernels_ms=port, library_gemm_ms=gemm, other_ms=busy - port - gemm,
                kernel_launches=launches, host_launches=host_launches, top=lines[:12],
                port_launches=port_launches)


def _den_form_run(name: str, cfg, feat_dim, feats, den, sup, must: tuple, ref: float | None,
                  gate: float, ref_ms: float | None, label: str, args, steps: int) -> dict:
    """One denominator form trained `steps` steps from the seeded weights:
    the kernels of `must` moved and no other, the first loss within `gate`
    of `ref` (None: this form is the reference) and falling; its median step (steps 2..N, host clock around a
    synchronize), peak device memory, and the allocator's counters
    (`torch.cuda.memory_stats`: cudaMalloc calls and retries after a failed
    one) over steps 1 and 2..N; with --profile two more steps traced."""
    import torch

    keys = ("num_alloc_retries", "num_device_alloc")
    stats = []

    def snap(i):
        if i in (0, steps - 1):
            stats.append(torch.cuda.memory_stats())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats.append(torch.cuda.memory_stats())
    losses, times, launches, step, _ = train_steps(cfg, feat_dim, feats, den, sup, steps,
                                                   args.seed, after_step=snap)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    alloc = {f"{k}_step1": stats[1].get(k, 0) - stats[0].get(k, 0) for k in keys}
    alloc.update({f"{k}_steps2_{steps}": stats[2].get(k, 0) - stats[1].get(k, 0) for k in keys})
    for k, n in launches.items():
        if (k in must) != (n > 0):
            raise AssertionError(f"den form {name} [{label}]: kernel {k} counted {n}")
    first = losses[0]["loss"]
    step_ms = statistics.median(times[1:])
    ref, ref_ms = (first, step_ms) if ref is None else (ref, ref_ms)
    rel = abs(first - ref) / abs(ref)
    _log(f"den form {name} [{label}] ({type(den).__name__}): first loss {first:.6g} vs"
         f" {ref:.6g}: rel {rel:.3g} (gate {gate:g}); steps 2..{steps} median {step_ms:.2f}"
         f" ms/step, {step_ms / ref_ms:.2f}x the reference's {ref_ms:.2f} (all"
         f" {[round(t, 2) for t in times]}); peak device memory {peak_gib:.2f} GiB;"
         f" allocator over the steps {alloc}")
    if not (math.isfinite(first) and rel <= gate and losses[-1]["loss"] < first):
        raise AssertionError(f"den form {name} [{label}]: the first loss departs from the"
                             " reference's, or the loss did not fall")
    out = dict(form=type(den).__name__, first_loss=first, first_loss_rel=rel, step_ms=step_ms,
               step_ms_all=times, reference_step_ms=ref_ms, peak_memory_gib=peak_gib,
               allocator=alloc, launches=launches)
    if args.profile:
        prof = profile_steps(step, feats, den, sup, 2,
                             args.out / f"profile_den_{label}_{name}.txt" if args.out else None)
        _log(f"den form {name} [{label}] profile (traced steps only): wall"
             f" {prof['wall_ms']:.2f} ms/step, device busy {prof['device_busy_ms']:.2f} ms/step"
             f" (traced idle share {prof['idle_share']:.3f}) in {prof['kernel_launches']}"
             f" launches/step")
        for line in prof["top"]:
            _log("  " + line)
        out["profile"] = prof
    return out


@contextlib.contextmanager
def _patched(module, **attrs):
    """`module`'s attributes replaced by `attrs` for the block."""
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


#: the captured phase (`check_captured`): rounds of eager and captured runs
#: in turn; the gates of the captured step's metrics against the eager
#: step's on the same batches, by the path's trunk dtype: step 1, then every
#: later step (the same kernels in the same order: equal bits expected)
CAPTURED_ROUNDS = 3
CAPTURED_RTOL = {"float32": (1e-6, 1e-4), "bfloat16": (1e-5, 1e-3)}
CAPTURED_KEYS = ("loss", "objf", "grad_norm")
#: steps of each traced run of the captured phase, on A, B (the trace's
#: processing, not the steps, takes its time)
TRACED_STEPS = 2
#: each path's corpus, model config, dataset and denominator graph, kept by
#: `run_path` for the captured phase
_PATH_DATA: dict[str, tuple] = {}


def _captured_batches(path: str, dataset) -> tuple[list, dict]:
    """Batches A and B of the path's corpus on the card, padded to one set
    of supervision caps and with live-arc lists of one width (`L_cap`), as
    a captured step takes them."""
    import torch

    from torchain_tpu_torch.ops import DeviceE2eSupervision, DeviceSupervision

    if PATHS[path].get("sup") == "e2e":
        caps = dataset.estimate_e2e_caps()
        it, L, caps = dataset.batches(B, shuffle=False, sup_caps=caps), caps[3], caps[:3]

        def put(s):
            return DeviceE2eSupervision.from_host(s, device="cuda", vocab_cap=caps[2])
    else:
        caps = dataset.estimate_sup_caps()
        it, L = dataset.batches(B, shuffle=False, sup_caps=caps), dataset.estimate_live_arcs()

        def put(s):
            return DeviceSupervision.from_host(s, device="cuda")
    batches = [next(it), next(it)]
    placed = [(torch.as_tensor(b.feats, device="cuda"), put(b.sup).with_kernel_tables(L_cap=L))
              for b in batches]
    return placed, dict(caps=list(caps), L_cap=L)


def _run_steps(step, den, batches, steps: int) -> dict:
    """`steps` steps on batches A, B, A, ... from the launch counters at 0:
    each step's metrics, host ms (a synchronize on either side) and card ms
    (CUDA events around it), and the counters (an eager step's launches; a
    replay moves none)."""
    import torch

    for fn in counters().values():
        fn.launches = 0
    metrics, host, card = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(steps):
        feats, sup = batches[i % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        m = step(feats, den, sup)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        card.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, host_ms=host, card_ms=card,
                launches={k: fn.launches for k, fn in counters().items()})


def _worst_rel(a: list[dict], b: list[dict], keys=CAPTURED_KEYS) -> list[float]:
    """Per step, the largest |a - b| / |b| over `keys`."""
    return [max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for k in keys) for x, y in zip(a, b)]


def _steps_on(step, den, batches, steps: int):
    """A callable that makes `steps` steps on batches A, B, A, ... with no
    synchronize between them (for `_trace`)."""
    def run():
        for i in range(steps):
            feats, sup = batches[i % 2]
            step(feats, den, sup)

    return run


def _vocab_sum_scatter(post, pdf_local, Pv: int):
    """The flat-start vocabulary sum as `ops/num_e2e.py` wrote it before the
    one-hot product (`arcs_to_vocab`): one `scatter_add_`, whose atomic adds
    land in another order run after run."""
    B, T, S, K = post.shape
    index = pdf_local.reshape(B, 1, S * K).expand(B, T, S * K)
    return post.new_zeros((B, T, Pv)).scatter_add_(2, index, post.reshape(B, T, S * K))


def _e2e_vocab_sum(eager, captured, init, state, den, batches, steps: int) -> dict:
    """The `e2e` path's eager step with the arcs' vocabulary sum as the
    one-hot product and as the `scatter_add_` it replaced, from one state
    in turns scatter, product, product, scatter: ms a step (medians of
    steps 2.., host and card clocks), the peak memory the run adds, whether
    each form repeats its bits, how far the forms part by step; then a
    traced run of TRACED_STEPS steps of each (device busy, launches a
    step).  Printed, not gated."""
    import torch

    from torchain_tpu_torch.ops import num_e2e

    def form(name):
        return _patched(num_e2e, **({"arcs_to_vocab": _vocab_sum_scatter}
                                    if name == "scatter" else {}))

    runs = {"scatter": [], "product": []}
    for name in ("scatter", "product", "product", "scatter"):
        captured.restore(init)
        state.step = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with form(name):
            r = _run_steps(eager, den, batches, steps)
        r["peak_added_bytes"] = torch.cuda.max_memory_allocated() - base
        runs[name].append(r)
    out = {}
    for name, rs in runs.items():
        captured.restore(init)
        state.step = 0
        with form(name):
            prof = _trace(_steps_on(eager, den, batches, TRACED_STEPS), TRACED_STEPS)
        out[name] = dict(
            host_ms=[statistics.median(r["host_ms"][1:]) for r in rs],
            card_ms=[statistics.median(r["card_ms"][1:]) for r in rs],
            peak_added_bytes=[r["peak_added_bytes"] for r in rs],
            repeats_bits=rs[0]["metrics"] == rs[1]["metrics"],
            rel_between_runs=max(_worst_rel(rs[0]["metrics"], rs[1]["metrics"])),
            **{k: prof[k] for k in ("wall_ms", "device_busy_ms", "kernel_launches",
                                    "host_launches")})
    out["rel_by_step"] = _worst_rel(runs["scatter"][0]["metrics"], runs["product"][0]["metrics"])
    for name in runs:
        _log(f"  e2e eager, vocabulary sum by {name}: {json.dumps(out[name])}")
    _log(f"  e2e eager, scatter against product, rel by step: {json.dumps(out['rel_by_step'])}")
    return out


#: `_adam_forms`: capturable Adam fed the default Adam's gradients, no
#: model in the loop, must keep its parameters within this many times the
#: sum of `_bias_correction_gap` over the steps so far of the default run's,
#: relative to |p| + lr: the two differ by that factor and rounding
ADAM_OPEN_LOOP_MARGIN = 1.25
#: `_adam_forms`: bins of |step 1's gradient| for where the parameters part
GRAD_BINS = (0.0, 1e-8, 1e-6, 1e-4, math.inf)


def _bias_correction_gap(t: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """|1 - capturable Adam's update over the default's| at step t (|g| >>
    eps): capturable Adam computes the bias corrections 1 - b**t in
    float32, as optax does (b rounded to float32 first: 1 - 0.999 becomes
    0.0009999871), torch's default Adam in float64 on the host."""
    import torch

    st = torch.tensor(float(t))
    bc1, bc2 = (float(1 - torch.pow(b, st)) for b in (b1, b2))
    return abs(1 - (1 - b1**t) / bc1 * math.sqrt(bc2 / (1 - b2**t)))


def _adam_forms(cfg, feat_dim: int, seed: int, opts, den, batches, steps: int,
                captured_round: list[dict]) -> dict:
    """`trigram`: why capturable Adam parts from torch's default Adam.
    Eager runs from the seed's weights on A, B, A, ...: capturable (it must
    give the captured phase's round 1 bits: the warm-up and the restores
    leave no trace); the default, its gradients and parameters kept step by
    step; the default again from weights one float32 step up (`nextafter`),
    a control for how far training carries a rounding.  Then the open loop:
    capturable Adam fed the default run's gradients on a copy of the first
    weights, no model in the loop, against the default run's parameters
    step by step, gated at ADAM_OPEN_LOOP_MARGIN times the summed
    `_bias_correction_gap`: the one difference of the two forms' arithmetic
    beyond rounding.  And where the closed loops'
    parameters part after the last step, by the size of step 1's gradient
    (GRAD_BINS)."""
    import torch

    from torchain_tpu_torch.train import create_train_state, make_train_step

    lr = 1e-3

    def run(capturable: bool, nudge: bool = False, keep: tuple | None = None):
        st = create_train_state(make_model(cfg, feat_dim, "cuda", seed), lr=lr,
                                capturable=capturable)
        params = list(st.model.parameters())
        first = [p.detach().clone() for p in params]
        if nudge:
            with torch.no_grad():
                for p in params:
                    p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
        step = make_train_step(st, opts, max_grad_norm=5.0)

        def kept(feats, den_, sup):
            m = step(feats, den_, sup)
            keep[0].append([None if p.grad is None else p.grad.detach().clone()
                            for p in params])
            keep[1].append([p.detach().clone() for p in params])
            return m

        metrics = _run_steps(kept if keep else step, den, batches, steps)["metrics"]
        return metrics, first, [p.detach().clone() for p in params]

    cap, _, cap_last = run(True)
    grads, after = [], []
    default, first, default_last = run(False, keep=(grads, after))
    nudged, _, nudged_last = run(False, nudge=True)

    copies = [p.clone().requires_grad_(True) for p in first]
    opt = torch.optim.Adam(copies, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=True)
    open_loop = []
    for g, ref in zip(grads, after):
        for c, gi in zip(copies, g):
            c.grad = gi
        opt.step()
        open_loop.append(max(float(((c.detach() - r).abs() / (r.abs() + lr)).max())
                             for c, r in zip(copies, ref)))

    g1 = torch.cat([g.abs().flatten() for g in grads[0] if g is not None])

    def where(last):
        d = torch.cat([(a - b).abs().flatten() for a, b, g in zip(last, default_last, grads[0])
                       if g is not None])
        bins = {}
        for lo, hi in zip(GRAD_BINS, GRAD_BINS[1:]):
            m = (g1 >= lo) & (g1 < hi)
            bins[f"[{lo:g},{hi:g})"] = dict(
                elements=int(m.sum()), max_dp=float(d[m].max()) if m.any() else 0.0,
                over_tenth_lr=int((d[m] > lr / 10).sum()))
        return bins

    gap = [_bias_correction_gap(t) for t in range(1, steps + 1)]
    bound = [ADAM_OPEN_LOOP_MARGIN * sum(gap[:t]) for t in range(1, steps + 1)]
    out = dict(
        fresh_state_bits_equal=cap == captured_round,
        capturable_vs_default={k: _worst_rel(cap, default, (k,)) for k in ("loss", "grad_norm")},
        nudged_vs_default={k: _worst_rel(nudged, default, (k,)) for k in ("loss", "grad_norm")},
        open_loop_rel=open_loop, bias_correction_gap=gap, open_loop_bound=bound,
        where_capturable_parts=where(cap_last), where_nudged_parts=where(nudged_last))
    _log(f"  trigram: a fresh state's eager steps equal round 1's bits:"
         f" {out['fresh_state_bits_equal']}")
    for k in ("capturable_vs_default", "nudged_vs_default", "where_capturable_parts",
              "where_nudged_parts"):
        _log(f"  trigram Adam, {k}: {json.dumps(out[k])}")
    _log(f"  trigram Adam, open loop (capturable fed the default's gradients), rel by step:"
         f" {json.dumps(open_loop)}; the float32 bias correction's gap by step"
         f" {json.dumps(gap)}, gate by step {json.dumps(bound)}")
    if not out["fresh_state_bits_equal"]:
        raise AssertionError("captured [trigram]: the warm-up and the restores left a trace"
                             " (a fresh state trains to other bits)")
    if not all(x <= b for x, b in zip(open_loop, bound)):
        raise AssertionError(f"captured [trigram]: capturable Adam's update departs from the"
                             f" default's on the same gradients beyond the bias correction's"
                             f" gap ({open_loop} against {bound})")
    del grads, after
    return out


def _captured_path(path: str, args, smi: str) -> tuple[dict, dict]:
    """One path's eager step against its captured step: one model and one
    capturable Adam from the seed, captured once on batch A; then
    CAPTURED_ROUNDS rounds, each an eager run and a captured run of
    `--steps` steps on A, B, A, ... from the initial state (restored before
    each run); then a traced run of each mode.  Gated on the first round's
    metrics (CAPTURED_RTOL), and on the launches: a replay runs no Python,
    so the counters cannot see it, and its launches are read from the
    trace.  Each kernel's launches in the eager trace must equal the
    counters of that run, the captured trace's the eager trace's (a trace
    that lost events is taken once more), and be this path's kernels only.
    Returns the numbers and the captured run's traced launches."""
    import gc

    import torch

    from torchain_tpu_torch.ops import ChainLossOptions
    from torchain_tpu_torch.train import create_train_state, make_train_step

    t0 = time.perf_counter()
    corpus, cfg, dataset, den = _PATH_DATA[path]
    batches, sizes = _captured_batches(path, dataset)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    opts = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
    state = create_train_state(make_model(cfg, corpus.feat_dim, "cuda", args.seed), lr=1e-3,
                               capturable=True)
    eager = make_train_step(state, opts, max_grad_norm=5.0)
    captured = make_train_step(state, opts, max_grad_norm=5.0, capture=True)
    init = captured.snapshot()
    torch.cuda.reset_peak_memory_stats()
    captured.capture(batches[0][0], den, batches[0][1])
    runs = {"eager": [], "captured": []}
    for _ in range(CAPTURED_ROUNDS):
        for mode, step in (("eager", eager), ("captured", captured)):
            captured.restore(init)
            state.step = 0
            runs[mode].append(_run_steps(step, den, batches, args.steps))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    e, c = runs["eager"][0], runs["captured"][0]
    rtol1, rtol = CAPTURED_RTOL[PATHS[path]["dtype"]]
    rel = _worst_rel(c["metrics"], e["metrics"])
    bits = c["metrics"] == e["metrics"]
    # whether each mode gives its own first round's bits again
    repeat = {mode: all(r["metrics"] == rs[0]["metrics"] for r in rs) for mode, rs in runs.items()}
    out = dict(setup_s=setup_s, sizes=sizes, capture_s=captured.capture_s,
               pool_bytes=captured.pool_bytes, peak_memory_gib=peak_gib,
               step1_rel=rel[0], later_rel_max=max(rel[1:]), bits_equal=bits,
               rounds_repeat_bits=repeat, rtol=[rtol1, rtol],
               rel_by_key={k: max(_worst_rel(c["metrics"], e["metrics"], (k,)))
                           for k in CAPTURED_KEYS},
               eager_losses=[m["loss"] for m in e["metrics"]],
               captured_losses=[m["loss"] for m in c["metrics"]])
    for mode in runs:
        for clock in ("host_ms", "card_ms"):
            per_round = [statistics.median(r[clock][1:]) for r in runs[mode]]
            out[f"{mode}_{clock}_rounds"] = per_round
            out[f"{mode}_{clock}"] = statistics.median(per_round)
    # traced runs of TRACED_STEPS steps each from the initial state: device
    # busy, launches on the card and on the host (a replay is one graph
    # launch beside the copies of its inputs and the clones of its
    # metrics), and each kernel's launches, held to the eager run's
    # counters (eager) and to the eager run's trace (captured)
    traced = {}
    for mode, step in (("eager", eager), ("captured", captured)):
        for attempt in range(2):
            captured.restore(init)
            state.step = 0
            for fn in counters().values():
                fn.launches = 0
            prof = _trace(_steps_on(step, den, batches, TRACED_STEPS), TRACED_STEPS)
            want = ({k: fn.launches for k, fn in counters().items()} if mode == "eager"
                    else traced["eager"]["port_launches"])
            if prof["port_launches"] == want:
                break
            _log(f"  {path} {mode}: traced launches {prof['port_launches']} against"
                 f" {want} (attempt {attempt + 1})")
        traced[mode] = dict(prof, want=want)
        out[f"{mode}_profile"] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "idle_share", "kernel_launches", "host_launches",
            "port_launches")}
    if path == "e2e":
        out["vocab_sum"] = _e2e_vocab_sum(eager, captured, init, state, den, batches, args.steps)
    _log(f"captured {path} ({smi}): set-up {setup_s:.1f} s (caps {sizes['caps']}, L_cap"
         f" {sizes['L_cap']}); capture {captured.capture_s:.2f} s, graph pool"
         f" {captured.pool_bytes} B, peak {peak_gib:.2f} GiB; step 1 rel {rel[0]:.3g} (gate"
         f" {rtol1:g}), later {max(rel[1:]):.3g} (gate {rtol:g}); bits equal {bits}; each"
         f" mode's rounds the same bits {repeat}")
    for mode in runs:
        p = out[f"{mode}_profile"]
        _log(f"  {path} {mode}: steps 2..{args.steps} median ms host"
             f" {out[f'{mode}_host_ms']:.3f} {out[f'{mode}_host_ms_rounds']}, card"
             f" {out[f'{mode}_card_ms']:.3f} {out[f'{mode}_card_ms_rounds']}; traced over"
             f" {TRACED_STEPS} steps: wall {p['wall_ms']:.2f} ms, device busy"
             f" {p['device_busy_ms']:.2f} ms, idle {p['idle_share']:.3f},"
             f" {p['kernel_launches']} device launches and {p['host_launches']} host launches a"
             f" step; the port's kernels {json.dumps({k: v for k, v in p['port_launches'].items() if v})}")
    if path == "trigram":
        out["adam"] = _adam_forms(cfg, corpus.feat_dim, args.seed, opts, den, batches,
                                  args.steps, e["metrics"])
    if not (math.isfinite(rel[0]) and rel[0] <= rtol1 and max(rel[1:]) <= rtol):
        raise AssertionError(f"captured [{path}]: the captured step departs from the eager one"
                             f" (step 1 {rel[0]:.3g}, later {max(rel[1:]):.3g})")
    for mode, prof in traced.items():
        if prof["port_launches"] != prof["want"]:
            raise AssertionError(f"captured [{path}]: {mode}'s traced launches"
                                 f" {prof['port_launches']} against {prof['want']}")
    launches = traced["captured"]["port_launches"]
    _launch_gate(f"captured {path}", launches, PATHS[path]["kernels"])
    del eager, captured, state, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def check_captured(args, result: dict) -> dict:
    """The captured phase: each of the six paths's step as one CUDA graph
    against its eager step (`_captured_path`)."""
    t0 = time.perf_counter()
    out, launches = {}, {}
    for path in PATHS:
        out[path], launches[path] = _captured_path(path, args, result["nvidia_smi"])
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    _log(f"captured phase: {out['phase_s']:.1f} s")
    return out


def check_den_forms(args, result: dict) -> dict:
    """Phase 4 again, on the trigram path's corpus, model and batch: every
    denominator form other than the slot-dense one.  `auto_den_graph`
    falling through on the card: with its fit test refusing the slot-dense
    form it picks the dense Moore form, fused (K9f/K9b), or, given the
    corpus's phone LM and tree, the de Bruijn lift of ops/den_debruijn.py
    (C = 41^2); with the card's shared-memory limit taken as one byte below
    K2's carried state at this graph (K9b's is larger still) the sparse scan
    of ops/den_scan.py.  Then the explicit forms: the padded-table form of
    ops/den_table.py and the scan with alpha checkpointed every 10 frames.
    Last, the production path's model and batch on its de Bruijn lift
    (C = 41^3, the case the JAX package's accelerator takes).  Each form
    trains as many steps as the paths (`--steps`): the first loss must
    agree with its path's (the slot-dense form's) within that path's gate,
    the loss must fall, the form's kernels must have moved and no other (the
    forms without a kernel: K3-K6 alone).  Its step ms is the median of
    steps 2..N, set beside its path's median from the same run; with
    --profile two more steps are traced for device-busy ms, idle share and
    launches.  Returns each form's numbers by name."""
    import torch

    from torchain_tpu_torch import kernels
    from torchain_tpu_torch.ops import (
        DeviceDeBruijnDenGraph,
        DeviceDenGraph,
        DeviceDenseDenGraph,
        DeviceDenTableGraph,
        DeviceSupervision,
        auto_den_graph,
    )
    from torchain_tpu_torch.ops import den_resident as dr
    from torchain_tpu_torch.ops import device_graphs as dg

    out = {}
    real_fits = dg.den_form_fits
    no_resident = dict(den_form_fits=lambda form, sizes, device: form != "resident"
                       and real_fits(form, sizes, device))
    for path in ("trigram", "production"):
        corpus, cfg, dataset = build_path(path, args.seed)
        batch = next(dataset.batches(B, shuffle=False))
        feats = torch.as_tensor(batch.feats, device="cuda")
        sup = DeviceSupervision.from_host(batch.sup, device="cuda").with_kernel_tables()
        graph = corpus.den_graph
        lm_tree = dict(phone_lm=corpus.phone_lm, tree=corpus.tree)
        if path == "trigram":
            S_pad, K = dr.slot_sizes(graph)
            k2_carried = kernels.entry("den_resident", "den_shared_bytes")(
                1, S_pad, K, graph.num_pdfs, 0, 0, 0)
            _log(f"den forms [{path}]: K2's carried state {k2_carried} bytes")
            forms = {
                "dense": (DeviceDenseDenGraph, DENSE + NUM, lambda: auto_den_graph(
                    graph, device="cuda"), no_resident),
                "scan": (DeviceDenGraph, NUM, lambda: auto_den_graph(graph, device="cuda"),
                         dict(den_shared_limit=lambda device: k2_carried - 1)),
                "debruijn": (DeviceDeBruijnDenGraph, NUM, lambda: auto_den_graph(
                    graph, device="cuda", **lm_tree), no_resident),
                "table": (DeviceDenTableGraph, NUM, lambda: DeviceDenTableGraph.from_host(
                    graph, device="cuda"), {}),
                "scan_ckpt": (DeviceDenGraph, NUM, lambda: DeviceDenGraph.from_host(
                    graph, device="cuda", checkpoint_every=10), {}),
            }
        else:
            forms = {"debruijn": (DeviceDeBruijnDenGraph, NUM, lambda: auto_den_graph(
                graph, device="cuda", **lm_tree), no_resident)}
        ref = result[path]["losses"][0]["loss"]
        ref_ms = statistics.median(result[path]["step_ms_all"][1:])
        gate = REFERENCE_RTOL[PATHS[path]["dtype"]]
        for name, (cls, must, make, patch) in forms.items():
            t0 = time.perf_counter()
            with _patched(dg, **patch):
                den = make()
            build_s = time.perf_counter() - t0
            if not isinstance(den, cls):
                raise AssertionError(f"den form {name} [{path}]: {type(den).__name__},"
                                     f" not {cls.__name__}")
            sizes = {}
            if cls is DeviceDeBruijnDenGraph:
                sizes = dict(contexts=den.num_contexts, spec0=den.spec0, spec1=den.spec1)
            elif cls is DeviceDenTableGraph:
                sizes = dict(k_in=den.max_in, k_out=den.max_out)
            elif name == "scan_ckpt":
                sizes = dict(checkpoint_every=den.checkpoint_every)
            _log(f"den form {name} [{path}]: built in {build_s:.2f} s (host clock) {sizes}")
            key = name if path == "trigram" else f"{name}_{path}"
            out[key] = _den_form_run(name, cfg, corpus.feat_dim, feats, den, sup, must, ref,
                                     gate, ref_ms, path, args, args.steps)
            out[key].update(build_s=build_s, **sizes)
            del den
            torch.cuda.empty_cache()
    return out


def check_cegs(args, result: dict, tmp: str) -> dict:
    """Phase 4 again, from a finished Kaldi chain prep: the trigram path's
    corpus and dataset written as a binary OpenFst den.fst (standard arcs,
    pdf+1 labels) and a merged cegs archive of B sequences a record
    (`dataset_to_cegs`, with its .scp), then read back as a user would
    (`_load_any_fst` -> `compile_den_graph` -> `auto_den_graph`;
    `CegsDataset.peek` and the first batch of `.batches`), and the trigram
    path's model trained `--steps` steps on that record from the same seed.
    Gates: the loss is finite and falls; K1-K6 moved and no other kernel;
    the first loss within REFERENCE_RTOL["float32"] of the trigram path's
    (the same sequences and features; the supervision split back out of the
    merged FST, its states renumbered).  Then the trained model's outputs
    for that batch (train=False, one [T_out, P] matrix per sequence, keyed
    `<record key>-<n>`) through a binary ark (read back bit for bit) and
    a text ark (`%.7g`, read back within 1e-6 relative).  The host's
    write and read seconds are logged apart from the step times.  The prep
    (den.fst, cegs.1.ark and its .scp) is written to `tmp`, where the
    recipe phase reads it again.  Returns the phase's numbers; its launch
    counts are under "launches"."""
    import os

    import numpy as np
    import torch

    from torchain_tpu_torch.cli.graphs import _load_any_fst
    from torchain_tpu_torch.data import CegsDataset, dataset_to_cegs
    from torchain_tpu_torch.fstkit import write_openfst
    from torchain_tpu_torch.graphs import compile_den_graph
    from torchain_tpu_torch.io import MatrixWriter, read_ark, read_ark_text, write_ark_binary
    from torchain_tpu_torch.ops import DeviceSupervision, auto_den_graph

    t_phase = time.perf_counter()
    corpus, cfg, dataset = build_path("trigram", args.seed)
    in_process = next(dataset.batches(B, shuffle=False))
    ref = result["trigram"]["losses"][0]["loss"]
    ref_ms = statistics.median(result["trigram"]["step_ms_all"][1:])
    gate = REFERENCE_RTOL[PATHS["trigram"]["dtype"]]
    den_path, ark, scp = (os.path.join(tmp, n) for n in ("den.fst", "cegs.1.ark",
                                                           "cegs.1.scp"))
    t0 = time.perf_counter()
    write_openfst(den_path, corpus.den_fst,
                  [a.label for _s, a in corpus.den_fst.all_arcs()], arctype="standard")
    records = dataset_to_cegs(dataset, ark, batch_size=B, scp_path=scp)
    write_s = time.perf_counter() - t0
    ark_bytes, den_bytes = os.path.getsize(ark), os.path.getsize(den_path)
    with open(scp) as f:
        key = f.readline().split()[0]

    t0 = time.perf_counter()
    fst, fsttype, arctype = _load_any_fst(den_path)
    cegs = CegsDataset(ark)
    feat_dim, num_pdfs, bsz, t_out = cegs.peek()
    graph = compile_den_graph(fst, num_pdfs)
    peek_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = next(cegs.batches(bsz, shuffle=False))
    read_s = time.perf_counter() - t0
    den = auto_den_graph(graph, device="cuda")
    sup = DeviceSupervision.from_host(batch.sup, device="cuda").with_kernel_tables()
    feats = torch.as_tensor(batch.feats, device="cuda")
    torch.cuda.synchronize()
    sizes = _sizes(den, sup)
    feats_equal = bool(np.array_equal(batch.feats, in_process.feats))
    _log(f"cegs prep: den.fst {den_bytes} bytes ({fsttype}, {arctype}), {records} merged"
         f" records of {bsz} in {ark_bytes} bytes, written in {write_s:.2f} s (host);"
         f" den.fst + peek {peek_s:.2f} s, first batch read and split {read_s:.2f} s (host)")
    _log(f"cegs batch: feats {tuple(batch.feats.shape)} equal to the in-process batch's:"
         f" {feats_equal}; host tables in_src {batch.sup.in_src.shape} against the"
         f" in-process batch's {in_process.sup.in_src.shape}; " + json.dumps(sizes))
    if records < 1 or (bsz, t_out, feat_dim, num_pdfs) != (
            B, T_OUT, corpus.feat_dim, corpus.tree.num_pdfs):
        raise AssertionError(f"cegs prep: {records} records of B={bsz}, T_out={t_out},"
                             f" feat_dim {feat_dim}, {num_pdfs} pdfs")

    losses, times, launches, step, model = train_steps(cfg, feat_dim, feats, den, sup,
                                                       args.steps, args.seed)
    for i, (m, ms) in enumerate(zip(losses, times)):
        _log(f"cegs step {i}: {ms:.1f} ms  " + "  ".join(f"{k}={v:.6g}" for k, v in m.items()))
    for k, n in launches.items():
        if (k in DEN_NUM) != (n > 0):
            raise AssertionError(f"cegs path: kernel {k} counted {n}")
    first = losses[0]["loss"]
    rel = abs(first - ref) / abs(ref)
    step_ms = statistics.median(times[1:])
    _log(f"launches on the cegs path ({args.steps} steps): {launches}")
    _log(f"cegs path: first loss {first:.8g} vs the trigram path's {ref:.8g}: rel {rel:.3g}"
         f" (gate {gate:g}); steps 2..{args.steps} median {step_ms:.2f} ms/step,"
         f" {step_ms / ref_ms:.2f}x the trigram path's median {ref_ms:.2f}")
    if not all(math.isfinite(m["loss"]) for m in losses):
        raise AssertionError("non-finite loss on the cegs path")
    if not losses[-1]["loss"] < first:
        raise AssertionError("the loss did not fall on the cegs path")
    if not rel <= gate:
        raise AssertionError("the cegs path's first loss departs from the trigram path's")
    out = dict(records=records, ark_bytes=ark_bytes, den_fst_bytes=den_bytes,
               write_s=write_s, peek_s=peek_s, read_split_s=read_s, feats_equal=feats_equal,
               host_in_src=list(batch.sup.in_src.shape),
               in_process_in_src=list(in_process.sup.in_src.shape), sizes=sizes,
               first_loss=first, first_loss_rel_to_trigram=rel, step_ms=step_ms,
               step_ms_all=times, trigram_step_ms=ref_ms, losses=losses, launches=launches)

    # the trained model's outputs for the batch, as Kaldi's decoders read them
    with torch.no_grad():
        post = model(feats, train=False)[0].float().cpu().numpy()
    if post.shape != (bsz, t_out, num_pdfs) or not np.isfinite(post).all():
        raise AssertionError(f"cegs posteriors: shape {post.shape} or non-finite values")
    mats = {f"{key}-{n}": post[n] for n in range(bsz)}
    binary, text = os.path.join(tmp, "post.ark"), os.path.join(tmp, "post.txt")
    t0 = time.perf_counter()
    write_ark_binary(binary, mats)
    back = read_ark(binary)
    with MatrixWriter(text) as w:
        for k, v in mats.items():
            w[k] = v
    back_text = read_ark_text(text)
    post_s = time.perf_counter() - t0
    if list(back) != list(mats) or list(back_text) != list(mats):
        raise AssertionError("cegs posteriors: the archives' keys differ")
    bin_err = max(float(np.max(np.abs(back[k] - v))) for k, v in mats.items())
    bits = all(back[k].dtype == np.float32 and back[k].tobytes() == v.tobytes()
               for k, v in mats.items())
    text_rel = max(float(np.max(np.abs(back_text[k] - v) / np.maximum(np.abs(v), 1e-30)))
                   for k, v in mats.items())
    _log(f"cegs posteriors {post.shape}: binary ark {os.path.getsize(binary)} bytes, bit"
         f" for bit {bits} (max abs err {bin_err:g}); text ark {os.path.getsize(text)}"
         f" bytes, max rel err {text_rel:.3g} (gate 1e-6); written and read in"
         f" {post_s:.2f} s (host)")
    if not bits or not text_rel <= 1e-6:
        raise AssertionError("cegs posteriors do not round-trip through the archives")
    out.update(posteriors=list(post.shape), post_binary_max_abs_err=bin_err,
               post_binary_bit_equal=bits, post_text_max_rel_err=text_rel, post_io_s=post_s)
    from torchain_tpu_torch.data import CegsDataset

    out["fits"] = _fit_live_vs_materialized("cegs fit", lambda: CegsDataset(ark), cfg,
                                            feat_dim, den, bsz, args, result["nvidia_smi"])

    if args.profile:
        prof = profile_steps(step, feats, den, sup, 2,
                             args.out / "profile_cegs.txt" if args.out else None)
        _log(f"cegs profile (traced steps only): wall {prof['wall_ms']:.2f} ms/step, device"
             f" busy {prof['device_busy_ms']:.2f} ms/step (traced idle share"
             f" {prof['idle_share']:.3f}) in {prof['kernel_launches']} launches/step")
        for line in prof["top"]:
            _log("  " + line)
        out["profile"] = prof
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"cegs phase: {out['phase_s']:.1f} s")
    return out


def _fit_live_vs_materialized(what: str, source, cfg, feat_dim: int, den, bsz: int, args,
                              smi: str, threads: int = 0) -> dict:
    """The model of `cfg` under `Trainer.fit` for --steps steps, over the
    dataset `source()` read live (built and placed at every step on the
    prefetch thread) and through `MaterializedBatches(source(),
    device=True)` (built and placed once), in turns, once each (the run's
    time limit allows no second turn).  With
    `threads`, a third turn reads live with `TrainerConfig(
    loader_threads=threads)`: the batches built on a pool of that width.
    Records ms between steps (host clock, the Trainer's median) and the
    placement's median.  Gates: every loss finite; the pooled turns' first
    loss that of the serial live turn (the same batch, the same weights)
    within REFERENCE_RTOL."""
    from torchain_tpu_torch.data import MaterializedBatches
    from torchain_tpu_torch.train import Trainer, TrainerConfig

    turns = ("live",) + (("threaded",) if threads else ()) + ("materialized",)
    fits = {}
    for name in turns:
        dataset = source()
        if name.startswith("materialized"):
            t0 = time.perf_counter()
            dataset = MaterializedBatches(dataset, bsz, device=True)
            fits.setdefault("materialize_s", time.perf_counter() - t0)
            fits.setdefault("materialized_bytes", dataset.nbytes)
        tr = Trainer(make_model(cfg, feat_dim, "cuda", args.seed), den,
                     TrainerConfig(batch_size=bsz, num_epochs=args.steps, log_every=1,
                                   device="cuda",
                                   loader_threads=threads if name.startswith("threaded") else 0))
        tr.fit(dataset, log_fn=lambda *_: None, max_steps=args.steps)
        losses = [m["loss"] for m in tr.metrics_log]
        if len(losses) != args.steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{what} fit ({name}): losses {losses}")
        fits[name] = dict(step_ms=tr.step_ms(), sup_caps_s=tr.timings["sup_caps_s"],
                          place_ms_median=statistics.median(tr.timings["place_s"]) * 1e3,
                          losses=losses)
    line = f"{what}: Trainer.fit, ms between steps: live {fits['live']['step_ms']:.2f}"
    if threads:
        first = abs(fits["threaded"]["losses"][0] - fits["live"]["losses"][0]) / abs(
            fits["live"]["losses"][0])
        fits["threads"], fits["threaded_first_loss_rel"] = threads, first
        line += (f", live with loader_threads={threads} {fits['threaded']['step_ms']:.2f}"
                 f" (first loss rel {first:.3g} to the serial turn's)")
        if not first <= REFERENCE_RTOL["float32"]:
            raise AssertionError(f"{what} fit: the pooled loader's first loss departs from the"
                                 " serial one's")
    _log(line + f", materialized on the card {fits['materialized']['step_ms']:.2f}"
         f" (one turn each); placement median live"
         f" {fits['live']['place_ms_median']:.3f} ms, materialized"
         f" {fits['materialized']['place_ms_median']:.3f} ms; materialized"
         f" {fits['materialized_bytes'] / 1e6:.1f} MB in {fits['materialize_s']:.2f} s ({smi})")
    return fits


#: the kernels a forward-only pass launches (compute_prob): the denominator
#: forward and the numerator forward-backward of the xent target, no K2
EVAL_DEN_NUM = ("den_forward",) + NUM


def _launch_gate(what: str, launches: dict, must: tuple):
    for k, n in launches.items():
        if (k in must) != (n > 0):
            raise AssertionError(f"{what}: kernel {k} counted {n}")


def _jsonl(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_recipe(args, result: dict, tmp: str) -> dict:
    """Phase 4, last: the recipe's entry points as a user calls them, on the
    prep `check_cegs` wrote to `tmp` (den.fst and the 2-record B=128
    archive), with the trigram path's full-width TDNN-F (9 x 768/96):

      (a) `cli.train.main` for 5 epochs (10 steps) with max-change 0.75/2.0
          and an exponential LR decay to 1e-4 over --steps 10, into
          checkpoint directory A.  Gates: each record's loss in the last
          epoch below its loss in the first, all finite; K1-K6 moved and no
          other kernel; the semi-orthogonal constraint ran twice (steps 4
          and 8; `orthogonality_error` of tdnnf1.linear_pre logged before
          and after);
      (b) the same run cut after 3 epochs into directory B, then run again
          for 5 epochs on B: it must resume from the step-6 checkpoint, take
          its first step in epoch 3 (0-based) as step 7 and end at step 10.
          Gate: the last logged loss and every parameter within
          REFERENCE_RTOL["float32"] of (a)'s (each tensor's difference in
          norm over its norm); whether they are equal bit for bit is logged;
      (c) `cli.compute_prob` on A's checkpoint over the archive: K1, K3, K4,
          K5 and K6 moved, K2 and every other kernel not; then on a record
          of the first 8 sequences, once on the card and once on the CPU:
          objf, l2 and xent per frame within REFERENCE_RTOL["float32"];
      (d) `cli.export_posteriors --synthetic` at the same widths (40 phones,
          40-dim features) without a checkpoint (the seeded init), on the
          card and on the CPU: the same keys, each matrix within 1e-3 of the
          CPU's in norm.

    --steps 10 in every training run fixes the decay's horizon, so the run
    cut after 3 epochs follows (a)'s schedule.  Returns (the phase's
    numbers, the launch counts of (a) and of (c) on the card)."""
    import os

    import numpy as np
    import torch

    from torchain_tpu_torch.cli import compute_prob, export_posteriors
    from torchain_tpu_torch.cli import train as cli_train
    from torchain_tpu_torch.data import dataset_to_cegs
    from torchain_tpu_torch.io import read_ark_text
    from torchain_tpu_torch.models import orthogonality_error
    from torchain_tpu_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    smi = result["nvidia_smi"]
    gate = REFERENCE_RTOL["float32"]
    ark, den = os.path.join(tmp, "cegs.1.ark"), os.path.join(tmp, "den.fst")
    A, Bdir = os.path.join(tmp, "A"), os.path.join(tmp, "B")
    model = ["--model", "tdnnf", "--hidden-dim", "768", "--bottleneck-dim", "96",
             "--num-layers", str(LAYERS), "--seed", str(args.seed)]
    train = ["--cegs", ark, "--den-fst", den, *model, "--max-change-per-component", "0.75",
             "--max-param-change", "2.0", "--lr-final", "1e-4", "--steps", "10",
             "--log-every", "1", "--device", "cuda"]

    # the constraint's calls, counted where the Trainer makes them
    applied = []
    constrain = trainer_mod.constrain_semi_orthogonal

    def counted(m, *a, **k):
        applied.append(1)
        return constrain(m, *a, **k)

    def ckpt(d, step):
        return torch.load(os.path.join(d, str(step), "state.pt"), map_location="cpu",
                          weights_only=True)["model"]

    trainer_mod.constrain_semi_orthogonal = counted
    try:
        # (a)
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        out_a = cli_train.main([*train, "--epochs", "5", "--checkpoint-dir", A,
                                "--metrics-out", os.path.join(A, "metrics.jsonl")])
        a_s = time.perf_counter() - t0
        launches_a = {k: fn.launches for k, fn in counters().items()}
        n_applied = len(applied)
        # (b)
        t0 = time.perf_counter()
        out_b1 = cli_train.main([*train, "--epochs", "3", "--checkpoint-dir", Bdir,
                                 "--metrics-out", os.path.join(Bdir, "m1.jsonl")])
        out_b2 = cli_train.main([*train, "--epochs", "5", "--checkpoint-dir", Bdir,
                                 "--metrics-out", os.path.join(Bdir, "m2.jsonl")])
        b_s = time.perf_counter() - t0
    finally:
        trainer_mod.constrain_semi_orthogonal = constrain

    log_a = _jsonl(os.path.join(A, "metrics.jsonl"))
    losses = [m["loss"] for m in log_a]
    _log(f"recipe (a) cli.train: {out_a['steps']} steps in {a_s:.1f} s (host clock, setup"
         f" included); losses {[round(x, 6) for x in losses]}; launches {launches_a}")
    _launch_gate("recipe (a)", launches_a, DEN_NUM)
    if out_a["steps"] != 10 or len(losses) != 10 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"recipe (a): {out_a['steps']} steps, losses {losses}")
    if not (losses[8] < losses[0] and losses[9] < losses[1]):
        raise AssertionError("recipe (a): a record's loss did not fall from the first epoch"
                             " to the last")
    sd_a = ckpt(A, 10)
    init, _ = cli_train._build_model(cli_train.build_argparser().parse_args(train),
                                     int(sd_a["chain_head.Dense_1.bias"].shape[0]),
                                     int(sd_a["input_proj.kernel"].shape[1]), "cpu")
    w0 = init.tdnnf1.linear_pre.kernel.detach()
    w1 = sd_a["tdnnf1.linear_pre.kernel"]
    err0 = float(orthogonality_error(w0.reshape(-1, w0.shape[-1])))
    err1 = float(orthogonality_error(w1.reshape(-1, w1.shape[-1])))
    _log(f"recipe (a): semi-orthogonal constraint applied {n_applied} times; tdnnf1.linear_pre"
         f" orthogonality_error {err0:.6g} at init, {err1:.6g} after 10 steps")
    if n_applied != 2:
        raise AssertionError(f"recipe (a): the semi-orthogonal constraint ran {n_applied} times")

    log_b1 = _jsonl(os.path.join(Bdir, "m1.jsonl"))
    log_b2 = _jsonl(os.path.join(Bdir, "m2.jsonl"))
    read = out_b2["timings"]["ckpt_read"]
    where = [(m["step"], m["epoch"]) for m in log_b2]
    _log(f"recipe (b): cut after {out_b1['steps']} steps; resumed from the step"
         f" {read[0][0] if read else None} checkpoint, logged (step, epoch) {where}")
    if (out_b1["steps"] != 6 or not read or read[0][0] != 6 or out_b2["steps"] != 10
            or where != [(7, 3), (8, 3), (9, 4), (10, 4)]):
        raise AssertionError("recipe (b): the run did not resume at step 6 in epoch 3 and end"
                             " at step 10")
    sd_b = ckpt(Bdir, 10)
    loss_rel = abs(log_b2[-1]["loss"] - losses[-1]) / abs(losses[-1])
    param_rel = max(float(torch.linalg.vector_norm(sd_b[k].float() - v.float())
                          / max(float(torch.linalg.vector_norm(v.float())), 1e-30))
                    for k, v in sd_a.items())
    bits = all(torch.equal(sd_b[k], v) for k, v in sd_a.items()) and log_b2[-1]["loss"] == \
        losses[-1] and [m["loss"] for m in log_b1 + log_b2] == losses
    _log(f"recipe (b): last loss {log_b2[-1]['loss']:.8g} vs (a)'s {losses[-1]:.8g}: rel"
         f" {loss_rel:.3g}; parameters max rel {param_rel:.3g} (gate {gate:g}); bit-equal to"
         f" (a): {bits}; {b_s:.1f} s for both runs (host clock)")
    if not (loss_rel <= gate and param_rel <= gate):
        raise AssertionError("recipe (b): the resumed run departs from the uninterrupted one")

    # (c)
    for fn in counters().values():
        fn.launches = 0
    cp = ["--cegs", ark, "--den-fst", den, *model, "--checkpoint-dir", A]
    t0 = time.perf_counter()
    prob = compute_prob.main([*cp, "--device", "cuda"])
    cp_s = time.perf_counter() - t0
    launches_c = {k: fn.launches for k, fn in counters().items()}
    _log(f"recipe (c) compute_prob on A's checkpoint: {json.dumps(prob)} in {cp_s:.1f} s"
         f" (host clock); launches {launches_c}")
    _launch_gate("recipe (c)", launches_c, EVAL_DEN_NUM)
    if not prob["restored"] or not all(math.isfinite(prob[k]) for k in ("objf", "l2_term",
                                                                       "xent_objf")):
        raise AssertionError("recipe (c): compute_prob did not restore or is not finite")
    _, _, dataset = build_path("trigram", args.seed)
    first8 = copy.copy(dataset)
    first8.chunks = dataset.chunks[:8]
    small = os.path.join(tmp, "cegs.b8.ark")
    if dataset_to_cegs(first8, small, batch_size=8) != 1:
        raise AssertionError("recipe (c): the B=8 record was not written")
    cp8 = ["--cegs", small, "--den-fst", den, *model, "--checkpoint-dir", A]
    on_card = compute_prob.main([*cp8, "--device", "cuda"])
    on_cpu = compute_prob.main([*cp8, "--device", "cpu"])
    prob_rel = {k: abs(on_card[k] - on_cpu[k]) / max(abs(on_cpu[k]), 1e-30)
                for k in ("objf", "l2_term", "xent_objf")}
    _log(f"recipe (c) B=8: card {json.dumps(on_card)}; cpu {json.dumps(on_cpu)}; rel"
         f" {json.dumps(prob_rel)} (gate {gate:g})")
    if on_card["frames"] != on_cpu["frames"] or not all(r <= gate for r in prob_rel.values()):
        raise AssertionError("recipe (c): compute_prob on the card departs from the CPU")

    # (d)
    exp = ["--synthetic", "--num-phones", "40", "--feat-dim", "40", "--model", "tdnnf",
           "--hidden-dim", "768", "--bottleneck-dim", "96", "--num-layers", str(LAYERS),
           "--seed", str(args.seed)]
    posts = {}
    for dev in ("cuda", "cpu"):
        path = os.path.join(tmp, f"post_{dev}.ark")
        if export_posteriors.main([*exp, "--device", dev, "--out", path]) != 0:
            raise AssertionError(f"recipe (d): export_posteriors on {dev} failed")
        posts[dev] = read_ark_text(path)
    if list(posts["cuda"]) != list(posts["cpu"]) or not posts["cpu"]:
        raise AssertionError("recipe (d): the archives' keys differ")
    export_rel = max(float(np.linalg.norm(posts["cuda"][k] - v) / np.linalg.norm(v))
                     for k, v in posts["cpu"].items())
    _log(f"recipe (d) export_posteriors: {len(posts['cpu'])} matrices, card against CPU max"
         f" rel {export_rel:.3g} in norm (gate 1e-3)")
    if not export_rel <= 1e-3:
        raise AssertionError("recipe (d): the exported posteriors depart from the CPU's")

    ta = out_a["timings"]
    cegs_ms = result["cegs"]["step_ms"]
    write = ta["ckpt_write"][-1]
    read_b = read[0]
    out = dict(
        train_s=a_s, resume_runs_s=b_s, compute_prob_s=cp_s, losses=losses,
        launches=launches_a, compute_prob_launches=launches_c, semi_ortho_applied=n_applied,
        orthogonality_error=[err0, err1], resume_loss_rel=loss_rel,
        resume_param_rel=param_rel, resume_bit_equal=bits, compute_prob=prob,
        compute_prob_b8=dict(cuda=on_card, cpu=on_cpu, rel=prob_rel),
        export_rel=export_rel, cli_step_ms=ta["step_ms"], cegs_step_ms=cegs_ms,
        sup_caps_s=ta["sup_caps_s"], place_ms_median=ta["place_ms_median"],
        place_n=ta["place_n"], ckpt_bytes=write[1], ckpt_write_s=write[2],
        ckpt_read_s=read_b[2],
    )
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"recipe: cli.train steps 2..10 median {ta['step_ms']:.2f} ms between steps (host"
         f" clock) against the cegs phase's {cegs_ms:.2f} ms/step ({smi})")
    _log(f"recipe: checkpoint {write[1]} bytes, written in {write[2]:.3f} s, read in"
         f" {read_b[2]:.3f} s (host; {smi})")
    _log(f"recipe: estimate_sup_caps {ta['sup_caps_s']:.2f} s; placement on the prefetch"
         f" thread median {ta['place_ms_median']:.2f} ms over {ta['place_n']} batches (host;"
         f" {smi})")
    _log(f"recipe phase: {out['phase_s']:.1f} s ({smi})")
    return out


#: the decode phase: the kernels its training launches (the ladder's e2e
#: stage, then the standard supervision), its batch size, seconds of audio
#: per output frame (10 ms input frames, subsampled by 3), and the
#: utterances of the card-vs-CPU check (b) and of the native-vs-NumPy check
#: (c).  The word corpus's 256 utterances run 8 to 82 output frames, and
#: the loaders batch only sequences of one length: at 128 (or 64) neither
#: stage forms a minibatch; at 16 the e2e stage forms 5 an epoch and the
#: chunks of 50 frames 5
DECODE_KERNELS = DEN_NUM + E2E
DECODE_BATCH = 16
FRAME_S = 0.03
DECODE_CPU_UTTS, DECODE_NUMPY_UTTS = 8, 16


def _forward_timing(forward, xs) -> dict:
    """The decode stages' forward at B=1: per utterance, the card's ms from
    the call's start to its end (CUDA events; the card waits on the host's
    launches, as it does in the decode stage), the device-only ms of one
    median-length utterance (`_device_ms`), and the device kernels per
    forward (torch.profiler over 4 utterances; None where it records no
    device kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ms = []
    for x in xs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward(x)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    mid = sorted(xs, key=lambda x: x.shape[1])[len(xs) // 2]
    device_ms = _device_ms(lambda: forward(mid), 20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in xs[:4]:
            forward(x)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]
    launches = sum(e.count for e in kern) / 4 if kern else None
    return dict(ms_median=statistics.median(ms), ms_mean=statistics.fmean(ms),
                device_ms_median_utt=device_ms, median_utt_frames_in=int(mid.shape[1]),
                launches_per_utt=launches)


def _close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(b), 1.0)


def check_decode(args, result: dict, tmp: str) -> dict:
    """Phase 4, after the recipe: decode and score, the inference path a
    user runs on every model.

      (a) `cli.train.main --synthetic-words --flat-start-ladder --decode`
          on 256 utterances (40 phones, 40-dim features, 20 words) with
          the trigram path's full-width TDNN-F (9 x 768/96), batch 16
          (DECODE_BATCH), chunks of 50, 2 epochs a stage, the LMWT sweep
          1-12 and MBR.
          Gates: every step's loss of both training stages finite; the
          run launched K1-K6, K8f and K8b and no other kernel; its decode
          stages (the forward at B=1 and the host decoders, counted around
          `_posteriors` and `_decode_stages`) none; per, wer, best_lmwt
          and mbr_wer present and finite;
      (b) the final checkpoint's posteriors of the first 8 utterances on
          the card against the CPU: each within REFERENCE_RTOL["float32"]
          in norm; both sets decoded by the native Viterbi over the word
          HCLG, the hypotheses that differ counted (near-ties may flip:
          not gated);
      (c) on the card's posteriors of 16 utterances: `viterbi_decode` and
          `lattice_decode` native against NumPy: the same hypotheses,
          `lattice_best_path` equal to the Viterbi hypothesis, every score
          within 1e-4 relative (of at least 1);
      (d) the standalone `cli.decode` in phone mode over the recipe
          phase's exported posteriors (`post_cuda.ark`, 16 matrices) with
          the trigram corpus's phone LM, --nbest 3, --lattice-out and
          --ctm-out, once with --backend native and once with numpy: the
          same stdout; lattice arks of the same utterances, each of the
          same states and arcs, best path, and best and total score (the
          JAX package's contract between its backends; the two write
          their arcs in another order and sum in float32 and float64, so
          their bytes differ).

    Timed: the forward at B=1 (`_forward_timing`), the decoders' host ms
    per utterance (native on all 256 utterances, NumPy on the 16), the
    real-time factors (decode seconds over T_out x 30 ms of audio), and
    the HCLG build.  Returns the phase's numbers."""
    import io
    import os

    import numpy as np
    import torch

    from torchain_tpu_torch.cli import decode as cli_decode
    from torchain_tpu_torch.cli import train as cli_train
    from torchain_tpu_torch.data import synthetic_word_dataset, train_word_lm
    from torchain_tpu_torch.eval import (
        lattice_best_path,
        lattice_decode,
        make_word_decoding_graph,
        viterbi_decode,
    )
    from torchain_tpu_torch.eval.align import with_context
    from torchain_tpu_torch.eval.lattice import read_lattice_ark
    from torchain_tpu_torch.fstkit import shortest_distance
    from torchain_tpu_torch.io import write_ark_binary
    from torchain_tpu_torch.train.step import make_forward_fn

    t_phase = time.perf_counter()
    smi = result["nvidia_smi"]
    gate = REFERENCE_RTOL["float32"]
    ck = os.path.join(tmp, "decode")
    metrics = os.path.join(tmp, "decode_metrics.jsonl")
    corpus_args = ["--synthetic-words", "--num-utts", "256", "--num-phones", "40",
                   "--feat-dim", "40", "--vocab-size", "20", "--seed", str(args.seed)]
    model_args = ["--model", "tdnnf", "--hidden-dim", "768", "--bottleneck-dim", "96",
                  "--num-layers", str(LAYERS)]
    argv = [*corpus_args, *model_args, "--batch-size", str(DECODE_BATCH), "--chunk-frames", "50",
            "--flat-start-ladder", "--epochs", "2", "--decode", "--lmwt-min", "1",
            "--lmwt-max", "12", "--mbr", "--device", "cuda", "--checkpoint-dir", ck,
            "--log-every", "1", "--metrics-out", metrics]

    # (a), the decode stages' launches counted around them
    stage_launches = []
    wrapped = {name: getattr(cli_train, name) for name in ("_posteriors", "_decode_stages")}

    def counting(name, fn):
        def run(*a, **k):
            before = {n: f.launches for n, f in counters().items()}
            out = fn(*a, **k)
            stage_launches.append((name, {n: f.launches - before[n]
                                          for n, f in counters().items()}))
            return out
        return run

    for fn in counters().values():
        fn.launches = 0
    for name, fn in wrapped.items():
        setattr(cli_train, name, counting(name, fn))
    try:
        t0 = time.perf_counter()
        out = cli_train.main(argv)
        train_s = time.perf_counter() - t0
    finally:
        for name, fn in wrapped.items():
            setattr(cli_train, name, fn)
    launches = {k: fn.launches for k, fn in counters().items()}
    log = _jsonl(metrics)
    n1 = out["ladder_steps"]
    e2e_losses = [m["loss"] for m in log if m["step"] <= n1]
    std_losses = [m["loss"] for m in log if m["step"] > n1]
    dec, stages = out["decode"], out["timings"]["stages_s"]
    audio_s = dec["frames"] * FRAME_S
    _log(f"decode (a) cli.train: {train_s:.1f} s (host clock); e2e stage {n1} steps, losses"
         f" {[round(x, 6) for x in e2e_losses]}; stage 3 {out['steps'] - n1} steps, losses"
         f" {[round(x, 6) for x in std_losses]}; launches {launches}")
    _log(f"decode (a) stages (host s; {smi}): {json.dumps(stages)}; decode {json.dumps(dec)}")
    _log(f"decode (a) HCLG: {dec['hclg_states']} states, {dec['hclg_arcs']} arcs, built in"
         f" {dec['hclg_s']:.3f} s (host; {smi})")
    _log(f"decode (a) PER {out['per']:.2f}% WER {out['wer']:.2f}% best LMWT {out['best_lmwt']}"
         f" MBR WER {out['mbr_wer']:.2f}% over {dec['utts']} utterances, {audio_s:.1f} s of"
         f" audio; decode stage RTF {stages['decode_s'] / audio_s:.4f}, forward"
         f" {dec['forward_s']:.2f} s (host; {smi})")
    _log(f"decode (a) decode-stage launches: {stage_launches}")
    _launch_gate("decode (a)", launches, DECODE_KERNELS)
    if [n for n, _ in stage_launches] != ["_posteriors", "_decode_stages"] or any(
            any(d.values()) for _, d in stage_launches):
        raise AssertionError(f"decode (a): the decode stages launched kernels {stage_launches}")
    if not e2e_losses or not std_losses or not all(map(math.isfinite, e2e_losses + std_losses)):
        raise AssertionError(f"decode (a): losses e2e {e2e_losses}, stage 3 {std_losses}")
    for k in ("per", "wer", "best_lmwt", "mbr_wer"):
        if not (k in out and math.isfinite(out[k])):
            raise AssertionError(f"decode (a): {k} missing or not finite")

    # (b) the final checkpoint on the card and on the CPU
    parsed = cli_train.build_argparser().parse_args(argv)
    words = synthetic_word_dataset(num_utts=256, vocab_size=20, num_phones=40, feat_dim=40,
                                   seed=args.seed)
    utts, tree = words.corpus.utts, words.corpus.tree
    step = max(int(d) for d in os.listdir(ck) if d.isdigit())
    state = torch.load(os.path.join(ck, str(step), "state.pt"), map_location="cpu",
                       weights_only=True)["model"]
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev], cfg = cli_train._build_model(parsed, tree.num_pdfs, 40, torch.device(dev))
        models[dev].load_state_dict(state)
    left, right = cfg.context
    fsf = cfg.frame_subsampling_factor
    t0 = time.perf_counter()
    lm = train_word_lm(words.transcripts, order=2)
    wgraph = make_word_decoding_graph(lm, words.lexicon, tree)
    hclg_s = time.perf_counter() - t0
    posts, posts_s = cli_train._posteriors(models["cuda"], utts, left, right, fsf)
    # the kaldi phase decodes the first of these again, over a Kaldi HCLG.fst
    write_ark_binary(os.path.join(tmp, "post_words.ark"),
                     {u.utt_id: y for u, y in zip(utts[:KALDI_DECODE_UTTS], posts)})
    cpu_posts, _ = cli_train._posteriors(models["cpu"], utts[:DECODE_CPU_UTTS], left, right, fsf)
    post_rel = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                for a, b in zip(posts, cpu_posts)]
    hyp_card = [viterbi_decode(wgraph, y, backend="native")[0] for y in posts[:DECODE_CPU_UTTS]]
    hyp_cpu = [viterbi_decode(wgraph, y, backend="native")[0] for y in cpu_posts]
    differ = sum(a != b for a, b in zip(hyp_card, hyp_cpu))
    _log(f"decode (b) step-{step} checkpoint, {DECODE_CPU_UTTS} utterances: posteriors card vs"
         f" CPU max rel {max(post_rel):.3g} in norm (gate {gate:g}); native Viterbi hypotheses"
         f" that differ: {differ} of {DECODE_CPU_UTTS}")
    if not max(post_rel) <= gate:
        raise AssertionError("decode (b): the card's posteriors depart from the CPU's")

    # timing: the forward at B=1, the decoders on the host
    forward = make_forward_fn(models["cuda"])
    xs = [torch.as_tensor(with_context(u.feats, fsf, left, right), device="cuda") for u in utts]
    fwd = _forward_timing(forward, xs)
    n = DECODE_NUMPY_UTTS
    audio = {"all": sum(y.shape[0] for y in posts) * FRAME_S,
             "numpy": sum(y.shape[0] for y in posts[:n]) * FRAME_S}
    timed = {}

    def run(name, fn, ys):
        t0 = time.perf_counter()
        got = [fn(y) for y in ys]
        timed[name] = time.perf_counter() - t0
        return got

    vit_nat = run("viterbi_native", lambda y: viterbi_decode(wgraph, y, backend="native"), posts)
    lat_nat = run("lattice_native", lambda y: lattice_decode(wgraph, y, beam=16.0,
                                                             backend="native"), posts)
    vit_np = run("viterbi_numpy", lambda y: viterbi_decode(wgraph, y, backend="numpy"), posts[:n])
    lat_np = run("lattice_numpy", lambda y: lattice_decode(wgraph, y, beam=16.0,
                                                           backend="numpy"), posts[:n])
    per_utt = {k: v / (len(posts) if k.endswith("native") else n) * 1e3 for k, v in timed.items()}
    rtf = {k: v / (audio["all"] if k.endswith("native") else audio["numpy"])
           for k, v in timed.items()}
    lat_arcs = sum(lat.num_arcs for lat in lat_nat) / len(lat_nat)
    _log(f"decode timing ({smi}): forward at B=1 {fwd['ms_median']:.3f} ms/utt median (card"
         f" clock, host launches included), {fwd['device_ms_median_utt']:.3f} ms device-only"
         f" ({fwd['median_utt_frames_in']} input frames), {fwd['launches_per_utt']} kernel"
         f" launches/utt; all {len(posts)} posteriors in {posts_s:.2f} s (host)")
    _log(f"decode timing ({smi}): host ms/utt {json.dumps(per_utt)}; RTF {json.dumps(rtf)};"
         f" native lattices {lat_arcs:.0f} arcs/utt; HCLG built in {hclg_s:.3f} s")

    # (c) native against NumPy on the card's posteriors
    for i in range(n):
        (hn, sn), (hp, sp) = vit_nat[i], vit_np[i]
        bn, bsn = lattice_best_path(lat_nat[i])
        bp, bsp = lattice_best_path(lat_np[i])
        if not (hn == hp == bn == bp):
            raise AssertionError(f"decode (c) utterance {i}: hypotheses differ: viterbi native"
                                 f" {hn}, numpy {hp}; lattice native {bn}, numpy {bp}")
        if not (_close(sn, sp, 1e-4) and _close(bsn, bsp, 1e-4) and _close(bsn, sp, 1e-4)):
            raise AssertionError(f"decode (c) utterance {i}: scores {sn} {sp} {bsn} {bsp}")
        if lat_nat[i].num_arcs != lat_np[i].num_arcs:
            raise AssertionError(f"decode (c) utterance {i}: lattice arcs"
                                 f" {lat_nat[i].num_arcs} vs {lat_np[i].num_arcs}")
    _log(f"decode (c): {n} utterances, native and NumPy Viterbi and lattices agree"
         " (hypotheses, lattice best paths, scores within 1e-4)")

    # (d) the standalone cli.decode over the recipe's exported posteriors
    plm_path = os.path.join(tmp, "trigram_phone_lm.txt")
    with open(plm_path, "w") as f:
        f.write(_corpus(args.seed, tuple(sorted(PATHS["trigram"]["corpus"].items())))
                .phone_lm.to_text())
    runs = {}
    for backend in ("native", "numpy"):
        lat_path = os.path.join(tmp, f"lat_{backend}.txt")
        stdout, stderr = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            cli_decode.main(["--posteriors", os.path.join(tmp, "post_cuda.ark"),
                             "--num-phones", "40", "--phone-lm", plm_path, "--nbest", "3",
                             "--backend", backend, "--lattice-out", lat_path,
                             "--ctm-out", os.path.join(tmp, f"ctm_{backend}.ctm")])
        runs[backend] = dict(s=time.perf_counter() - t0, stdout=stdout.getvalue(),
                             lats=read_lattice_ark(lat_path))
    nat, num = runs["native"], runs["numpy"]
    content = {}
    for backend, r in runs.items():
        content[backend] = {}
        for utt, lat in r["lats"].items():
            words_, score = lattice_best_path(lat)
            total = shortest_distance(lat, reverse_dir=True, semiring="log")[0]
            content[backend][utt] = (lat.num_states, lat.num_arcs, words_, score, total)
    same = nat["stdout"] == num["stdout"] and content["native"].keys() == content["numpy"].keys()
    for utt, a in content["native"].items():
        b = content["numpy"].get(utt)
        same = same and b is not None and a[:3] == b[:3] and all(
            abs(x - y) <= max(1e-4, 1e-6 * abs(y)) for x, y in zip(a[3:], b[3:]))
    ctm_equal = (pathlib.Path(tmp, "ctm_native.ctm").read_bytes()
                 == pathlib.Path(tmp, "ctm_numpy.ctm").read_bytes())
    arcs = [c[1] for c in content["native"].values()]
    _log(f"decode (d) cli.decode: {len(nat['lats'])} utterances, native {nat['s']:.2f} s,"
         f" numpy {num['s']:.2f} s (host; {smi}); lattices {min(arcs)}-{max(arcs)} arcs;"
         f" stdout and lattices agree: {same}; CTM files equal: {ctm_equal}")
    if not same or not nat["lats"]:
        raise AssertionError("decode (d): the native and NumPy cli.decode runs disagree")

    res = dict(
        train_s=train_s, steps=out["steps"], ladder_steps=n1, e2e_losses=e2e_losses,
        losses=std_losses, launches=launches, stage_launches=stage_launches,
        per=out["per"], wer=out["wer"], best_lmwt=out["best_lmwt"], mbr_wer=out["mbr_wer"],
        stages_s=stages, cli_decode=dec, audio_s=audio_s,
        cli_decode_rtf=stages["decode_s"] / audio_s,
        posteriors_rel=post_rel, hyps_differ_cpu=differ, hclg_s=hclg_s, forward=fwd,
        posteriors_s=posts_s, host_s=timed, host_ms_per_utt=per_utt, rtf=rtf,
        lattice_arcs_per_utt=lat_arcs,
        standalone=dict(native_s=nat["s"], numpy_s=num["s"], utts=len(nat["lats"]),
                        ctm_equal=ctm_equal),
    )
    res["phase_s"] = time.perf_counter() - t_phase
    _log(f"decode phase: {res['phase_s']:.1f} s ({smi})")
    return res


#: the kaldi phase: the tied trees' pdf budget, the speakers of its data dir,
#: the sequences of its card-vs-CPU checks and the utterances it decodes.
#: The corpus is `cli.train --synthetic` over 40 phones (256 utterances,
#: 40-dim features, a bigram phone LM of 41 states); its chunks of 50 frames
#: form one B=128 minibatch an epoch (195 of them), so each run takes
#: `--epochs` as many as its steps
KALDI_PHONES, KALDI_UTTS, KALDI_FEAT_DIM = 40, 256, 40
KALDI_PDFS = 1000
KALDI_SPEAKERS = 4
KALDI_REF_B = 8
KALDI_DECODE_UTTS = 16


def _kaldi_dir(args, root: str, smi: str) -> dict:
    """(a) of `check_kaldi`: the corpus written as a Kaldi experiment dir
    (final.mdl, ali.1.gz of transition ids, feats.ark, utt2spk of 4
    speakers, cmvn.ark) and read back through `cli.graphs ali-to-phones`,
    `load_kaldi_dir(cmvn="speaker")` and `cli.graphs make-den-fst`."""
    import io
    import os

    import numpy as np

    from torchain_tpu_torch.cli import graphs as cli_graphs
    from torchain_tpu_torch.data import (
        apply_cmvn_by_speaker,
        compute_cmvn_stats_per_spk,
        load_kaldi_dir,
        synthetic_dataset,
        write_utt2spk,
    )
    from torchain_tpu_torch.graphs import (
        chain_transition_model,
        compile_den_graph,
        write_ali_ark,
        write_transition_model,
    )
    from torchain_tpu_torch.io import write_ark_binary
    from torchain_tpu_torch.ops import auto_den_graph

    t0 = time.perf_counter()
    corpus = synthetic_dataset(num_utts=KALDI_UTTS, num_phones=KALDI_PHONES,
                               feat_dim=KALDI_FEAT_DIM, seed=args.seed)
    tm = chain_transition_model(KALDI_PHONES)
    tids = range(1, tm.num_transition_ids + 1)
    fwd = {tm.transition_id_to_phone(t): t for t in tids if not tm.is_self_loop(t)}
    loop = {tm.transition_id_to_phone(t): t for t in tids if tm.is_self_loop(t)}
    d = os.path.join(root, "data")
    os.makedirs(d)
    mdl, ali = os.path.join(d, "final.mdl"), os.path.join(d, "ali.1.gz")
    write_transition_model(mdl, tm)
    # each segment (p, n): p's forward transition id, then n - 1 self-loop ids
    write_ali_ark(ali, {u.utt_id: [x for p, n in u.alignment
                                   for x in [fwd[p]] + [loop[p]] * (n - 1)]
                        for u in corpus.utts})
    feats = {u.utt_id: u.feats for u in corpus.utts}
    write_ark_binary(os.path.join(d, "feats.ark"), feats)
    u2s = {u.utt_id: f"spk{i % KALDI_SPEAKERS}" for i, u in enumerate(corpus.utts)}
    write_utt2spk(os.path.join(d, "utt2spk"), u2s)
    stats = compute_cmvn_stats_per_spk(feats, u2s)
    write_ark_binary(os.path.join(d, "cmvn.ark"), stats)
    times = dict(write_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = cli_graphs.main(["ali-to-phones", mdl, ali, "--out", os.path.join(d, "ali.txt"),
                              "--write-lengths"])
    times["ali_to_phones_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    utts = load_kaldi_dir(d, cmvn="speaker")
    times["load_kaldi_dir_s"] = time.perf_counter() - t0
    by_id = {u.utt_id: u for u in corpus.utts}
    want = apply_cmvn_by_speaker(feats, u2s, stats)
    bad = [u.utt_id for u in utts if u.alignment != by_id[u.utt_id].alignment]
    feat_err = max(float(np.abs(u.feats - want[u.utt_id]).max()) for u in utts)
    _log(f"kaldi (a) data dir: {len(utts)} utterances of {len(by_id)} read back by"
         f" load_kaldi_dir(cmvn='speaker') after ali-to-phones (rc {rc}); alignments that"
         f" differ {len(bad)}; features against apply_cmvn_by_speaker max abs"
         f" {feat_err:.3g} (gate 1e-6)")
    if rc != 0 or sorted(u.utt_id for u in utts) != sorted(by_id) or bad:
        raise AssertionError(f"kaldi (a): alignments read back differ: {bad[:5]}")
    if not feat_err <= 1e-6:
        raise AssertionError("kaldi (a): the speaker-normalised features differ")

    t0 = time.perf_counter()
    out = os.path.join(root, "graph")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_graphs.main(["make-den-fst", d, out, "--context-width", "2", "--lm-order", "4"])
    times["make_den_fst_s"] = time.perf_counter() - t0
    fst, fmt, _ = cli_graphs._load_any_fst(os.path.join(out, "den.fst"))
    num_pdfs = json.loads(pathlib.Path(out, "tree.json").read_text())["num_pdfs"]
    graph = compile_den_graph(fst, num_pdfs)
    den = auto_den_graph(graph, device="cuda")
    _log(f"kaldi (a) make-den-fst (rc {rc}; biphone, 4-gram): den.fst ({fmt}) read back,"
         f" {graph.num_states} states, {graph.num_arcs} arcs, {num_pdfs} pdfs, compiled to"
         f" {type(den).__name__} on the card; host s {json.dumps(times)} ({smi})")
    if rc != 0 or graph.num_states < 2:
        raise AssertionError("kaldi (a): make-den-fst failed")
    return dict(utts=len(utts), feat_err=feat_err, den_fst_states=graph.num_states,
                den_fst_arcs=graph.num_arcs, den_fst_form=type(den).__name__, host_s=times,
                mdl=mdl)


def _tied_run(args, context: str, root: str, smi: str) -> tuple[dict, dict]:
    """(b) of `check_kaldi`: `cli.train.main` on a tied tree of KALDI_PDFS
    pdfs in `context`, with the main path's TDNN-F.  Each step is timed on
    the card's clock (CUDA events around the Trainer's step), the first
    host batch and the first placed supervision kept, and 2 more steps
    traced (`profile_steps`) for the device's idle share.  Returns (the
    run's numbers, what was kept: the corpus, model, cfg, step, first host
    batch and first placed batch)."""
    import os

    import torch

    from torchain_tpu_torch.cli import train as cli_train
    from torchain_tpu_torch.train import trainer as trainer_mod

    keep = {}
    events = []
    stage, build = cli_train.tied_tree_stage, cli_train._build_model
    make_step, put = trainer_mod.make_train_step, trainer_mod.Trainer._put_batch

    def kept_stage(a, corpus):
        stage(a, corpus)
        keep["corpus"] = corpus

    def kept_model(*a, **k):
        keep["model"], keep["cfg"] = build(*a, **k)
        return keep["model"], keep["cfg"]

    def timed_step(*a, **k):
        step = keep["step"] = make_step(*a, **k)

        def run(feats, den, sup, *rest):
            keep.setdefault("placed", (feats, den, sup))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(feats, den, sup, *rest)
            end.record()
            events.append((start, end))
            return m
        return run

    def kept_batch(self, batch):
        keep.setdefault("batch", batch)
        return put(self, batch)

    metrics = os.path.join(root, f"metrics_{context}.jsonl")
    argv = ["--synthetic", "--num-utts", str(KALDI_UTTS), "--num-phones", str(KALDI_PHONES),
            "--feat-dim", str(KALDI_FEAT_DIM), "--tied-tree-pdfs", str(KALDI_PDFS),
            "--tied-tree-context", context,
            "--model", "tdnnf", "--hidden-dim", "768", "--bottleneck-dim", "96",
            "--num-layers", str(LAYERS), "--batch-size", str(B), "--chunk-frames", str(T_OUT),
            "--steps", str(args.steps), "--epochs", str(args.steps), "--log-every", "1",
            "--device", "cuda", "--seed", str(args.seed), "--metrics-out", metrics]
    if context == "triphone":
        # its 62,917-state normalization FST makes each composition costly:
        # compile them in forked workers (after CUDA's initialisation)
        argv += ["--precompile-egs", str(WAV_WORKERS)]
    for fn in counters().values():
        fn.launches = 0
    cli_train.tied_tree_stage, cli_train._build_model = kept_stage, kept_model
    trainer_mod.make_train_step, trainer_mod.Trainer._put_batch = timed_step, kept_batch
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = cli_train.main(argv)
        run_s = time.perf_counter() - t0
    finally:
        cli_train.tied_tree_stage, cli_train._build_model = stage, build
        trainer_mod.make_train_step, trainer_mod.Trainer._put_batch = make_step, put
    launches = {k: fn.launches for k, fn in counters().items()}
    torch.cuda.synchronize()
    step_ms = [s.elapsed_time(e) for s, e in events]
    losses = [m["loss"] for m in _jsonl(metrics)]
    feats, den, sup = keep["placed"]
    steady = int((sup.in_src_r >= 0).sum())
    sizes = dict(vocab_width=int(sup.frame_vocab.shape[-1]), steady_arcs_live=steady,
                 steady_slots=sup.in_src_r.numel(), arc_list=int(sup.arcs_k.shape[1]),
                 num_states=sup.max_states, num_arcs_steady=sup.in_src_r.shape[-1])
    prof = profile_steps(keep["step"], feats, den, sup, 2,
                         args.out / f"profile_kaldi_{context}.txt" if args.out else None)
    stages, tm = out["timings"]["stages_s"], out["timings"]
    res = dict(context=context, pdfs=out["den"]["pdfs"], den_form=out["den"]["form"],
               den_states=out["den"]["states"], den_arcs=out["den"]["arcs"],
               tree_s=stages["tree_s"], sup_caps_s=tm["sup_caps_s"], den_s=stages["den_s"],
               precompile_s=stages.get("precompile_s"),
               run_s=run_s, steps=out["steps"], losses=losses, launches=launches,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms[1:]),
               launches_per_step={k: n / out["steps"] for k, n in launches.items() if n},
               sup=sizes, profile={k: v for k, v in prof.items() if k != "top"})
    _log(f"kaldi (b) {context}: tied tree of {res['pdfs']} pdfs built in {res['tree_s']:.2f} s;"
         f" den graph S={res['den_states']} A={res['den_arcs']}, form {res['den_form']}"
         f" ({res['den_s']:.2f} s); supervisions composed (estimate_sup_caps)"
         f" {res['sup_caps_s']:.2f} s"
         + (f", after a precompile in {WAV_WORKERS} forked workers of"
            f" {res['precompile_s']:.2f} s" if res["precompile_s"] is not None else "")
         + f" (host clock; {smi})")
    _log(f"kaldi (b) {context}: {out['steps']} steps in {run_s:.1f} s (host clock, set-up"
         f" included); losses {[round(x, 6) for x in losses]}; launches {launches}")
    _log(f"kaldi (b) {context}: steps 2..{out['steps']} median {res['step_ms_median']:.2f} ms"
         f" (card clock), all {[round(x, 2) for x in step_ms]}; launches/step"
         f" {json.dumps(res['launches_per_step'])}; supervision {json.dumps(sizes)};"
         f" traced: wall {prof['wall_ms']:.2f} ms/step, device busy"
         f" {prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f},"
         f" {prof['kernel_launches']} device launches/step ({smi})")
    for line in prof["top"][:6]:
        _log("  " + line)
    if out["steps"] != args.steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"kaldi (b) {context}: {out['steps']} steps, losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"kaldi (b) {context}: the loss did not fall")
    if context == "left":
        _launch_gate("kaldi (b) left", launches, DEN_NUM)
    else:
        _launch_gate("kaldi (b) triphone", launches, NUM)
        if res["den_form"] != "DeviceDenGraph":
            raise AssertionError(f"kaldi (b) triphone: den form {res['den_form']}")
    return res, keep


#: steps of each den form on the triphone graph (`_kaldi_forms`)
KALDI_FORM_STEPS = 5
#: the largest [B, S, K] float32 temporary the table form may make a frame on
#: the triphone graph; past it, it runs on the batch's first sequences only
TABLE_TEMP_BYTES = 4 << 30


def _kaldi_forms(args, keep, smi: str) -> dict:
    """(e) of `check_kaldi`: the triphone run's den graph (62,917 states) and
    first batch, without a second composition, on the explicit forms
    against the scan that `auto_den_graph` takes: the scan with alpha
    checkpointed every 10 frames, and the padded-table form, whose per-op
    temporary is B * S * K * 4 bytes (K_in forward, K_out backward) against
    the scan's A * B * 4.  Where that temporary passes TABLE_TEMP_BYTES (a
    size known before any launch) the table form and a scan beside it run on
    the largest power-of-two count of the batch's first sequences within it.
    Each form KALDI_FORM_STEPS steps from the seeded weights (`_den_form_run`:
    K3-K6 alone, the first loss within REFERENCE_RTOL["float32"] of the
    scan's on the same sequences, median step, peak memory, the allocator's
    counters; traced with --profile)."""
    import numpy as np
    import torch

    from torchain_tpu_torch.ops import DeviceDenGraph, DeviceDenTableGraph, DeviceSupervision

    corpus, cfg = keep["corpus"], keep["cfg"]
    graph = corpus.den_graph
    S, A = graph.num_states, graph.num_arcs
    feats, _, sup = keep["placed"]
    Bf = feats.shape[0]
    k_in = int(np.diff(graph.in_offsets).max())
    k_out = int(np.diff(graph.out_offsets).max())
    temp = Bf * S * max(k_in, k_out) * 4
    _log(f"kaldi (e): triphone den graph S={S} A={A}, K_in {k_in}, K_out {k_out} (mean"
         f" in-degree {A / S:.2f}); the table form's temporary at B={Bf}: {temp} bytes against"
         f" the scan's A*B*4 = {A * Bf * 4} ({smi})")
    gate = REFERENCE_RTOL["float32"]
    steps = min(args.steps, KALDI_FORM_STEPS)
    out = dict(k_in=k_in, k_out=k_out, table_temp_bytes_full_batch=temp,
               scan_temp_bytes=A * Bf * 4)

    def run(name, den, feats, sup, ref, ref_ms, label):
        return _den_form_run(name, cfg, corpus.feat_dim, feats, den, sup, NUM, ref, gate,
                             ref_ms, label, args, steps)

    scan = DeviceDenGraph.from_host(graph, device="cuda")
    out["scan"] = run("scan", scan, feats, sup, None, None, "triphone")
    ref, ref_ms = out["scan"]["first_loss"], out["scan"]["step_ms"]
    ckpt = DeviceDenGraph.from_host(graph, device="cuda", checkpoint_every=10)
    out["scan_ckpt"] = run("scan_ckpt", ckpt, feats, sup, ref, ref_ms, "triphone")
    del ckpt
    table_b = Bf
    while table_b > 1 and table_b * S * max(k_in, k_out) * 4 > TABLE_TEMP_BYTES:
        table_b //= 2
    t_feats, t_sup, t_ref, t_ref_ms = feats, sup, ref, ref_ms
    if table_b < Bf:
        small = _take(keep["batch"], np.arange(table_b))
        t_feats = torch.as_tensor(small.feats, device="cuda")
        t_sup = DeviceSupervision.from_host(small.sup, device="cuda").with_kernel_tables()
        _log(f"kaldi (e): the table form at B={Bf} would make {temp} bytes a temporary, past"
             f" {TABLE_TEMP_BYTES}: it and the scan run on the first {table_b} sequences")
        out["scan_table_batch"] = run("scan", scan, t_feats, t_sup, None, None,
                                      f"triphone_b{table_b}")
        t_ref = out["scan_table_batch"]["first_loss"]
        t_ref_ms = out["scan_table_batch"]["step_ms"]
    del scan
    torch.cuda.empty_cache()
    table = DeviceDenTableGraph.from_host(graph, device="cuda")
    out["table"] = run("table", table, t_feats, t_sup, t_ref, t_ref_ms,
                       f"triphone_b{table_b}" if table_b < Bf else "triphone")
    out["table"]["batch"] = table_b
    del table
    torch.cuda.empty_cache()
    return out


def _take(batch, idx):
    """The sequences `idx` of a host ChainBatch, in that order."""
    import numpy as np

    sup = batch.sup
    cut = {f.name: getattr(sup, f.name)[idx] for f in dataclasses.fields(sup)
           if isinstance(getattr(sup, f.name), np.ndarray)}
    return dataclasses.replace(batch, feats=batch.feats[idx], sup=dataclasses.replace(sup, **cut))


def _tied_reference(args, keep, smi: str) -> dict:
    """(c) of `check_kaldi`, first half: the triphone run's first batch cut
    to KALDI_REF_B sequences on the card and on the CPU, each side's den form
    picked by `auto_den_graph` (the sparse scan on both).  Gated within
    REFERENCE_RTOL["float32"], from weights drawn from --seed + 1: the loss,
    objf and gradient norm (`reference_check`'s three), and the loss's own
    gradient with respect to both heads' outputs, computed on each side from
    the CPU's outputs (what the scan and the numerator kernels give).
    Logged: each parameter group's gradient and the whole, card against CPU,
    beside the CPU against itself with the batch's sequences reversed (the
    same sum in another order).  A ReLU trunk's parameter gradient is not
    held: where a pre-activation lies within rounding of 0, another order
    of summation moves it across the kink, and the groups below move by up
    to ~1e-3 (z2: `xent_head` 2.5e-3 card against CPU, the whole 3.1e-4).
    The run's final weights are logged too."""
    import numpy as np
    import torch

    from torchain_tpu_torch.ops import (
        ChainLossOptions,
        DeviceDenGraph,
        DeviceSupervision,
        auto_den_graph,
        chain_loss,
    )

    small = _take(keep["batch"], np.arange(KALDI_REF_B))
    graph = keep["corpus"].den_graph
    opts = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
    dens = {dev: auto_den_graph(graph, device=dev) for dev in ("cuda", "cpu")}
    for dev, den in dens.items():
        if not isinstance(den, DeviceDenGraph):
            raise AssertionError(f"kaldi (c): the {dev} took {type(den).__name__}, not the scan")

    def step(weights, dev, batch):
        model = copy.deepcopy(weights).to(dev)
        model.zero_grad(set_to_none=True)
        sup = DeviceSupervision.from_host(batch.sup, device=dev).with_kernel_tables()
        t0 = time.perf_counter()
        chain, xent = model(torch.as_tensor(batch.feats, device=dev), train=True)
        loss, aux = chain_loss(chain, xent, dens[dev], sup, opts)
        loss.backward()
        gn = torch.sqrt(sum(torch.sum(q.grad.double() ** 2) for q in model.parameters()))
        if dev == "cuda":
            torch.cuda.synchronize()
        return (dict(loss=float(loss.detach()), objf=float(aux["objf"].detach()),
                     grad_norm=float(gn), s=time.perf_counter() - t0),
                _grad_groups(model), (chain.detach().cpu(), xent.detach().cpu()))

    def groups_rel(a, b):
        rel = {n: _rel(a[n], b[n]) for n in b}
        whole = _rel(torch.cat([a[n] for n in b]), torch.cat(list(b.values())))
        return rel, whole

    gate = REFERENCE_RTOL["float32"]
    res = dict(rtol=gate)
    for name, weights in (("init", make_model(keep["cfg"], KALDI_FEAT_DIM, "cpu", args.seed + 1)),
                          ("trained", keep["model"])):
        (card, gcard, _), (cpu, gcpu, outs) = step(weights, "cuda", small), step(weights, "cpu", small)
        _, grev, _ = step(weights, "cpu", _take(small, np.arange(KALDI_REF_B)[::-1].copy()))
        r = res[name] = dict(cuda=card, cpu=cpu)
        for k in ("loss", "objf", "grad_norm"):
            r[f"{k}_rel"] = abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)
        r["groups"], r["grad_rel"] = groups_rel(gcard, gcpu)
        r["groups_cpu_reversed"], r["grad_rel_cpu_reversed"] = groups_rel(grev, gcpu)
        worst = max(r["groups"].items(), key=lambda kv: kv[1])
        worst_rev = max(r["groups_cpu_reversed"].items(), key=lambda kv: kv[1])
        # the loss's own gradient, from the CPU's outputs on both sides
        dout = {}
        for dev in ("cuda", "cpu"):
            y, x = (o.to(dev).requires_grad_() for o in outs)
            sup = DeviceSupervision.from_host(small.sup, device=dev).with_kernel_tables()
            loss, _ = chain_loss(y, x, dens[dev], sup, opts)
            loss.backward()
            dout[dev] = (y.grad.cpu(), x.grad.cpu())
        r["dy_rel"] = _rel(dout["cuda"][0].double().flatten(), dout["cpu"][0].double().flatten())
        r["dx_rel"] = _rel(dout["cuda"][1].double().flatten(), dout["cpu"][1].double().flatten())
        _log(f"kaldi (c) triphone, B={KALDI_REF_B}, scan on both, {name} weights"
             f"{'' if name == 'init' else ' (logged, not gated)'}: loss card {card['loss']:.8g}"
             f" cpu {cpu['loss']:.8g} rel {r['loss_rel']:.3g}, objf rel {r['objf_rel']:.3g},"
             f" gradient norm rel {r['grad_norm_rel']:.3g}; the loss's gradient on the heads'"
             f" outputs rel {r['dy_rel']:.3g} (chain), {r['dx_rel']:.3g} (xent) (gate {gate:g});"
             f" parameter gradient rel whole {r['grad_rel']:.3g}, worst group {worst[0]}"
             f" {worst[1]:.3g}; the CPU against itself, batch reversed: whole"
             f" {r['grad_rel_cpu_reversed']:.3g}, worst group {worst_rev[0]} {worst_rev[1]:.3g};"
             f" host s card {card['s']:.2f}, cpu {cpu['s']:.2f} ({smi})")
    r = res["init"]
    held = ("loss_rel", "objf_rel", "grad_norm_rel", "dy_rel", "dx_rel")
    if not (math.isfinite(r["cuda"]["loss"]) and all(r[k] <= gate for k in held)):
        raise AssertionError("kaldi (c): the triphone loss or its gradient on the card departs"
                             " from the CPU's")
    return res


def _lattice_reference(args, corpus, smi: str) -> dict:
    """(c) of `check_kaldi`, second half: KALDI_REF_B sausage lattices over
    the left tree (each phone of an utterance's first 50 output frames with
    one other phone beside it, 0.7/0.3), through `lattice_to_supervision_fst`
    and `compile_supervision`, the numerator on the card (K5, K3, K4, K6)
    against the CPU: log-probability and occupancies, on outputs drawn from
    --seed."""
    import numpy as np
    import torch

    from torchain_tpu_torch.graphs import (
        PhoneLattice,
        SupervisionOptions,
        compile_supervision,
        lattice_to_supervision_fst,
        pad_and_stack_supervisions,
        subsample_alignment,
    )
    from torchain_tpu_torch.ops import DeviceSupervision
    from torchain_tpu_torch.ops import num_scan as ns

    rng = np.random.default_rng(args.seed)
    tree = corpus.tree
    sups = []
    for u in corpus.utts:
        ali = subsample_alignment(u.alignment, 3)
        if sum(n for _, n in ali) < T_OUT:
            continue
        bins, durs, left = [], [], T_OUT
        for p, n in ali:
            n = min(n, left)
            bins.append([(p, 0.7), (p % tree.num_phones + 1, 0.3)])
            durs.append(n)
            left -= n
            if not left:
                break
        fst = lattice_to_supervision_fst(PhoneLattice.from_sausage(bins, durs), tree,
                                         SupervisionOptions(left_tolerance=2, right_tolerance=2))
        sups.append(compile_supervision(fst, tree.num_pdfs))
        if len(sups) == KALDI_REF_B:
            break
    host = pad_and_stack_supervisions(sups)
    y = rng.normal(size=(KALDI_REF_B, T_OUT, tree.num_pdfs)).astype(np.float32)
    got = {}
    for fn in counters().values():
        fn.launches = 0
    for dev in ("cuda", "cpu"):
        sup = DeviceSupervision.from_host(host, device=dev).with_kernel_tables()
        yy = torch.as_tensor(y, device=dev)
        lp, al = ns.num_forward(yy, sup)
        gamma = ns.num_backward(yy, sup, lp, al)
        got[dev] = (lp.double().cpu(), gamma.double().cpu())
        if dev == "cuda":
            launches = {k: fn.launches for k, fn in counters().items()}
    gate = REFERENCE_RTOL["float32"]
    lp_rel = float(((got["cuda"][0] - got["cpu"][0]).abs() / got["cpu"][0].abs()).max())
    g_rel = _rel(got["cuda"][1].flatten(), got["cpu"][1].flatten())
    _log(f"kaldi (c) lattice supervision over the left tree, B={KALDI_REF_B} sausages of"
         f" {T_OUT} frames: {host.in_src.shape} arc slots; numerator log-prob card vs CPU max"
         f" rel {lp_rel:.3g}, occupancies rel {g_rel:.3g} in norm (gate {gate:g}); launches"
         f" {launches} ({smi})")
    _launch_gate("kaldi (c) lattice", launches, NUM)
    if not (torch.isfinite(got["cuda"][0]).all() and lp_rel <= gate and g_rel <= gate):
        raise AssertionError("kaldi (c): the lattice numerator on the card departs from the CPU")
    return dict(logp_rel=lp_rel, gamma_rel=g_rel, launches=launches)


def _decode_kaldi(args, keep, a: dict, tmp: str, root: str, smi: str) -> dict:
    """(d) of `check_kaldi`: decoding with the imported model files."""
    import io
    import os

    import numpy as np

    from torchain_tpu_torch.cli import decode as cli_decode
    from torchain_tpu_torch.cli import train as cli_train
    from torchain_tpu_torch.data import synthetic_word_dataset, train_word_lm
    from torchain_tpu_torch.eval import hclg_decoding_graph, make_word_decoding_graph
    from torchain_tpu_torch.fstkit import Fst
    from torchain_tpu_torch.fstkit.openfst_io import read_openfst, write_openfst
    from torchain_tpu_torch.graphs import (
        AmNnet,
        Nnet,
        make_hclg,
        read_am_nnet,
        read_kaldi_tree,
        read_transition_model,
        write_am_nnet,
        write_kaldi_tree,
    )
    from torchain_tpu_torch.graphs import den_graph as den_graph_mod
    from torchain_tpu_torch.graphs import tied_tree as tied_tree_mod
    from torchain_tpu_torch.graphs.nnet3 import Component, Desc, Node
    from torchain_tpu_torch.io import read_ark, write_ark_binary

    n = KALDI_DECODE_UTTS
    res = {}
    # the triphone tree as a Kaldi tree file, and a phone decode over it
    corpus, cfg = keep["corpus"], keep["cfg"]
    t0 = time.perf_counter()
    text = write_kaldi_tree(corpus.tree)
    back = read_kaldi_tree(text)
    res["tree_io_s"] = time.perf_counter() - t0
    if not np.array_equal(back.pdf_map, corpus.tree.pdf_map):
        raise AssertionError("kaldi (d): the Kaldi tree file does not read back to the tree")
    paths = {k: os.path.join(root, k) for k in ("tree.txt", "post_tri.ark", "lm.txt",
                                                  "phones_ref.txt", "HCLG.fst", "lexicon.txt",
                                                  "g.txt", "words_ref.txt")}
    pathlib.Path(paths["tree.txt"]).write_text(text)
    left, right = cfg.context
    utts = corpus.utts[:n]
    posts, res["posteriors_s"] = cli_train._posteriors(keep["model"], utts, left, right,
                                                        cfg.frame_subsampling_factor)
    write_ark_binary(paths["post_tri.ark"], {u.utt_id: y for u, y in zip(utts, posts)})
    pathlib.Path(paths["lm.txt"]).write_text(corpus.phone_lm.to_text())
    pathlib.Path(paths["phones_ref.txt"]).write_text("".join(
        f"{u.utt_id} {' '.join(str(p) for p, _ in u.alignment)}\n" for u in utts))
    calls = {"read_kaldi_tree": 0, "_expand_lm_to_hmm_triphone": 0}
    wrapped = {"read_kaldi_tree": tied_tree_mod, "_expand_lm_to_hmm_triphone": den_graph_mod}

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    saved = {k: getattr(m, k) for k, m in wrapped.items()}
    for k, m in wrapped.items():
        setattr(m, k, counting(k, saved[k]))
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            phone = cli_decode.main(["--posteriors", paths["post_tri.ark"], "--tree",
                                     paths["tree.txt"], "--mode", "phone", "--phone-lm",
                                     paths["lm.txt"], "--backend", "native", "--ref",
                                     paths["phones_ref.txt"]])
        res["tree_decode_s"] = time.perf_counter() - t0
    finally:
        for k, m in wrapped.items():
            setattr(m, k, saved[k])
    _log(f"kaldi (d) cli.decode --tree (triphone, {corpus.tree.num_pdfs} pdfs) over {n}"
         f" utterances of the triphone model: PER {phone.get('wer')}%, calls {calls};"
         f" {res['tree_decode_s']:.2f} s with the graph build, tree file written and read"
         f" back in {res['tree_io_s']:.2f} s (host; {smi})")
    if phone["num_utts"] != n or not math.isfinite(phone["wer"]) or not all(calls.values()):
        raise AssertionError(f"kaldi (d): cli.decode --tree: {phone}, calls {calls}")
    res.update(per=phone["wer"], tree_calls=calls)

    # the decode phase's word HCLG as a Kaldi HCLG.fst over transition ids
    words = synthetic_word_dataset(num_utts=KALDI_UTTS, vocab_size=20, num_phones=KALDI_PHONES,
                                   feat_dim=KALDI_FEAT_DIM, seed=args.seed)
    wtree, lex = words.corpus.tree, words.lexicon
    g = train_word_lm(words.transcripts, order=2)
    tm = read_transition_model(a["mdl"])
    tid_of = {int(tm.id2pdf[t]): t for t in range(1, tm.num_transition_ids + 1)}
    if len(tid_of) != wtree.num_pdfs:
        raise AssertionError("kaldi (d): the chain model's pdfs are not the tree's")
    t0 = time.perf_counter()
    fst, olabels = make_hclg(g, lex, wtree)
    hclg = Fst()
    hclg.add_states(fst.num_states)
    for s, arc in fst.all_arcs():
        hclg.add_arc(s, tid_of[arc.label - 1] if arc.label else 0, arc.weight, arc.dst)
    for s in range(fst.num_states):
        if fst.is_final(s):
            hclg.set_final(s, fst.final(s))
    write_openfst(paths["HCLG.fst"], hclg, olabels)
    res["hclg_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_file = hclg_decoding_graph(*read_openfst(paths["HCLG.fst"]), tm)
    res["hclg_read_s"] = time.perf_counter() - t0
    built = make_word_decoding_graph(g, lex, wtree)
    same = from_file.num_states == built.num_states and all(
        np.array_equal(getattr(from_file, k), getattr(built, k))
        for k in ("src", "dst", "pdf", "olabel", "dst_offsets", "eps_src", "eps_dst"))
    fin = np.isfinite(built.final_logw)
    same = same and np.array_equal(np.isfinite(from_file.final_logw), fin)
    w_rel = max(float(np.max(np.abs(from_file.weight - built.weight)
                             / np.maximum(np.abs(built.weight), 1e-30))),
                float(np.max(np.abs(from_file.final_logw[fin] - built.final_logw[fin])
                             / np.maximum(np.abs(built.final_logw[fin]), 1e-30))))
    _log(f"kaldi (d) HCLG.fst: {fst.num_states} states, {fst.num_arcs} arcs over transition"
         f" ids, written in {res['hclg_write_s']:.2f} s, read and packed in"
         f" {res['hclg_read_s']:.2f} s (host; {smi}); same labels and topology as"
         f" make_word_decoding_graph: {same}; weights max rel {w_rel:.3g} (gate 1e-6)")
    if not same or not w_rel <= 1e-6:
        raise AssertionError("kaldi (d): the HCLG read from the file departs from the one built")
    wposts = read_ark(os.path.join(tmp, "post_words.ark"))
    pathlib.Path(paths["lexicon.txt"]).write_text("".join(
        f"{w} {' '.join(map(str, p))}\n" for w, ps in lex.prons.items() for p in ps))
    pathlib.Path(paths["g.txt"]).write_text(g.to_text())
    by_id = {u.utt_id: tr for u, tr in zip(words.corpus.utts, words.transcripts)}
    pathlib.Path(paths["words_ref.txt"]).write_text("".join(
        f"{u} {' '.join(map(str, by_id[u]))}\n" for u in wposts))
    runs = {}
    for name, extra in (("hclg", ["--hclg", paths["HCLG.fst"], "--mdl", a["mdl"]]),
                        ("word", ["--mode", "word", "--num-phones", str(KALDI_PHONES),
                                  "--lexicon",
                                  paths["lexicon.txt"], "--word-lm", paths["g.txt"],
                                  "--sil-phone", str(lex.sil_phone), "--sil-prob",
                                  str(lex.sil_prob)])):
        hyp = os.path.join(root, f"hyp_{name}.txt")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            r = cli_decode.main(["--posteriors", os.path.join(tmp, "post_words.ark"), *extra,
                                 "--backend", "native", "--ref", paths["words_ref.txt"],
                                 "--hyp-out", hyp])
        runs[name] = dict(s=time.perf_counter() - t0, wer=r.get("wer"), utts=r["num_utts"],
                          hyps=pathlib.Path(hyp).read_text().splitlines())
    differ = sum(x != y for x, y in zip(runs["hclg"]["hyps"], runs["word"]["hyps"]))
    _log(f"kaldi (d) cli.decode --hclg/--mdl: {runs['hclg']['utts']} utterances, WER"
         f" {runs['hclg']['wer']}% in {runs['hclg']['s']:.2f} s; --mode word: WER"
         f" {runs['word']['wer']}% in {runs['word']['s']:.2f} s (host; {smi}); hypotheses"
         f" that differ {differ} of {len(wposts)}")
    if len(wposts) != n or any(r["utts"] != n or len(r["hyps"]) != n for r in runs.values()):
        raise AssertionError("kaldi (d): a cli.decode run did not decode every utterance")
    res.update(hclg_same=same, hclg_weight_rel=w_rel, hyps_differ=differ,
               decode={k: {x: y for x, y in r.items() if x != "hyps"} for k, r in runs.items()})

    # an nnet3 body behind the transition model, written and read back
    rng = np.random.default_rng(args.seed)
    P, D = tm.num_pdfs, KALDI_FEAT_DIM
    comps = {"affine": Component("affine", "NaturalGradientAffineComponent", {
                 "LearningRate": 0.001,
                 "LinearParams": rng.normal(size=(P, 3 * D)).astype(np.float32),
                 "BiasParams": rng.normal(size=P).astype(np.float32)}),
             "log-softmax": Component("log-softmax", "LogSoftmaxComponent", {"Dim": P})}
    nodes = {"input": Node("input", "input", dim=D),
             "affine": Node("component", "affine", component="affine",
                            input=Desc.parse("Append(Offset(input,-1),input,Offset(input,1))")),
             "log-softmax": Node("component", "log-softmax", component="log-softmax",
                                 input=Desc.parse("affine")),
             "output": Node("output", "output", input=Desc.parse("log-softmax"))}
    am = AmNnet(nnet=Nnet(nodes=nodes, components=comps), left_context=1, right_context=1,
                priors=np.zeros(0, np.float32))
    mdl1, mdl2 = os.path.join(root, "nnet.mdl"), os.path.join(root, "nnet2.mdl")
    write_am_nnet(mdl1, tm, am)
    tm2, am2 = read_am_nnet(mdl1)
    write_am_nnet(mdl2, tm2, am2)
    x = rng.normal(size=(20, D)).astype(np.float32)
    t = np.arange(1, 19)
    fwd_equal = np.array_equal(am2.nnet.forward({"input": x}, t), am.nnet.forward({"input": x}, t))
    bytes_equal = pathlib.Path(mdl1).read_bytes() == pathlib.Path(mdl2).read_bytes()
    _log(f"kaldi (d) nnet3: final.mdl with an nnet body of {len(comps)} components, read back"
         f" and written again byte for byte: {bytes_equal}; forward equal: {fwd_equal};"
         f" transition model kept: {tm2.tuples == tm.tuples}")
    if not (bytes_equal and fwd_equal and tm2.tuples == tm.tuples):
        raise AssertionError("kaldi (d): the nnet3 model does not round-trip")
    return res


def check_kaldi(args, result: dict, tmp: str) -> dict:
    """Phase 4, after the decode phase: the Kaldi model files.

      (a) `cli.train --synthetic`'s corpus over 40 phones written as a Kaldi
          experiment dir (`_kaldi_dir`) and read back.  Gates: every
          alignment read back equals the corpus's; every feature matrix the
          corpus's after `apply_cmvn_by_speaker`, within 1e-6; the den.fst
          that make-den-fst writes reads back and compiles;
      (b) `cli.train.main` on a tied tree of 1000 pdfs in each context
          window (`_tied_run`) at the main path's widths: losses finite and
          falling; `left` launched K1-K6 and no other kernel, `triphone`
          K3-K6 and no other (its den graph, 62,917 states, takes the sparse
          scan of ops/den_scan.py);
      (c) the triphone run's first batch at B=8 on the card against the CPU,
          the scan on both sides, from weights drawn from --seed + 1: the
          loss, objf, gradient norm and the loss's gradient on the heads'
          outputs (each parameter group's gradient logged beside the CPU's
          own spread; `_tied_reference`), and a lattice supervision through
          K3-K6 (`_lattice_reference`), within REFERENCE_RTOL["float32"];
      (d) decoding with the imported model files (`_decode_kaldi`): the
          triphone tree as a Kaldi tree file through `cli.decode --tree`;
          the decode phase's word HCLG relabelled to transition ids, written
          as HCLG.fst, read back against the graph built in process, and
          through `cli.decode --hclg/--mdl` beside `--mode word`; an nnet3
          body round trip;
      (e) the triphone run's den graph and first batch on the explicit den
          forms against the scan (`_kaldi_forms`): the alpha-checkpointed
          scan and the padded-table form, each with its step ms, peak
          memory and allocator counters.

    Returns the phase's numbers; its two training runs' launch counts are
    under "launches_left" and "launches_triphone"."""
    import os

    t_phase = time.perf_counter()
    smi = result["nvidia_smi"]
    root = os.path.join(tmp, "kaldi")
    os.makedirs(root)
    out = dict(dir=_kaldi_dir(args, root, smi))
    runs = {}
    for context in ("left", "triphone"):
        out[context], runs[context] = _tied_run(args, context, root, smi)
    out["triphone_reference"] = _tied_reference(args, runs["triphone"], smi)
    out["lattice_reference"] = _lattice_reference(args, runs["left"]["corpus"], smi)
    out["decode"] = _decode_kaldi(args, runs["triphone"], out["dir"], tmp, root, smi)
    out["forms"] = _kaldi_forms(args, runs["triphone"], smi)
    out["launches_left"] = out["left"]["launches"]
    out["launches_triphone"] = out["triphone"]["launches"]
    _log(f"kaldi: triphone step {out['triphone']['step_ms_median']:.2f} ms (scan) against the"
         f" left tree's {out['left']['step_ms_median']:.2f} ms (K1/K2), card clock ({smi})")
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"kaldi phase: {out['phase_s']:.1f} s ({smi})")
    return out


#: the wav phase (`check_wav`): a raw-audio data dir of WAV_UTTS utterances of
#: 16-24 words over WAV_PHONES phones, WAV_SPEAKERS speakers, WAV_PER_REC
#: utterances a recording, at Kaldi's 16 kHz 40-bin fbank; 3-way speed
#: perturbation, online i-vectors of WAV_IVECTOR (dim, Gaussians), so the
#: model's input is 40 + 100 dims, as a chain recipe's hires features plus
#: i-vector; the supervisions compiled in WAV_WORKERS worker processes.
#: 96 utterances (the run's time limit): 7 batches of 128 chunks an epoch
WAV_UTTS, WAV_PHONES, WAV_SPEAKERS, WAV_PER_REC = 96, 40, 8, 4
WAV_WORDS, WAV_VOCAB = (16, 25), 200
WAV_IVECTOR = (100, 32)
WAV_WORKERS = 8
#: the pool width of the live loader's third pair of turns in (e)
WAV_LOADER_THREADS = 4
#: the log-mel gate: the card's and the CPU's filterbanks each within
#: `features.fbank_tolerance` (elementwise) of `features.fbank64`, a float64
#: NumPy computation of the same formula, as in tests/test_torch_features.py
#: utterances whose filterbank is held card against CPU against the yardstick
WAV_FBANK_UTTS = 16


def _wav_fbank(root: str, opts, smi: str) -> dict:
    """(a) of `check_wav`: the first WAV_FBANK_UTTS utterances' filterbank on
    the card and on the CPU, each against the float64 yardstick."""
    import os

    import numpy as np
    import torch

    from torchain_tpu_torch.data.features import fbank, fbank64, fbank_tolerance
    from torchain_tpu_torch.data.kaldi_compat import extract_utterance_waves

    waves = extract_utterance_waves(os.path.join(root, "wav.scp"),
                                    segments_path=os.path.join(root, "segments"),
                                    expected_rate=opts.sample_rate)
    audio_s = sum(w.shape[0] for w in waves.values()) / opts.sample_rate
    card_err = cpu_err = card_cpu = card_share = cpu_share = 0.0
    frames = 0
    card_s = 0.0
    for k in sorted(waves)[:WAV_FBANK_UTTS]:
        ref = fbank64(waves[k], opts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fbank(waves[k], opts, device="cuda").cpu().numpy()
        card_s += time.perf_counter() - t0
        cpu = fbank(waves[k], opts, device="cpu").numpy()
        if not card.shape == cpu.shape == ref.shape:
            raise AssertionError(f"wav (a): fbank shapes {card.shape} {cpu.shape} {ref.shape}")
        tol = fbank_tolerance(ref)
        frames += ref.shape[0]
        card_err = max(card_err, float(np.abs(card - ref).max()))
        cpu_err = max(cpu_err, float(np.abs(cpu - ref).max()))
        card_cpu = max(card_cpu, float(np.abs(card - cpu).max()))
        card_share = max(card_share, float((np.abs(card - ref) / tol).max()))
        cpu_share = max(cpu_share, float((np.abs(cpu - ref) / tol).max()))
    res = dict(utterances=len(waves), audio_s=audio_s, checked=WAV_FBANK_UTTS, frames=frames,
               card_max_abs_err=card_err, cpu_max_abs_err=cpu_err, card_vs_cpu=card_cpu,
               card_err_over_tol=card_share, cpu_err_over_tol=cpu_share, card_host_s=card_s)
    _log(f"wav (a): {len(waves)} utterances, {audio_s:.1f} s of audio; fbank of"
         f" {WAV_FBANK_UTTS} utterances ({frames} frames) from the float64 yardstick: card max"
         f" abs {card_err:.3g}, {card_share:.3g} of the elementwise gate; CPU {cpu_err:.3g},"
         f" {cpu_share:.3g} of it; card against CPU {card_cpu:.3g}; card calls"
         f" {card_s * 1e3:.1f} ms (host clock, one call an utterance, first calls included;"
         f" {smi})")
    if not (card_share <= 1 and cpu_share <= 1):
        raise AssertionError("wav (a): the filterbank departs from the float64 yardstick")
    return res


def _same_sup(a, b) -> bool:
    import numpy as np

    if (a is None) != (b is None):
        return False
    if a is None:
        return True
    arrays = ("in_src", "in_pdf", "in_logw", "final_logw", "num_states", "frame_vocab",
              "pdf_local")
    scalars = ("num_frames", "num_pdfs", "max_states", "max_arcs", "steady_need")
    return (all(np.array_equal(getattr(a, f), getattr(b, f)) for f in arrays)
            and all(getattr(a, f) == getattr(b, f) for f in scalars)
            and np.array_equal(np.asarray(a.weight), np.asarray(b.weight)))


def check_wav(args, result: dict, tmp: str) -> dict:
    """Phase 4, last: training from raw audio on the card, through the
    recipe's entry point, at the trigram path's widths (TDNN-F 9 x (768,
    96), prefinal 256, B=128, T_out=50).

      (a) `make_wav_data_dir` writes a raw-audio Kaldi data dir (WAV_UTTS
          utterances, Kaldi's 16 kHz 40-bin fbank); the first utterances'
          filterbank on the card and on the CPU, each within
          `features.fbank_tolerance` of the float64 yardstick
          `features.fbank64` (`_wav_fbank`);
      (b) `cli.train --wav-dir --cmvn speaker --speed-perturb --ivector-dim
          100 --ivector-gauss 32 --precompile-egs 8 --save-egs E
          --materialize-egs device`, --steps steps: the stages' seconds (wav
          read, speed perturbation, fbank on the card, CMVN, i-vectors,
          precompile in forked workers after CUDA's initialisation, egs save
          with its bytes, materialisation with its MB), ms between steps,
          peak device memory.  Gates: losses finite; K1-K6 launched and no
          other kernel;
      (c) the forked precompile against the serial compile: a fresh dataset
          of the same chunks compiled in this process, every supervision
          equal, array for array;
      (d) the same run with --load-egs E in place of --precompile-egs and
          --save-egs: no supervision compiled, the first loss equal to (b)'s
          bit for bit;
      (e) (d)'s dataset and a model of (b)'s config under `Trainer.fit`
          (`_fit_live_vs_materialized`): the live loader, serial and with
          WAV_LOADER_THREADS threads, against `MaterializedBatches(...,
          device=True)`, ms between steps of each;
      (f) (d)'s first batch cut to 8 sequences, on the card against the CPU
          from weights drawn from --seed + 1: loss, objf and gradient norm
          within REFERENCE_RTOL["float32"].

    Returns the phase's numbers; (b)'s launch counts are under
    "launches"."""
    import os

    import torch

    from torchain_tpu_torch import ops as ops_mod
    from torchain_tpu_torch.cli import train as cli_train
    from torchain_tpu_torch.data import ChainDataset
    from torchain_tpu_torch.data.features import FbankOptions
    from torchain_tpu_torch.data.synth_wav import make_wav_data_dir
    from torchain_tpu_torch.ops import ChainLossOptions, DeviceSupervision, chain_loss

    t_phase = time.perf_counter()
    smi = result["nvidia_smi"]
    gate = REFERENCE_RTOL["float32"]
    root, egs = os.path.join(tmp, "wav"), os.path.join(tmp, "wav_egs.npz")
    opts = FbankOptions(sample_rate=16000, num_mel_bins=40)
    t0 = time.perf_counter()
    make_wav_data_dir(root, num_utts=WAV_UTTS, vocab_size=WAV_VOCAB, num_phones=WAV_PHONES,
                      num_speakers=WAV_SPEAKERS, words_per_utt=WAV_WORDS,
                      utts_per_recording=WAV_PER_REC, opts=opts, seed=args.seed)
    out = dict(synth_s=time.perf_counter() - t0)
    out["fbank"] = _wav_fbank(root, opts, smi)

    # what the runs keep: each run's dataset, model config and den graph
    keep: dict = {}
    compiled: list = []
    egs_stage, build = cli_train.egs_stage, cli_train._build_model
    auto, sup_of = ops_mod.auto_den_graph, ChainDataset._chunk_supervision

    def kept_egs(a, dataset, stages):
        keep["dataset"] = dataset
        return egs_stage(a, dataset, stages)

    def kept_model(*a, **k):
        keep["model"], keep["cfg"] = build(*a, **k)
        return keep["model"], keep["cfg"]

    def kept_den(graph, **k):
        keep["graph"], keep["den_kw"] = graph, k
        keep["den"] = auto(graph, **k)
        return keep["den"]

    def counted(self, *a, **k):
        compiled.append(1)  # in this process only: forked workers count apart
        return sup_of(self, *a, **k)

    ivector_dim, gauss = WAV_IVECTOR
    argv = ["--wav-dir", root, "--cmvn", "speaker", "--speed-perturb",
            "--ivector-dim", str(ivector_dim), "--ivector-gauss", str(gauss),
            "--model", "tdnnf", "--hidden-dim", "768", "--bottleneck-dim", "96",
            "--num-layers", str(LAYERS), "--chunk-frames", str(T_OUT), "--batch-size", str(B),
            "--steps", str(args.steps), "--epochs", str(args.steps), "--log-every", "1",
            "--device", "cuda", "--seed", str(args.seed), "--materialize-egs", "device"]
    runs = {}

    def run(name: str, extra: list):
        metrics = os.path.join(tmp, f"wav_{name}.jsonl")
        compiled.clear()
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cli_train.egs_stage, cli_train._build_model = kept_egs, kept_model
        ops_mod.auto_den_graph, ChainDataset._chunk_supervision = kept_den, counted
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                res = cli_train.main([*argv, *extra, "--metrics-out", metrics])
            run_s = time.perf_counter() - t0
        finally:
            cli_train.egs_stage, cli_train._build_model = egs_stage, build
            ops_mod.auto_den_graph, ChainDataset._chunk_supervision = auto, sup_of
        launches = {k: fn.launches for k, fn in counters().items()}
        losses = [m["loss"] for m in _jsonl(metrics)]
        r = runs[name] = dict(run_s=run_s, steps=res["steps"], losses=losses,
                              stages_s=res["timings"]["stages_s"], egs=res.get("egs", {}),
                              step_ms=res["timings"]["step_ms"],
                              sup_caps_s=res["timings"]["sup_caps_s"],
                              place_ms_median=res["timings"]["place_ms_median"],
                              compiled_here=len(compiled), launches=launches,
                              peak_bytes=torch.cuda.max_memory_allocated(),
                              den=res["den"], dataset=keep.pop("dataset"))
        st = r["stages_s"]
        _log(f"wav ({name}) cli.train {' '.join(extra)}: {res['steps']} steps in {run_s:.1f} s"
             f" (host clock, set-up included); stages (s): "
             + ", ".join(f"{k} {v:.2f}" for k, v in st.items())
             + f"; egs {json.dumps(r['egs'])}; supervisions compiled in this process"
             f" {len(compiled)}; estimate_sup_caps {r['sup_caps_s']:.3f} s; ms between steps"
             f" {r['step_ms']:.2f}; peak device memory {r['peak_bytes'] / 2**30:.2f} GiB;"
             f" den {json.dumps(res['den'])}; losses {[round(x, 6) for x in losses]};"
             f" launches {launches} ({smi})")
        if res["steps"] != args.steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"wav ({name}): {res['steps']} steps, losses {losses}")
        return r

    # (b)
    first = run("save", ["--precompile-egs", str(WAV_WORKERS), "--save-egs", egs])
    _launch_gate("wav (b)", first["launches"], DEN_NUM)
    ds = first["dataset"]
    if first["compiled_here"] or first["egs"].get("precompiled") != len(ds.chunks):
        raise AssertionError(f"wav (b): precompiled {first['egs'].get('precompiled')} of"
                             f" {len(ds.chunks)} chunks, {first['compiled_here']} compiled here")
    out["chunks"], out["dropped"] = len(ds.chunks), ds.num_dropped
    out["feat_dim"] = int(ds.utts[0].feats.shape[1])
    out["utterances"] = len(ds.utts)
    out["frames"] = int(sum(u.feats.shape[0] for u in ds.utts))
    if out["feat_dim"] != opts.num_mel_bins + ivector_dim:
        raise AssertionError(f"wav (b): feature dim {out['feat_dim']}")

    # (c)
    serial = ChainDataset(ds.utts, ds.tree, ds.norm_fst, chunk_frames_out=ds.chunk_frames_out,
                          left_context=ds.left_context, right_context=ds.right_context,
                          sup_opts=ds.sup_opts, seed=ds.seed)
    t0 = time.perf_counter()
    differ = [i for i in range(len(ds.chunks))
              if not _same_sup(serial._sup_of(i), ds._sup_cache.get(i))]
    out["serial_compile_s"] = time.perf_counter() - t0
    out["precompile_s"] = first["stages_s"]["precompile_s"]
    _log(f"wav (c): {len(ds.chunks)} chunks ({ds.num_dropped} dropped) precompiled in"
         f" {WAV_WORKERS} forked workers after CUDA's initialisation in"
         f" {out['precompile_s']:.2f} s against {out['serial_compile_s']:.2f} s serial in this"
         f" process (host clock); supervisions that differ: {len(differ)} ({smi})")
    if differ:
        raise AssertionError(f"wav (c): forked and serial supervisions differ at {differ[:10]}")

    # (d)
    second = run("load", ["--load-egs", egs])
    if second["compiled_here"] or second["egs"].get("loaded") != first["egs"]["saved"]:
        raise AssertionError(f"wav (d): loaded {second['egs'].get('loaded')} egs, compiled"
                             f" {second['compiled_here']}")
    out["first_loss_bit_equal"] = second["losses"][0] == first["losses"][0]
    _log(f"wav (d): first loss {second['losses'][0]!r} against (b)'s {first['losses'][0]!r}:"
         f" bit for bit {out['first_loss_bit_equal']}")
    if not out["first_loss_bit_equal"]:
        raise AssertionError("wav (d): the --load-egs run's first loss differs from (b)'s")

    # (e)
    ds2, cfg, den = second["dataset"], keep["cfg"], keep["den"]
    out["fits"] = _fit_live_vs_materialized("wav (e)", lambda: ds2, cfg, out["feat_dim"], den,
                                            B, args, smi, threads=WAV_LOADER_THREADS)

    # (f)
    batch = next(ds2.batches(8, shuffle=False))
    opts_loss = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1,
                                 xent_regularize=0.1)
    weights = make_model(cfg, out["feat_dim"], "cpu", args.seed + 1)
    ref = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(weights).to(dev)
        den_dev = auto(keep["graph"], **{**keep["den_kw"], "device": dev})
        sup = DeviceSupervision.from_host(batch.sup, device=dev).with_kernel_tables()
        chain, xent = model(torch.as_tensor(batch.feats, device=dev), train=True)
        loss, aux = chain_loss(chain, xent, den_dev, sup, opts_loss)
        loss.backward()
        gn = torch.sqrt(sum(torch.sum(p.grad.double() ** 2) for p in model.parameters()))
        ref[dev] = dict(loss=float(loss.detach()), objf=float(aux["objf"].detach()),
                        grad_norm=float(gn), den=type(den_dev).__name__)
    for k in ("loss", "objf", "grad_norm"):
        ref[f"{k}_rel"] = abs(ref["cuda"][k] - ref["cpu"][k]) / max(abs(ref["cpu"][k]), 1e-12)
    out["reference"] = ref
    _log(f"wav (f): B=8 card against CPU ({ref['cuda']['den']} / {ref['cpu']['den']}): loss"
         f" {ref['cuda']['loss']:.8g} / {ref['cpu']['loss']:.8g} rel {ref['loss_rel']:.3g},"
         f" objf rel {ref['objf_rel']:.3g}, gradient norm rel {ref['grad_norm_rel']:.3g}"
         f" (gate {gate:g})")
    if not (math.isfinite(ref["cuda"]["loss"])
            and all(ref[f"{k}_rel"] <= gate for k in ("loss", "objf", "grad_norm"))):
        raise AssertionError("wav (f): the loss or its gradient on the card departs from the"
                             " CPU's")

    for r in runs.values():
        r.pop("dataset")
    out.update(runs=runs, launches=first["launches"])
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"wav phase: {out['phase_s']:.1f} s ({smi})")
    return out


#: the trunks phase (`check_trunks`): the TDNN-LSTM at Kaldi
#: run_tdnn_lstm_1a's widths (`cli.train --hidden-dim`: TDNN and cell 1024,
#: recurrent and non-recurrent projections 256), the B of its card-vs-CPU
#: checks, the optimizer steps its first-update gate takes, and that gate's
#: tolerance per optimizer (the CPU tests': tests/test_torch_lowmem_adam.py,
#: tests/test_torch_ngsgd.py)
TRUNK_LSTM_DIM = 1024
TRUNK_REF_B = 8
TRUNK_OPT_STEPS = 4
TRUNK_OPT_RTOL = {"adam-lowmem": 1e-6, "ngsgd": 1e-4}
#: first-loss gates of a lowering against the default one, by trunk dtype
LOWERING_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _trunk_cli_run(args, name: str, model_argv: list, tmp: str, smi: str,
                   ladder=None) -> dict:
    """One `cli.train --synthetic` run on the trigram path's corpus (its
    `synthetic_dataset` replaced by the chip_smoke corpus of 256 utterances
    over 40 phones, 40-dim features, the trigram phone LM; with `ladder`
    the TDNN-LSTM's layers replaced), B=128, T_out=50, --steps steps,
    supervisions compiled in 8 workers, batches materialized on the card.
    Gates: the losses finite and falling (the mean of the last two below
    the first two: the corpus is two batches an epoch); K1-K6 launched and
    no other kernel.  Returns its numbers, with the run's model config
    under "cfg"."""
    import os

    import torch

    import torchain_tpu_torch.data as data_mod
    import torchain_tpu_torch.models as models_mod
    from torchain_tpu_torch.cli import train as cli_train

    corpus = _corpus(args.seed, tuple(sorted(PATHS["trigram"]["corpus"].items())))

    def synthetic(**kw):
        if (kw["num_utts"], kw["num_phones"], kw["feat_dim"]) != (2 * B, 40, 40):
            raise AssertionError(f"trunks {name}: cli.train asked for another corpus: {kw}")
        return corpus

    metrics = os.path.join(tmp, f"trunks_{name}.jsonl")
    argv = ["--synthetic", "--num-utts", str(2 * B), "--num-phones", "40", "--feat-dim", "40",
            "--chunk-frames", str(T_OUT), "--batch-size", str(B), "--epochs", str(args.steps),
            "--steps", str(args.steps), "--precompile-egs", "8", "--materialize-egs", "device",
            "--log-every", "1", "--seed", str(args.seed), "--metrics-out", metrics,
            "--device", "cuda", *model_argv]
    ladder_cfg = {}
    if ladder is not None:
        ladder_cfg = dict(TdnnLstmConfig=functools.partial(models_mod.TdnnLstmConfig,
                                                           layers=ladder))
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _patched(data_mod, synthetic_dataset=synthetic), _patched(models_mod, **ladder_cfg):
        res = cli_train.main(argv)
        run_s = time.perf_counter() - t0
        # the run's model config, as cli.train built it
        _, cfg = cli_train._build_model(cli_train.build_argparser().parse_args(argv),
                                        corpus.tree.num_pdfs, 40, "meta")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: fn.launches for k, fn in counters().items()}
    lines = _jsonl(metrics)
    losses = [m["loss"] for m in lines]
    step_ms = res["timings"]["step_ms"]
    per_step = {k: n / max(len(losses), 1) for k, n in launches.items() if n}
    _log(f"trunks {name}: cli.train {' '.join(model_argv)}: {res['steps']} steps in"
         f" {run_s:.1f} s (host clock, set-up included); steps 2..{args.steps} median"
         f" {step_ms:.2f} ms between steps; peak device memory {peak_gib:.2f} GiB; port"
         f" kernel launches a step {per_step}; losses {[round(x, 6) for x in losses]} ({smi})")
    _launch_gate(f"trunks {name}", launches, DEN_NUM)
    if (res["steps"] != args.steps or len(losses) != args.steps
            or not all(map(math.isfinite, losses))
            or not sum(losses[-2:]) < sum(losses[:2])):
        raise AssertionError(f"trunks {name}: {res['steps']} steps, the loss did not fall:"
                             f" {losses}")
    return dict(argv=model_argv, run_s=run_s, step_ms=step_ms, peak_memory_gib=peak_gib,
                losses=losses, launches=launches, launches_per_step=per_step,
                timings=res["timings"], cfg=cfg)


@functools.lru_cache(maxsize=None)
def _trunk_dataset(seed: int, context: tuple):
    """The trigram corpus's chunks at `context`, supervisions compiled in 8
    workers (made once a context)."""
    corpus = _corpus(seed, tuple(sorted(PATHS["trigram"]["corpus"].items())))
    dataset = make_dataset(corpus, types.SimpleNamespace(context=context), e2e=False)
    dataset.precompile(num_workers=8)
    return dataset


def _trunk_batch(corpus, cfg, n: int, device, seed: int):
    """The first batch of `n` chunks of the trigram corpus at `cfg`'s
    context, its denominator and supervision on `device`: (batch, feats,
    den, sup)."""
    import torch

    batch = next(_trunk_dataset(seed, cfg.context).batches(n, shuffle=False))
    den, sup = place("trigram", corpus, batch, device)
    return batch, torch.as_tensor(batch.feats, device=device), den, sup


def _trunk_reference(name: str, cfg, corpus, seed: int, smi: str) -> dict:
    """(e): the first TRUNK_REF_B chunks at `cfg`'s context, on the card and
    on the CPU from weights drawn from `seed` + 1: the loss, objf and
    gradient norm, and the loss's own gradient with respect to both heads'
    outputs (computed on each side from the CPU's outputs), each within
    REFERENCE_RTOL["float32"] (Queue 3's rule for a ReLU trunk: its
    parameter gradients move with the order of float32 sums)."""
    import torch

    from torchain_tpu_torch.ops import ChainLossOptions, chain_loss

    opts = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1)
    weights = make_model(cfg, corpus.feat_dim, "cpu", seed + 1)
    out, heads = {}, {}
    for dev in ("cuda", "cpu"):
        _, feats, den, sup = _trunk_batch(corpus, cfg, TRUNK_REF_B, dev, seed)
        model = copy.deepcopy(weights).to(dev)
        chain, xent = model(feats, train=True)
        loss, aux = chain_loss(chain, xent, den, sup, opts)
        loss.backward()
        gn = torch.sqrt(sum(torch.sum(p.grad.double() ** 2) for p in model.parameters()))
        out[dev] = dict(loss=float(loss.detach()), objf=float(aux["objf"].detach()),
                        grad_norm=float(gn))
        heads[dev] = (den, sup)
        if dev == "cpu":
            outs = (chain.detach(), xent.detach())
    dout = {}
    for dev, (den, sup) in heads.items():
        y, x = (o.to(dev).requires_grad_() for o in outs)
        loss, _ = chain_loss(y, x, den, sup, opts)
        loss.backward()
        dout[dev] = (y.grad.cpu().double().flatten(), x.grad.cpu().double().flatten())
    gate = REFERENCE_RTOL["float32"]
    r = dict(cuda=out["cuda"], cpu=out["cpu"], rtol=gate,
             dy_rel=_rel(dout["cuda"][0], dout["cpu"][0]),
             dx_rel=_rel(dout["cuda"][1], dout["cpu"][1]))
    for k in ("loss", "objf", "grad_norm"):
        r[f"{k}_rel"] = abs(out["cuda"][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-12)
    _log(f"trunks {name} (e) B={TRUNK_REF_B} card vs CPU: loss {out['cuda']['loss']:.8g} vs"
         f" {out['cpu']['loss']:.8g} rel {r['loss_rel']:.3g}, objf rel {r['objf_rel']:.3g},"
         f" gradient norm rel {r['grad_norm_rel']:.3g}, the loss's gradient on the heads'"
         f" outputs rel {r['dy_rel']:.3g} (chain) {r['dx_rel']:.3g} (xent) (gate {gate:g};"
         f" {smi})")
    held = ("loss_rel", "objf_rel", "grad_norm_rel", "dy_rel", "dx_rel")
    if not (math.isfinite(out["cuda"]["loss"]) and all(r[k] <= gate for k in held)):
        raise AssertionError(f"trunks {name} (e): the card departs from the CPU")
    return r


def _trunk_traced(name: str, cfg, corpus, seed: int, smi: str) -> dict:
    """One train step of `cfg` at B=128 on the trigram batch at its context,
    traced with torch.profiler after two untraced ones: kernel launches a
    step (all of them, cuBLAS and elementwise included), device busy and
    wall ms, and the traced idle share."""
    _, feats, den, sup = _trunk_batch(corpus, cfg, B, "cuda", seed)
    _, _, _, step, _ = train_steps(cfg, corpus.feat_dim, feats, den, sup, 2, seed)
    prof = profile_steps(step, feats, den, sup, 1, None)
    _log(f"trunks {name} traced step (B={B}): {prof['kernel_launches']} kernel launches,"
         f" wall {prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms (traced"
         f" idle share {prof['idle_share']:.3f}), cuBLAS GEMMs {prof['library_gemm_ms']:.2f} ms,"
         f" port kernels {prof['port_kernels_ms']:.2f} ms ({smi})")
    prof.pop("top")
    return prof


def _optimizer_updates(optimizer: str, cfg, corpus, seed: int, smi: str) -> dict:
    """(c)'s gate: the trigram TDNN-F's gradient on the path's B=128 batch,
    taken on the card, copied to a CPU copy of the model; `ChainOptimizer`
    (clip 5, lr 1e-3) of `optimizer` on each side makes TRUNK_OPT_STEPS
    updates from that same gradient (the fourth crosses NG-SGD's first
    inverse refresh), each from parameters set to zero, so that they read
    the update exactly.  Each update, card against CPU, within
    TRUNK_OPT_RTOL of its largest magnitude.  Also the state's
    bytes, beside torch's Adam's moment bytes for the same parameters."""
    import torch

    from torchain_tpu_torch.ops import ChainLossOptions, chain_loss
    from torchain_tpu_torch.train import ChainOptimizer, TrainerConfig

    _, feats, den, sup = _trunk_batch(corpus, cfg, B, "cuda", seed)
    card = make_model(cfg, corpus.feat_dim, "cuda", seed)
    chain, xent = card(feats, train=True)
    loss, _ = chain_loss(chain, xent, den, sup, ChainLossOptions(
        l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1))
    loss.backward()
    cpu = copy.deepcopy(card).to("cpu")
    grads = {"cuda": [p.grad.detach().clone() for p in card.parameters()]}
    grads["cpu"] = [g.cpu() for g in grads["cuda"]]
    for p, g in zip(cpu.parameters(), grads["cpu"]):
        p.grad = g.clone()
    opts = {dev: ChainOptimizer(m.parameters(), TrainerConfig(optimizer=optimizer, lr=1e-3,
                                                                device=dev))
            for dev, m in (("cuda", card), ("cpu", cpu))}
    worst = []
    for _ in range(TRUNK_OPT_STEPS):
        deltas = {}
        for dev, m in (("cuda", card), ("cpu", cpu)):
            # neither optimizer reads the parameters' values: from zero, a
            # parameter after the step is the update itself, not rounded
            # into the parameter's own magnitude
            for p, g in zip(m.parameters(), grads[dev]):
                p.detach().zero_()
                p.grad.copy_(g)
            opts[dev].step()
            deltas[dev] = [p.detach().cpu().clone() for p in m.parameters()]
        worst.append(max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                         for a, b in zip(deltas["cuda"], deltas["cpu"]) if b.abs().max() > 0))
    state_bytes = opts["cuda"].inner.state_bytes()
    adam = torch.optim.Adam(card.parameters())
    adam.step()
    adam_bytes = sum(st[k].numel() * st[k].element_size() for st in adam.state.values()
                     for k in ("exp_avg", "exp_avg_sq"))
    gate = TRUNK_OPT_RTOL[optimizer]
    _log(f"trunks {optimizer} (c) updates on the same gradient, card vs CPU, largest"
         f" difference relative to the update's largest magnitude, steps 1..{TRUNK_OPT_STEPS}:"
         f" {[f'{w:.3g}' for w in worst]} (gate {gate:g}); optimizer state {state_bytes} bytes"
         f" on the card, torch Adam's moments {adam_bytes} bytes"
         f" ({state_bytes / adam_bytes:.3f}x; {smi})")
    if not max(worst) <= gate:
        raise AssertionError(f"trunks {optimizer} (c): the card's update departs from the CPU's")
    return dict(update_rel=worst, state_bytes=state_bytes, adam_moment_bytes=adam_bytes)


def _lowering_run(name: str, path: str, lowering: dict, args, result: dict, smi: str) -> dict:
    """(d): the model of `path` (its corpus, weights and replayed B=128 batch)
    under `lowering`, --steps steps through `make_train_step`: the loss
    falls; K1-K6 launched and no other kernel (so no attention kernel under
    "einsum"); the first loss within LOWERING_RTOL of the default lowering's
    (the path's own run); median ms a step over steps 2..N, peak memory."""
    import torch

    corpus, cfg, dataset = build_path(path, args.seed)
    cfg = dataclasses.replace(cfg, **lowering)
    batch = next(dataset.batches(B, shuffle=False))
    den, sup = place(path, corpus, batch, "cuda")
    feats = torch.as_tensor(batch.feats, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches, _, _ = train_steps(cfg, corpus.feat_dim, feats, den, sup,
                                                args.steps, args.seed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    first, ref = losses[0]["loss"], result[path]["losses"][0]["loss"]
    rel = abs(first - ref) / abs(ref)
    gate = LOWERING_RTOL[PATHS[path]["dtype"]]
    step_ms = statistics.median(times[1:])
    per_step = {k: n / args.steps for k, n in launches.items() if n}
    _log(f"trunks {name} (d) {path} under {lowering}: first loss {first:.8g} vs the default"
         f" lowering's {ref:.8g}: rel {rel:.3g} (gate {gate:g}); steps 2..{args.steps} median"
         f" {step_ms:.2f} ms/step against the default's {result[path]['step_ms']:.2f}; peak"
         f" device memory {peak_gib:.2f} GiB; port kernel launches a step {per_step}; last"
         f" loss {losses[-1]['loss']:.6g} ({smi})")
    _launch_gate(f"trunks {name}", launches, DEN_NUM)
    if not (math.isfinite(first) and rel <= gate and losses[-1]["loss"] < first):
        raise AssertionError(f"trunks {name}: the first loss departs from the default"
                             " lowering's, or the loss did not fall")
    return dict(lowering=lowering, first_loss=first, first_loss_rel=rel, step_ms=step_ms,
                step_ms_all=times, peak_memory_gib=peak_gib, launches=launches,
                losses=[m["loss"] for m in losses])


def check_trunks(args, result: dict, tmp: str) -> dict:
    """Phase 4, last: every trunk, lowering and optimizer of the JAX package
    on the card, on the trigram path's corpus and resident den graph (B=128,
    T_out=50, --steps steps each):

      (a) `cli.train --model tdnn-lstm --hidden-dim 1024` (run_tdnn_lstm_1a's
          widths: TDNN and cell 1024, projections 256; the default ladder of
          3 LSTMP layers, warm-up 6, context (60, 42)), and the same with
          each ("lstm", 1) of the ladder an ("gru", 1) (OPGRU);
      (b) `cli.train --model cnn-tdnn --hidden-dim 768 --bottleneck-dim 96
          --num-layers 9 --feat-dim 40` (CnnTdnnConfig's defaults, Kaldi
          cnn_tdnn_1a: 48-48-64-64-64-128 filters, 3x3);
      (c) `cli.train` with the trigram TDNN-F (9 x 768/96) and
          `--optimizer adam-lowmem`, then `ngsgd`; each optimizer's updates
          on the card against the CPU's from the same gradient
          (`_optimizer_updates`), and its state's bytes;
      (d) the trigram path's TDNN-F under impl="conv", time_major=False and
          bn_impl="flax", and the conformer path's model under
          attn_impl="einsum", ln_impl="flax", bn_impl="flax",
          depthwise_impl="conv" (`_lowering_run`), each from its path's
          weights and batch;
      (e) B=8 card-vs-CPU gates for (a)'s two ladders and (b)
          (`_trunk_reference`).

    Every run: the loss falls, K1-K6 launched and no other kernel.  (a) and
    (b) also trace one B=128 step for its kernel launches (`_trunk_traced`).
    Returns the phase's numbers; each run's launch counts are under
    "launches"."""
    from torchain_tpu_torch.models.lstm import TDNN_LSTM_LAYERS

    t_phase = time.perf_counter()
    smi = result["nvidia_smi"]
    corpus = _corpus(args.seed, tuple(sorted(PATHS["trigram"]["corpus"].items())))
    gru = tuple(("gru", s[1]) if s[0] == "lstm" else s for s in TDNN_LSTM_LAYERS)
    tdnnf = ["--model", "tdnnf", "--hidden-dim", "768", "--bottleneck-dim", "96",
             "--num-layers", str(LAYERS)]
    runs = {}
    for name, argv, ladder in (
            ("tdnn_lstm", ["--model", "tdnn-lstm", "--hidden-dim", str(TRUNK_LSTM_DIM)], None),
            ("tdnn_opgru", ["--model", "tdnn-lstm", "--hidden-dim", str(TRUNK_LSTM_DIM)], gru),
            ("cnn_tdnn", ["--model", "cnn-tdnn", "--hidden-dim", "768", "--bottleneck-dim",
                          "96", "--num-layers", "9"], None),
            ("adam_lowmem", [*tdnnf, "--optimizer", "adam-lowmem"], None),
            ("ngsgd", [*tdnnf, "--optimizer", "ngsgd"], None)):
        runs[name] = _trunk_cli_run(args, name, argv, tmp, smi, ladder)
    for name, r in runs.items():
        cfg = r.pop("cfg")
        r["config"] = {k: str(v) for k, v in dataclasses.asdict(cfg).items()}
        if name in ("tdnn_lstm", "tdnn_opgru", "cnn_tdnn"):
            r["traced"] = _trunk_traced(name, cfg, corpus, args.seed, smi)
            r["reference"] = _trunk_reference(name, cfg, corpus, args.seed, smi)
    _, tdnnf_cfg, _ = build_path("trigram", args.seed)
    for name in ("adam_lowmem", "ngsgd"):
        runs[name]["updates"] = _optimizer_updates(name.replace("_", "-"), tdnnf_cfg, corpus,
                                                   args.seed, smi)
    for name, path, lowering in (
            ("tdnnf_conv", "trigram", dict(impl="conv")),
            ("tdnnf_batch_major", "trigram", dict(time_major=False)),
            ("tdnnf_flax_bn", "trigram", dict(bn_impl="flax")),
            ("conformer_lowerings", "conformer", dict(attn_impl="einsum", ln_impl="flax",
                                                      bn_impl="flax", depthwise_impl="conv"))):
        runs[name] = _lowering_run(name, path, lowering, args, result, smi)
    out = dict(runs=runs, launches={k: r["launches"] for k, r in runs.items()})
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"trunks phase: {out['phase_s']:.1f} s ({smi})")
    return out


#: the parallel phase (`check_parallel`): the global batch of its TDNN-F runs
#: (each of two ranks holds half), the conformer's, and the gates against the
#: one-rank run of the same global batches.  The first step starts both runs
#: from the same weights: its loss, objf and gradient norm are held at the JAX
#: package's sharded-vs-unsharded gates (tests/test_sharding.py, one step), and
#: the gradients of the heads' output layers (HEAD_OUTPUTS: the affine maps
#: after the last ReLU) within PARALLEL_HEADS_REL of their largest magnitude.
#: A layer before a ReLU takes its derivative's jumps where float32 sum order
#: moves a pre-activation across 0: every other group, the heads' first
#: layers too, moves by 2e-3-7e-3 (probes on an H100; 2.5e-3 card against CPU
#: in ROADMAP.md Queue 3), so those are logged.  Later steps part: Adam's
#: g / (|g| + eps) turns sum-order noise in a near-zero gradient element into a
#: step of +-lr (probes on an H100: from step 2 the TDNN-F's loss rel 2.2e-5,
#: by step 10 the heads' parameters 7.4e-3 of their largest magnitude; under
#: SGD 7e-5 and 5.9e-5), so they are held to PARALLEL_DRIFT_RTOL.  A world of one through
#: `cli.train --distributed` is the plain run to PARALLEL_WORLD1_RTOL.  The
#: sub-command CLI_RUNNER makes this script the program that
#: `torch.distributed.run` starts for (a)
PARALLEL_B = 128
PARALLEL_CONFORMER_B = 8
PARALLEL_CONFORMER_STEPS = 3
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_GRAD_RTOL = 1e-4
PARALLEL_HEADS_REL = 1e-4
HEAD_OUTPUTS = ("chain_head.Dense_1", "xent_head.Dense_1")
PARALLEL_DRIFT_RTOL = 5e-2
PARALLEL_WORLD1_RTOL = 1e-6
PARALLEL_TIMEOUT_S = 300
CLI_RUNNER = "_trigram_cli_train"
#: (d), the model axis: data 1 x model 2 on two gloo ranks sharing the card,
#: the bf16 conformer at global B=8 for MODEL_STEPS steps with each
#: feed-forward lowering, float32 copies of both for one step, and (d2) a
#: float32 step at MODEL_MIN_SHARD, where the rule also shards qkv
#: [256, 768], conv_in [256, 512], attn_out and conv_out [256, 256] and the
#: heads' first layers, which are gathered on use
MODEL_AXIS = 2
MODEL_STEPS = 3
MODEL_MIN_SHARD = 2**16
MODEL_GATHERED = ("attn_qkv", "conv_in", "attn_out", "conv_out")


def _trigram_cli(argv: list) -> int:
    """CLI_RUNNER: `cli.train.main(argv)` with the trigram corpus in place of
    `synthetic_dataset` (as `_trunk_cli_run` does in this process), the
    kernel counters zeroed first; prints `CLI_RESULT {json}` (steps, ms
    between steps, launches) on rank 0."""
    import torch.distributed as dist

    import torchain_tpu_torch.data as data_mod
    from torchain_tpu_torch.cli import train as cli_train

    seed = int(argv[argv.index("--seed") + 1])
    corpus = _corpus(seed, tuple(sorted(PATHS["trigram"]["corpus"].items())))
    for fn in counters().values():
        fn.launches = 0
    with _patched(data_mod, synthetic_dataset=lambda **kw: corpus):
        res = cli_train.main(argv)
    launches = {k: fn.launches for k, fn in counters().items()}
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == 0:
        print("CLI_RESULT " + json.dumps(dict(steps=res["steps"], step_ms=res["timings"]["step_ms"],
                                              launches=launches)), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _parallel_world1(args, tmp: str, smi: str) -> dict:
    """(a) `python -m torch.distributed.run --nproc-per-node 1` of this
    script's CLI_RUNNER with `cli.train --distributed --data-parallel -1`
    (NCCL, a world of one) against the plain `cli.train` run of the same
    seed in this process: the losses to PARALLEL_WORLD1_RTOL, K1-K6 only."""
    import os

    tdnnf = ["--model", "tdnnf", "--hidden-dim", "768", "--bottleneck-dim", "96",
             "--num-layers", str(LAYERS)]
    plain = _trunk_cli_run(args, "parallel_plain", tdnnf, tmp, smi)
    plain.pop("cfg")
    metrics = os.path.join(tmp, "parallel_world1.jsonl")
    argv = ["--synthetic", "--num-utts", str(2 * B), "--num-phones", "40", "--feat-dim", "40",
            "--chunk-frames", str(T_OUT), "--batch-size", str(B), "--epochs", str(args.steps),
            "--steps", str(args.steps), "--precompile-egs", "8", "--materialize-egs", "device",
            "--log-every", "1", "--seed", str(args.seed), "--metrics-out", metrics,
            "--device", "cuda", *tdnnf, "--distributed", "--data-parallel", "-1"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", str(pathlib.Path(__file__).resolve()), CLI_RUNNER, *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(pathlib.Path(__file__).resolve().parent))
    try:
        out, _ = proc.communicate(timeout=PARALLEL_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    run_s = time.perf_counter() - t0
    line = [ln for ln in out.splitlines() if ln.startswith("CLI_RESULT ")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"parallel (a): torch.distributed.run exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    res = json.loads(line[-1][len("CLI_RESULT "):])
    losses = [m["loss"] for m in _jsonl(metrics)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    _log(f"parallel (a): cli.train --distributed under torch.distributed.run, NCCL, world 1:"
         f" {res['steps']} steps in {run_s:.1f} s (process included); {res['step_ms']:.2f} ms"
         f" between steps against the plain run's {plain['step_ms']:.2f} ms; losses against the"
         f" plain run: max rel {rel:.3g} (gate {PARALLEL_WORLD1_RTOL:g}) ({smi})")
    _launch_gate("parallel (a)", res["launches"], DEN_NUM)
    if len(losses) != len(plain["losses"]) or not rel <= PARALLEL_WORLD1_RTOL:
        raise AssertionError(f"parallel (a): the world-1 run departs from the plain run:"
                             f" {losses} vs {plain['losses']}")
    return dict(run_s=run_s, step_ms=res["step_ms"], plain_step_ms=plain["step_ms"],
                losses=losses, plain_losses=plain["losses"], max_rel=rel,
                launches=res["launches"], plain_launches=plain["launches"])


def _parallel_config(args, model: str, batch: int, steps: int, tmp: str) -> dict:
    """The worker's config for a full-width run on the trigram corpus (the
    trigram path's data: T_out=50, tolerances 2) of `steps` steps."""
    corpus = dict(num_utts=2 * B, num_phones=40, feat_dim=40, utt_frames_out=(T_OUT, T_OUT + 10),
                  seed=args.seed, **PATHS["trigram"]["corpus"])
    if model == "conformer":
        model_cfg = dict(CONFORMER, dtype="bfloat16")
    else:
        model_cfg = dict(hidden_dim=768, bottleneck_dim=96, prefinal_dim=256, num_layers=LAYERS)
    return dict(corpus=corpus, chunk_frames=T_OUT,
                sup_opts=dict(left_tolerance=2, right_tolerance=2), data_seed=0,
                model=model, model_cfg=model_cfg, model_seed=args.seed, batch_size=batch,
                epochs=steps, steps=steps, trainer=dict(lr=1e-3, log_every=1),
                loss=dict(l2_regularize=5e-4, leaky_hmm_coefficient=0.1, xent_regularize=0.1),
                precompile=4, counters={k: f"{m}:{f}" for k, (m, f, *_) in KERNELS.items()},
                save_params=str(pathlib.Path(tmp) / f"parallel_{model}_params.pt"))


def _groups_rel(got: dict, want: dict, depth: int = 1) -> dict:
    """Each parameter group's (the first `depth` components of a name)
    largest distance between two state dicts, over its largest magnitude in
    `want`."""
    import torch

    acc = {}
    for name, v in want.items():
        if not torch.is_floating_point(v):
            continue
        d = float((got[name].double() - v.double()).abs().max())
        m = float(v.double().abs().max())
        g = acc.setdefault(".".join(name.split(".")[:depth]), [0.0, 0.0])
        g[0], g[1] = max(g[0], d), max(g[1], m)
    return {g: d / max(m, 1e-30) for g, (d, m) in acc.items()}


def _parallel_pair(args, label: str, model: str, batch: int, steps: int, must: tuple,
                   first: tuple, drift: float | None, tmp: str, smi: str) -> dict:
    """Two ranks on the one card over gloo (the worker's trainer mode, each
    rank `batch` / 2 rows) against a one-rank run of the same global batches
    in this process.  Gates: the two ranks' curves equal; the first step
    (both runs from the same weights) to `first` = (loss and objf rel,
    gradient norm rel, the gradients of the heads' output layers
    (HEAD_OUTPUTS) within this of their largest magnitude, or None: logged); every later step's loss, objf and gradient norm and the
    heads' parameters after the run to `drift` where given (logged
    otherwise: Adam's g / (|g| + eps) turns float32 sum-order noise in a
    near-zero gradient element into a step of +-lr, so the trajectories
    part); each rank's launches those of the one-rank run, `must` and no
    other kernel.  Other parameter groups' distances are logged."""
    import torch

    from torchain_tpu_torch.tools import multihost_worker as mw

    work = str(pathlib.Path(tmp) / f"parallel_{model}")
    cfg2 = _parallel_config(args, model, batch, steps, work)
    t0 = time.perf_counter()
    two = mw.spawn(2, "trainer", cfg2, work, device="cuda:0", backend="gloo",
                   timeout=PARALLEL_TIMEOUT_S)
    two_s = time.perf_counter() - t0
    two_saved = torch.load(cfg2["save_params"], weights_only=True)
    cfg1 = dict(cfg2, save_params=cfg2["save_params"] + ".one")
    for fn in counters().values():
        fn.launches = 0
    one = mw.run("trainer", 0, 1, "cuda", cfg1, work)
    one_saved = torch.load(cfg1["save_params"], weights_only=True)
    if not (len(one["curve"]) == len(two[0]["curve"]) == len(two[1]["curve"]) == steps):
        raise AssertionError(f"parallel {label}: step counts {one['steps']} {two[0]['steps']}"
                             f" {two[1]['steps']}")
    keys = ("loss", "objf", "grad_norm")
    ranks_equal = all(two[0]["curve"][i][k] == two[1]["curve"][i][k]
                      for i in range(steps) for k in keys)
    by_step = [{k: abs(two[0]["curve"][i][k] - b[k]) / abs(b[k]) for k in keys}
               for i, b in enumerate(one["curve"])]
    later = {k: max((r[k] for r in by_step[1:]), default=0.0) for k in keys}
    grads = _groups_rel(two_saved["first_grads"], one_saved["first_grads"])
    params = _groups_rel(two_saved["params"], one_saved["params"])
    outputs = _groups_rel(two_saved["first_grads"], one_saved["first_grads"], depth=2)
    heads_grad = max(outputs[g] for g in HEAD_OUTPUTS)
    heads = max(params[g] for g in ("chain_head", "xent_head"))
    stats = two[0]["collectives_per_step"]
    grad_bytes = 4 * two[0]["parameters"]
    per_rank = [{k: n / steps for k, n in r["launches"].items() if n} for r in two]
    s1 = by_step[0]
    _log(f"parallel {label}: 2 ranks x {batch // 2} rows on one card (gloo) against 1 rank x"
         f" {batch}, {steps} steps; the ranks' curves equal: {ranks_equal}; step 1 (the same"
         f" weights) rel loss {s1['loss']:.3g} objf {s1['objf']:.3g} (gate {first[0]:g}) grad norm"
         f" {s1['grad_norm']:.3g} (gate {first[1]:g}), the heads' output layers' gradients"
         f" {heads_grad:.3g} of their largest magnitude (gate {first[2]}); steps 2..{steps} max rel loss"
         f" {later['loss']:.3g} objf {later['objf']:.3g} grad norm {later['grad_norm']:.3g}, the"
         f" heads' parameters after the run {heads:.3g} (gate {drift}); by step"
         f" {[tuple(float(f'{v:.3g}') for v in r.values()) for r in by_step]}; first-step"
         f" gradients by group {{{', '.join(f'{g}: {v:.2g}' for g, v in sorted(grads.items()))}}};"
         f" parameters after the run {{{', '.join(f'{g}: {v:.2g}' for g, v in sorted(params.items()))}}}"
         f"; {two[0]['step_ms']:.2f} / {two[1]['step_ms']:.2f} ms between steps on ranks 0/1"
         f" against {one['step_ms']:.2f} ms on one rank; all-reduces a step"
         f" {stats['data']['all_reduce']:g}, their bytes {stats['data']['all_reduce_bytes']:.0f}"
         f" (of which the"
         f" gradient's {grad_bytes}: {two[0]['parameters']} float32 parameters); kernel"
         f" launches a step on each rank {per_rank}; spawn to results {two_s:.1f} s ({smi})")
    for i, r in enumerate(two):
        _launch_gate(f"parallel {label} rank {i}", r["launches"], must)
        if r["launches"] != one["launches"]:
            raise AssertionError(f"parallel {label} rank {i}: launches {r['launches']} against"
                                 f" one rank's {one['launches']}")
    ok = (ranks_equal and s1["loss"] <= first[0] and s1["objf"] <= first[0]
          and s1["grad_norm"] <= first[1] and (first[2] is None or heads_grad <= first[2]))
    if drift is not None:
        ok = ok and max(later.values()) <= drift and heads <= drift
    if not ok:
        raise AssertionError(f"parallel {label}: two ranks depart from one: step 1 {s1}, heads'"
                             f" gradients {heads_grad}, later {later}, heads {heads}, ranks"
                             f" equal {ranks_equal}")
    return dict(two=two, one=one, rel_by_step=by_step, ranks_equal=ranks_equal,
                first_grads_rel=grads, params_rel=params, heads_grad_rel=heads_grad,
                heads_rel=heads, spawn_s=two_s, gradient_bytes=grad_bytes,
                collectives_per_step=stats,
                launches={f"rank{i}": r["launches"] for i, r in enumerate(two)})


def _model_axis(args, tmp: str, smi: str) -> dict:
    """(d) the model axis: `tools/multihost_worker.py`'s model mode (the
    model built from the seed on each rank, `shard_params`, then
    `make_train_step` with `ChainOptimizer`, Adam 1e-3) on a data 1 x model
    MODEL_AXIS mesh of gloo ranks sharing the card, against one unsharded
    rank in this process, on the trigram corpus's first global batch of
    PARALLEL_CONFORMER_B rows.  Variants, in one spawn: (d1) the bf16
    conformer (8 x 256) with the dense and the fused feed-forward, split
    over the model group (F 1024 / 2 a rank: K10f/K10b on [256, 512]
    shards with `partial`), MODEL_STEPS steps; float32 copies of both, one
    step; (d2) float32, one step, at MODEL_MIN_SHARD (qkv, conv_in,
    attn_out, conv_out and the heads' first layers gathered on use).
    Gates: every rank's first-step loss, objf and gradient norm against the
    one rank's at REFERENCE_RTOL of the trunk dtype; the model ranks' curves
    (loss, objf, gradient norm of every step) equal; each rank launches K1-K6
    and K7 (and K10 with the fused feed-forward) and no other kernel; the
    split leaves' shards are [256, 512] and [512, 256]; (d2) gathers the
    MODEL_GATHERED leaves.  Logged: each rank's parameter and Adam-moment
    bytes against one rank's, the collectives and bytes a step by group, ms
    between steps.  Not a scaling figure: the ranks share one card."""
    from torchain_tpu_torch.tools import multihost_worker as mw

    work = str(pathlib.Path(tmp) / "parallel_model")
    base = _parallel_config(args, "conformer", PARALLEL_CONFORMER_B, MODEL_STEPS, work)
    bf16, f32 = dict(CONFORMER, dtype="bfloat16"), dict(CONFORMER, dtype="float32")
    variants = {
        "d1_dense": dict(model_cfg=bf16),
        "d1_fused": dict(model_cfg=dict(bf16, ffn_impl="fused")),
        "d1_dense_f32": dict(model_cfg=f32, steps=1),
        "d1_fused_f32": dict(model_cfg=dict(f32, ffn_impl="fused"), steps=1),
        "d2": dict(model_cfg=f32, steps=1, min_shard_size=MODEL_MIN_SHARD),
    }
    cfg = dict(base, precompile=0, save_params=None, variants=list(variants.values()),
               mesh=dict(data=1, model=MODEL_AXIS))
    t0 = time.perf_counter()
    ranks = mw.spawn(MODEL_AXIS, "model", cfg, work, device="cuda:0", backend="gloo",
                     timeout=PARALLEL_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    one = mw.run("model", 0, 1, "cuda", dict(cfg, mesh=dict(data=1, model=1)), work)
    out = dict(spawn_s=spawn_s, one_s=one["seconds"],
               placement=[r["mesh"] for r in ranks], variants={})
    failed = []
    for i, name in enumerate(variants):
        got = [r["variants"][i] for r in ranks]
        ref = one["variants"][i]
        dtype = cfg["variants"][i]["model_cfg"]["dtype"]
        gate = REFERENCE_RTOL[dtype]
        # step 1 of every rank against the one rank's
        rel = {k: max(abs(g[k] - ref[k]) for g in got) / abs(ref[k])
               for k in ("loss", "objf", "grad_norm")}
        fused = cfg["variants"][i]["model_cfg"].get("ffn_impl") == "fused"
        must = DEN_NUM + ATTENTION + (FFN if fused else ())
        shapes = got[0]["shard_shapes"]
        last = f"block{CONFORMER['num_layers'] - 1}.ffn2_out.kernel"
        split = (shapes.get("block0.ffn1_in.kernel"), shapes.get(last))
        gathered = sorted({k.split(".")[1] for k in shapes if k.split(".")[1] in MODEL_GATHERED})
        steps = len(got[0]["curve"])
        rec = dict(rel=rel, gate=gate, steps=steps, ranks_equal=got[0]["curve"] == got[1]["curve"],
                   step_ms=[g["step_ms"] for g in got], one_step_ms=ref["step_ms"],
                   param_bytes=[g["param_bytes"] for g in got], one_param_bytes=ref["param_bytes"],
                   opt_state_bytes=[g["opt_state_bytes"] for g in got],
                   one_opt_state_bytes=ref["opt_state_bytes"],
                   state_ratio=(got[0]["param_bytes"] + got[0]["opt_state_bytes"])
                   / (ref["param_bytes"] + ref["opt_state_bytes"]),
                   collectives_per_step=got[0]["collectives_per_step"],
                   launches=[{k: n / steps for k, n in g["launches"].items() if n} for g in got],
                   one_launches={k: n / steps for k, n in ref["launches"].items() if n},
                   sharded=len(shapes), split_shapes=split, gathered=gathered)
        out["variants"][name] = rec
        st = rec["collectives_per_step"]
        _log(f"parallel (d) {name}: data 1 x model {MODEL_AXIS} (gloo, one card) against 1 rank,"
             f" B={PARALLEL_CONFORMER_B}, {dtype}, {steps} step(s); step 1 (worst rank) rel loss"
             f" {rel['loss']:.3g} objf {rel['objf']:.3g} grad norm {rel['grad_norm']:.3g} (gate"
             f" {gate:g}); the ranks' curves equal: {rec['ranks_equal']}; parameter + Adam-moment"
             f" bytes a rank {got[0]['param_bytes'] + got[0]['opt_state_bytes']} against one"
             f" rank's {ref['param_bytes'] + ref['opt_state_bytes']} ({rec['state_ratio']:.4f}x);"
             f" {len(shapes)} sharded leaves, split shards {split}, gathered {gathered};"
             f" collectives a step: model group all-reduce {st['model']['all_reduce']:g}"
             f" ({st['model']['all_reduce_bytes']:.0f} B), all-gather"
             f" {st['model']['all_gather']:g} ({st['model']['all_gather_bytes']:.0f} B); data"
             f" group {st['data']['all_reduce']:g} all-reduces; ms between steps"
             f" {rec['step_ms']} against {ref['step_ms']}; launches a step a rank"
             f" {rec['launches'][0]} ({smi})")
        for r, g in enumerate(got):
            _launch_gate(f"parallel (d) {name} rank {r}", g["launches"], must)
        if not max(rel.values()) <= gate:
            failed.append(f"{name}: step 1 {rel} (gate {gate})")
        if not rec["ranks_equal"]:
            failed.append(f"{name}: the model ranks' curves differ")
        D = CONFORMER["dim"]
        shard = (4 * D) // MODEL_AXIS
        if split != ([D, shard], [shard, D]):
            failed.append(f"{name}: the feed-forward is not split as [{D}, {shard}] /"
                          f" [{shard}, {D}]: {split}")
        if name == "d2" and tuple(gathered) != tuple(sorted(MODEL_GATHERED)):
            failed.append(f"d2: gathered {gathered}, expected {sorted(MODEL_GATHERED)}")
    if failed:
        raise AssertionError("parallel (d): " + "; ".join(failed))
    out["launches"] = {f"{name}_rank{r}": ranks[r]["variants"][i]["launches"]
                       for i, name in enumerate(variants) for r in range(MODEL_AXIS)}
    return out


def check_parallel(args, result: dict, tmp: str) -> dict:
    """Phase 4, after the trunks: data parallelism (parallel/, ops/sharded.py,
    the data axis of `Trainer` and `cli.train`) on the card, at the trigram
    path's widths (TDNN-F 9 x (768, 96), prefinal 256, the resident
    2079-state trigram den graph, T_out=50, Adam 1e-3, --steps steps):

      (a) a world of one through `torch.distributed.run` and `cli.train
          --distributed` (NCCL) against the plain `cli.train` run;
      (b) two ranks on the one card over gloo, 64 rows each of global
          batches of 128, against one rank on the same global batches:
          the ranks' curves equal, the first step's loss, objf, gradient
          norm and the heads' output layers' gradients at the JAX gates, the later steps and
          the heads' parameters after the run within PARALLEL_DRIFT_RTOL,
          K1-K6 once a step on each rank and no other kernel; ms between
          steps, all-reduces and their bytes a step;
      (c) the bfloat16 conformer (8 x 256) at a global batch of 8 on two
          ranks against one, its first step's loss, objf and gradient norm
          at REFERENCE_RTOL["bfloat16"] (its batchnorm over both ranks, K7
          on each; its parameter gradients and later steps logged: in bf16
          they part by the rounding of sums in another order, as the
          conformer paths' card-vs-CPU groups do, ~1e-1 in norm);
      (d) the model axis (`_model_axis`): the bf16 conformer split over a
          model group of two ranks against one rank, with each
          feed-forward lowering, float32 copies, and the float32 conformer
          at a lower threshold whose other sharded leaves are gathered on
          use.

    Nothing here is a scaling figure: both ranks share one card.  Returns
    the phase's numbers; each run's launch counts are under "launches"."""
    t_phase = time.perf_counter()
    smi = result["nvidia_smi"]
    out = dict(world1=_parallel_world1(args, tmp, smi))
    out["tdnnf"] = _parallel_pair(args, "(b) TDNN-F", "tdnnf", PARALLEL_B, args.steps, DEN_NUM,
                                  (PARALLEL_LOSS_RTOL, PARALLEL_GRAD_RTOL, PARALLEL_HEADS_REL),
                                  PARALLEL_DRIFT_RTOL, tmp, smi)
    gate = REFERENCE_RTOL["bfloat16"]
    out["conformer"] = _parallel_pair(args, "(c) conformer", "conformer", PARALLEL_CONFORMER_B,
                                      PARALLEL_CONFORMER_STEPS, DEN_NUM + ATTENTION,
                                      (gate, gate, None), None, tmp, smi)
    out["model"] = _model_axis(args, tmp, smi)
    out["launches"] = dict(world1=out["world1"]["launches"],
                           **{f"tdnnf_{k}": v for k, v in out["tdnnf"]["launches"].items()},
                           **{f"conformer_{k}": v for k, v in out["conformer"]["launches"].items()},
                           **{f"model_{k}": v for k, v in out["model"]["launches"].items()})
    out["phase_s"] = time.perf_counter() - t_phase
    _log(f"parallel phase: {out['phase_s']:.1f} s ({smi})")
    return out


#: gates of the reference check, relative, per trunk dtype.  float32: sums
#: in another order (cuBLAS vs the CPU BLAS, kernels vs plain) through 9
#: layers, the 50-frame recursions and a backward.  bfloat16: the card's and
#: the CPU's matrix products round their bfloat16 results from sums taken in
#: another order, layer after layer (on an H100 at B=8, TDNN-F: loss 2.3e-4,
#: objf 6.3e-4, gradient norm 1.3e-3).  The same gate holds the first loss of
#: the conformer with the fused feed-forward to that of the dense one
REFERENCE_RTOL = {"float32": 1e-3, "bfloat16": 1e-2}


def _grad_groups(model) -> dict:
    """The model's gradients by parameter group (the first component of a
    parameter's name: each block, the frontend, each head), each flattened
    to one float64 vector on the CPU."""
    import torch

    groups = {}
    for name, prm in model.named_parameters():
        groups.setdefault(name.split(".")[0], []).append(prm.grad.detach().double().flatten().cpu())
    return {k: torch.cat(v) for k, v in groups.items()}


def _loss_and_grads(model, dev, small, corpus, path, opts):
    """One loss + gradient of `model` on `dev`: (numbers, gradients by group)."""
    import torch

    from torchain_tpu_torch.ops import chain_loss

    den, sup = place(path, corpus, small, dev)
    chain, xent = model(torch.as_tensor(small.feats, device=dev), train=True)
    loss, aux = chain_loss(chain, xent, den, sup, opts)
    loss.backward()
    gn = torch.sqrt(sum(torch.sum(p.grad.double() ** 2) for p in model.parameters()))
    return (dict(loss=float(loss.detach()), objf=float(aux["objf"].detach()), grad_norm=float(gn)),
            _grad_groups(model))


def _rel(a, b) -> float:
    """|a - b| / |b| of two gradient vectors (Euclidean norms)."""
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def reference_check(cfg, feat_dim, dataset, corpus, seed: int, path: str) -> dict:
    """Phase 5: one loss + gradient on a small batch, on the card (kernels)
    and on the CPU (plain versions), from the same weights.  For a conformer
    with a bfloat16 trunk it also prints, per parameter group, the card's
    gradient against the CPU's, and both against a float32 CPU copy of the
    same weights (what the gate's bfloat16 spread is made of), and that
    copy run on the card against it (the kernels without bfloat16)."""
    import torch

    from torchain_tpu_torch.ops import ChainLossOptions

    small = next(dataset.batches(8, shuffle=False))
    opts = ChainLossOptions(l2_regularize=5e-4, leaky_hmm_coefficient=0.1,
                            xent_regularize=0.1)
    model = make_model(cfg, feat_dim, "cpu", seed + 1)
    rtol = REFERENCE_RTOL[PATHS[path]["dtype"]]
    out = dict(rtol=rtol)
    grads = {}
    for dev in ("cuda", "cpu"):
        out[dev], grads[dev] = _loss_and_grads(copy.deepcopy(model).to(dev), dev, small,
                                               corpus, path, opts)
    if PATHS[path]["model"] == "conformer" and PATHS[path]["dtype"] == "bfloat16":
        m32 = make_model(dataclasses.replace(cfg, dtype=torch.float32), feat_dim, "cpu", seed + 1)
        m32.load_state_dict(model.state_dict())
        out["card_float32"], g32c = _loss_and_grads(copy.deepcopy(m32).to("cuda"), "cuda",
                                                    small, corpus, path, opts)
        out["cpu_float32"], g32 = _loss_and_grads(m32, "cpu", small, corpus, path, opts)
        card, cpu = grads["cuda"], grads["cpu"]
        whole = {k: torch.cat([g[n] for n in g32]) for k, g in
                 (("cuda", card), ("cpu", cpu), ("f32", g32), ("card_f32", g32c))}
        out["groups"] = {n: dict(card_vs_cpu=_rel(card[n], cpu[n]),
                                 card_vs_f32=_rel(card[n], g32[n]),
                                 cpu_vs_f32=_rel(cpu[n], g32[n]),
                                 card_f32_vs_f32=_rel(g32c[n], g32[n]),
                                 f32_norm=float(g32[n].norm())) for n in g32}
        out["vs_float32"] = dict(
            grad_norm_f32=out["cpu_float32"]["grad_norm"],
            card_vs_f32=_rel(whole["cuda"], whole["f32"]),
            cpu_vs_f32=_rel(whole["cpu"], whole["f32"]),
            card_f32_vs_f32=_rel(whole["card_f32"], whole["f32"]),
            card_norm_rel_f32=abs(out["cuda"]["grad_norm"] - out["cpu_float32"]["grad_norm"])
            / out["cpu_float32"]["grad_norm"],
            cpu_norm_rel_f32=abs(out["cpu"]["grad_norm"] - out["cpu_float32"]["grad_norm"])
            / out["cpu_float32"]["grad_norm"],
        )
        _log(f"{path} reference groups (seed {seed}; gradient differences relative to the"
             " second's norm): group, card vs cpu, card vs f32, cpu vs f32,"
             " card f32 vs f32, f32 norm")
        for n, g in out["groups"].items():
            _log(f"  {path} group {n}: {g['card_vs_cpu']:.3e} {g['card_vs_f32']:.3e}"
                 f" {g['cpu_vs_f32']:.3e} {g['card_f32_vs_f32']:.3e} {g['f32_norm']:.6g}")
        _log(f"{path} reference vs float32 (seed {seed}): " + json.dumps(out["vs_float32"]))
        # the kernels without bfloat16: the float32 copy on the card against
        # the CPU, per group and whole, at the float32 gate
        f32_gate = REFERENCE_RTOL["float32"]
        worst = max(out["groups"].items(), key=lambda kv: kv[1]["card_f32_vs_f32"])
        out["card_f32_gate"] = f32_gate
        _log(f"{path} reference float32 copy, card vs CPU: worst group {worst[0]}"
             f" {worst[1]['card_f32_vs_f32']:.3e}, whole"
             f" {out['vs_float32']['card_f32_vs_f32']:.3e} (gate {f32_gate:g})")
        if not (worst[1]["card_f32_vs_f32"] <= f32_gate
                and out["vs_float32"]["card_f32_vs_f32"] <= f32_gate):
            raise AssertionError(f"reference check [{path}]: the float32 copy's gradient on"
                                 " the card departs from the CPU's")
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
    _PATH_DATA[path] = (corpus, cfg, dataset, den)

    # phase 4: the path itself
    torch.cuda.reset_peak_memory_stats()
    losses, times, launches, step, _ = train_steps(
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
            if "Compiling entry function" in line:  # K7's and K10's kernels by name
                entry = line.split("'")[1] if name in ("attention", "fused_ffn") else ""
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
    if not args.kernels_only:
        result["captured"] = check_captured(args, result)
        for path, n in result["captured"]["launches"].items():
            launches[f"captured_{path}"] = n
        _PATH_DATA.clear()
        result["den_forms"] = check_den_forms(args, result)
        with tempfile.TemporaryDirectory() as prep:
            result["cegs"] = check_cegs(args, result, prep)
            launches["cegs"] = result["cegs"]["launches"]
            result["recipe"] = check_recipe(args, result, prep)
            launches["recipe"] = result["recipe"]["launches"]
            launches["recipe_compute_prob"] = result["recipe"]["compute_prob_launches"]
            result["decode"] = check_decode(args, result, prep)
            launches["decode"] = result["decode"]["launches"]
            result["kaldi"] = check_kaldi(args, result, prep)
            launches["kaldi_left"] = result["kaldi"]["launches_left"]
            launches["kaldi_triphone"] = result["kaldi"]["launches_triphone"]
            result["wav"] = check_wav(args, result, prep)
            launches["wav"] = result["wav"]["launches"]
            result["trunks"] = check_trunks(args, result, prep)
            for name, n in result["trunks"]["launches"].items():
                launches[f"trunks_{name}"] = n
            result["parallel"] = check_parallel(args, result, prep)
            for name, n in result["parallel"]["launches"].items():
                launches[f"parallel_{name}"] = n
    for name, m in second.items():
        numbers[name] = dict(**numbers[name], production=m)
    if not args.kernels_only:
        # K10's launches at the model shard: the model axis's fused run, rank 0
        for name in FFN:
            numbers[name]["model_shard"]["launches"] = launches[
                "parallel_model_d1_fused_rank0"].get(name, 0)
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
    must = {**{p: PATHS[p]["kernels"] for p in PATHS},
            **{f"captured_{p}": PATHS[p]["kernels"] for p in PATHS},
            "cegs": DEN_NUM, "probe": PROBE,
            "recipe": DEN_NUM, "recipe_compute_prob": EVAL_DEN_NUM, "decode": DECODE_KERNELS,
            "kaldi_left": DEN_NUM, "kaldi_triphone": NUM, "wav": DEN_NUM,
            **{k: DEN_NUM for k in launches if k.startswith("trunks_")},
            **{k: DEN_NUM for k in launches if k.startswith("parallel_")}}
    records = []
    for name, (_, _, source, replaces, _) in KERNELS.items():
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
    if sys.argv[1:2] == [CLI_RUNNER]:
        sys.exit(_trigram_cli(sys.argv[2:]))
    sys.exit(main())
