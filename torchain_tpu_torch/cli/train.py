"""End-to-end chain training recipe (torch), port of
torchain_tpu/cli/train.py.

The torchain example/train.py CLI: argparse flags mirroring
ChainTrainingOptions (l2-regularize, leaky-hmm-coefficient,
xent-regularize, lr), the trainer's recipe options (LR schedule,
max-change, dropout schedule, backstitch, gradient accumulation,
semi-orthogonal constraint), per-interval ChainResults logging and
checkpoints with exact resume.  Data sources: the built-in synthetic
corpus (--synthetic), its word-level form (--synthetic-words), or a
completed Kaldi chain prep (--cegs + --den-fst), or a raw-audio Kaldi data
dir (--wav-dir: wav.scp -> fbank on the device -> per-speaker CMVN, with
3-way speed perturbation by --speed-perturb and online i-vectors appended
by --ivector-dim).  The chunk supervisions can be compiled up front in
worker processes (--precompile-egs), saved to and loaded from an egs
archive (--save-egs, --load-egs), and the minibatches materialized once in
host memory or on the device (--materialize-egs).  On the synthetic
corpora, --flat-start-ladder trains flat-start (e2e) first, force-aligns
the corpus with that model and trains on the generated alignments; --decode
then decodes every utterance (the model's forward one utterance at a time,
the decoders on the host): the phone PER over the training phone LM and,
with --synthetic-words, the word WER over the word HCLG, with an LMWT
sweep (--lmwt-min/--lmwt-max) and MBR (--mbr).  --tied-tree-pdfs N builds a
tied tree of N pdfs from the corpus's alignments (stage 0t, left or
triphone context by --tied-tree-context) and trains on it, with the den
graph and normalization FST that tree gives.

It runs on the card unless asked otherwise: `--device cuda` (default)
needs a CUDA device and exits 2 without one; `--device cpu` runs on the
CPU, where every kernel wrapper takes its plain PyTorch version.

Data parallelism runs one process a card under torch.distributed.run
(where the JAX package runs one process a host): `--distributed` joins the
process group (NCCL on the cards, gloo on the CPU; `--device cuda` takes
cuda:LOCAL_RANK) and `--data-parallel` (default -1, every process) is the
data axis.  `--batch-size` is the global batch: each rank trains on its
rows of it (flat-start e2e: on its own utterances), and every rank takes
the same update.  `--model-parallel M` (default 1) is the model axis, as
in the JAX CLI: the data axis becomes world / M, the ranks of a model group
read their data rank's rows, and the state stays replicated on every rank
(the JAX `Trainer` shards none of it).

Usage:
  python -m torchain_tpu_torch.cli.train --synthetic --steps 200
  python -m torch.distributed.run --nproc-per-node 4 -m torchain_tpu_torch.cli.train \
      --synthetic --distributed --batch-size 128 --steps 200
  python -m torchain_tpu_torch.cli.train --synthetic --model tdnnf --epochs 4
  python -m torchain_tpu_torch.cli.train --synthetic --num-phones 40 \\
      --tied-tree-pdfs 1000 --tied-tree-context triphone --steps 10
  python -m torchain_tpu_torch.cli.train --synthetic-words --flat-start-ladder \\
      --decode --lmwt-min 1 --lmwt-max 12 --mbr
  python -m torchain_tpu_torch.cli.train --cegs 'exp/egs/cegs.*.ark' \\
      --den-fst exp/chain/den.fst --checkpoint-dir exp/ckpt
  python -m torchain_tpu_torch.cli.train --wav-dir data/train --cmvn speaker \\
      --speed-perturb --ivector-dim 100 --precompile-egs 8 --save-egs egs.npz \\
      --materialize-egs device
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic", action="store_true", help="use the built-in synthetic corpus")
    p.add_argument(
        "--synthetic-words",
        action="store_true",
        help="word-level synthetic corpus: sentences are word sequences "
        "expanded through a random lexicon; --decode then also builds the "
        "word HCLG and reports word WER (latgen-faster-mapped role)",
    )
    p.add_argument("--vocab-size", type=int, default=20)
    p.add_argument("--word-lm-order", type=int, default=2)
    p.add_argument(
        "--tied-tree-pdfs",
        type=int,
        default=0,
        help="build a data-driven TIED tree from the corpus alignments with "
        "this pdf budget (Kaldi build-tree role) and train/decode with it; "
        "0 keeps the enumerated ContextTree",
    )
    p.add_argument(
        "--tied-tree-context",
        choices=("left", "triphone"),
        default="left",
        help="context window of the tied tree (triphone enables the "
        "delayed-emission right-context graph expansion)",
    )
    p.add_argument("--num-utts", type=int, default=64)
    p.add_argument("--num-phones", type=int, default=12)
    p.add_argument("--feat-dim", type=int, default=24)
    p.add_argument("--context-width", type=int, default=1, choices=(1, 2))
    p.add_argument("--model", choices=("tdnn", "tdnnf", "tdnn-lstm", "cnn-tdnn", "conformer"),
                   default="tdnnf")
    p.add_argument(
        "--cegs",
        help="train directly from merged Kaldi cegs archives (comma-separated "
        "paths/globs) of a completed Kaldi chain prep; requires --den-fst.  "
        "The normalization FST is already composed into the egs, so no "
        "corpus or tree stage runs",
    )
    p.add_argument("--den-fst", help="with --cegs: the denominator FST (binary OpenFst or text)")
    p.add_argument(
        "--num-pdfs", type=int, default=0,
        help="with --cegs: output dim (default: the egs' label_dim)",
    )
    p.add_argument("--no-ivector", action="store_true", help="with --cegs: ignore the egs' ivector io")
    p.add_argument(
        "--ignore-deriv-weights", action="store_true",
        help="with --cegs: treat non-uniform deriv_weights as 1.0 (default: apply "
        "them as per-frame derivative row scales, Kaldi ApplyDerivWeights)",
    )
    p.add_argument("--hidden-dim", type=int, default=256)
    p.add_argument("--bottleneck-dim", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=5)
    p.add_argument("--chunk-frames", type=int, default=30, help="output-rate chunk size")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument(
        "--grad-accum-steps", type=int, default=1,
        help="accumulate gradients over N micro-batches per optimizer update "
        "(effective batch = N * batch-size)",
    )
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument(
        "--lr-final", type=float, default=0.0,
        help="exponential LR decay from --lr to this value over the run "
        "(Kaldi nnet3 train.py initial/final-effective-lrate schedule)",
    )
    p.add_argument(
        "--combine-last", type=int, default=0,
        help="after training, average the params of the last N checkpoints "
        "(Kaldi 'combine' stage); requires --checkpoint-dir",
    )
    p.add_argument("--optimizer", choices=("adam", "adam-lowmem", "sgd", "ngsgd"), default="adam")
    p.add_argument(
        "--ivector-dim",
        type=int,
        default=0,
        help="train an online iVector extractor on the training utterances "
        "and append iVectors to the features (Kaldi online-ivector stages; "
        "0 = off)",
    )
    p.add_argument("--ivector-gauss", type=int, default=32)
    p.add_argument(
        "--dropout-schedule", default="",
        help="Kaldi --trainer.dropout-schedule, e.g. '0,0@0.20,0.5@0.50,0' "
        "(continuous per-dim dropout; '' = off)",
    )
    p.add_argument(
        "--frame-shift-cycle", action="store_true",
        help="cycle the input frame shift 0..fsf-1 across epochs (Kaldi "
        "frame-shift egs augmentation)",
    )
    p.add_argument(
        "--max-param-change", type=float, default=0.0,
        help="cap the global parameter update 2-norm per step (Kaldi "
        "--trainer.max-param-change; recipe default 2.0; 0 = off)",
    )
    p.add_argument(
        "--max-change-per-component", type=float, default=0.0,
        help="cap each component's update 2-norm per step (Kaldi "
        "max-change; recipe default 0.75; 0 = off)",
    )
    p.add_argument(
        "--backstitch-scale", type=float, default=0.0,
        help="Kaldi --trainer.backstitch-training-scale (e.g. 0.3; 0 = off)",
    )
    p.add_argument("--backstitch-interval", type=int, default=1)
    p.add_argument(
        "--save-egs", default="", metavar="PATH",
        help="after (pre)compiling, write all chunk supervisions to a .npz "
        "archive (nnet3-chain-get-egs archive role: prep once, train many)",
    )
    p.add_argument(
        "--load-egs", default="", metavar="PATH",
        help="load a --save-egs archive instead of compiling supervisions "
        "(refuses archives whose corpus/tree/options fingerprint differs)",
    )
    p.add_argument(
        "--materialize-egs", nargs="?", const="ram", choices=("ram", "device"),
        default="",
        help="materialize all merged minibatches once and replay them per "
        "epoch (the Kaldi merged-cegs-archive economics; "
        "data/materialize.py).  'ram' (default when the flag is bare) "
        "keeps host arrays and removes the per-epoch pad/stack cost; "
        "'device' places every batch on --device once, removing the "
        "per-step host-to-device copies too (the corpus must fit).  "
        "Incompatible with --frame-shift-cycle; not applied to --cegs",
    )
    p.add_argument(
        "--precompile-egs", type=int, default=0, metavar="WORKERS",
        help="compile all chunk supervisions up-front in N parallel worker "
        "processes (nnet3-chain-get-egs offline-prep role); they are "
        "cached across epochs either way",
    )
    p.add_argument("--l2-regularize", type=float, default=5e-4)
    p.add_argument("--leaky-hmm-coefficient", type=float, default=0.1)
    p.add_argument("--xent-regularize", type=float, default=0.1)
    p.add_argument("--left-tolerance", type=int, default=2)
    p.add_argument("--right-tolerance", type=int, default=2)
    p.add_argument("--e2e", action="store_true", help="flat-start: train from transcripts only (no alignments)")
    p.add_argument(
        "--flat-start-ladder",
        action="store_true",
        help="two-stage recipe: e2e flat-start training, then force-align "
        "with the stage-1 model and continue with tolerance-lattice "
        "supervision on the generated alignments",
    )
    p.add_argument("--semi-ortho-every", type=int, default=4)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--metrics-out", default=None)
    p.add_argument("--log-every", type=int, default=20, help="steps between metric reads and log lines")
    p.add_argument(
        "--valid-utts", type=int, default=0,
        help="hold out the last N utterances and report validation objf "
        "(nnet3-chain-compute-prob parity)",
    )
    p.add_argument("--decode", action="store_true", help="decode + score after training")
    p.add_argument("--decode-beam", type=float, default=16.0)
    # score.sh LMWT sweep for the word decode stage (0 = plain best path)
    p.add_argument("--lmwt-min", type=int, default=0)
    p.add_argument("--lmwt-max", type=int, default=0)
    p.add_argument(
        "--mbr",
        action="store_true",
        help="decode stage also reports MBR (sausage) word WER at the "
        "swept best LMWT (lattice-mbr-decode role; needs --lmwt sweep)",
    )
    p.add_argument(
        "--phone-insertion-bonus",
        type=float,
        default=0.0,
        help="added to phone-emitting arcs at decode time (counters "
        "deletion-heavy error patterns; Kaldi insertion-penalty role)",
    )
    p.add_argument(
        "--wav-dir",
        default="",
        help="train from a RAW-AUDIO Kaldi data dir (wav.scp [+segments] "
        "[+utt2spk], ali.txt; text/lexicon/words.txt enable the word "
        "decode stage) — the real-corpus front; see data/synth_wav.py "
        "for a self-contained generator.  The filterbank runs on --device",
    )
    p.add_argument(
        "--cmvn",
        choices=("none", "speaker", "utterance"),
        default="speaker",
        help="feature normalization for --wav-dir (apply-cmvn role; "
        "'speaker' uses utt2spk / cmvn stats)",
    )
    p.add_argument(
        "--speed-perturb",
        action="store_true",
        help="3-way 0.9/1.0/1.1 speed perturbation at the wav front "
        "(perturb_data_dir_speed_3way.sh role; --wav-dir only)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--steps", type=int, default=0,
        help="stop after N steps (0 = run --epochs); also the LR decay's horizon",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device to train on (default cuda; cpu runs the plain versions of the kernels)",
    )
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="the data axis of the mesh: -1 every process of the process group "
                   "over the model axis")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="the model axis of the mesh (the state stays replicated over it, as "
                   "in the JAX Trainer)")
    p.add_argument(
        "--distributed",
        action="store_true",
        help="join the process group torch.distributed.run sets up (RANK, WORLD_SIZE, "
        "LOCAL_RANK, MASTER_ADDR, MASTER_PORT): one process a card; the standard path "
        "shards the rows of every global batch, the e2e path the utterances",
    )
    return p


def _join(args, device: torch.device) -> torch.device:
    """--distributed: join the process group and return this rank's device;
    check that --data-parallel x --model-parallel is the world either way."""
    from torchain_tpu_torch.parallel.mesh import init_distributed, world_size

    if args.distributed:
        device = init_distributed(device)
        import torch.distributed as dist

        print(f"[distributed] rank {dist.get_rank()}/{dist.get_world_size()} on {device} "
              f"({dist.get_backend()})")
    n = world_size()
    model = max(1, args.model_parallel)
    data = args.data_parallel if args.data_parallel > 0 else n // model
    if data * model != n:
        raise SystemExit(
            f"--data-parallel {data} --model-parallel {model}: mesh {data}x{model} != {n} "
            "devices; run one process a card under `python -m torch.distributed.run "
            "--nproc-per-node N` with --distributed")
    return device


def _rank() -> tuple[int, int]:
    """(this process's rank, the world size); (0, 1) without a process
    group."""
    from torchain_tpu_torch.parallel.mesh import world_size

    import torch.distributed as dist

    n = world_size()
    return (dist.get_rank() if n > 1 else 0), n


def _data_rank(args) -> tuple[int, int]:
    """(this process's data rank, the data axis's size): the global rank
    over the model axis, laid out as `parallel.mesh_layout` places it."""
    rank, world = _rank()
    model = max(1, args.model_parallel)
    return rank // model, world // model


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on; exits 2 where a CUDA device is
    asked for and there is none (no fall-back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(
            f"no CUDA device for --device {name}: this tool runs on the card; "
            "pass --device cpu to run it on the CPU",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return device


def _build_model(args, num_pdfs: int, feat_dim: int, device):
    """The --model family from CLI args, its parameters drawn from --seed;
    returns (model, cfg)."""
    from torchain_tpu_torch.models import (
        CNNTDNN,
        TDNN,
        TDNNF,
        TDNNLSTM,
        CnnTdnnConfig,
        Conformer,
        ConformerConfig,
        TdnnConfig,
        TdnnfConfig,
        TdnnLstmConfig,
    )

    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "tdnn":
        cfg = TdnnConfig(num_pdfs=num_pdfs, hidden_dim=args.hidden_dim)
        return TDNN(cfg, feat_dim, device=device, generator=gen), cfg
    if args.model == "tdnnf":
        cfg = TdnnfConfig(
            num_pdfs=num_pdfs,
            hidden_dim=args.hidden_dim,
            bottleneck_dim=args.bottleneck_dim,
            num_layers=args.num_layers,
        )
        return TDNNF(cfg, feat_dim, device=device, generator=gen), cfg
    if args.model == "cnn-tdnn":
        cfg = CnnTdnnConfig(
            num_pdfs=num_pdfs,
            feat_dim=feat_dim,
            hidden_dim=args.hidden_dim,
            bottleneck_dim=args.bottleneck_dim,
            num_tdnnf_layers=args.num_layers,
        )
        return CNNTDNN(cfg, feat_dim, device=device, generator=gen), cfg
    if args.model == "tdnn-lstm":
        cfg = TdnnLstmConfig(
            num_pdfs=num_pdfs,
            hidden_dim=args.hidden_dim,
            cell_dim=args.hidden_dim,
            rec_proj_dim=max(8, args.hidden_dim // 4),
            nonrec_proj_dim=max(8, args.hidden_dim // 4),
        )
        return TDNNLSTM(cfg, feat_dim, device=device, generator=gen), cfg
    cfg = ConformerConfig(num_pdfs=num_pdfs, dim=args.hidden_dim, num_layers=args.num_layers)
    return Conformer(cfg, feat_dim, device=device, generator=gen), cfg


def cegs_setup(args, device, tag: str = "cegs"):
    """Shared --cegs setup (cli.compute_prob uses it too): dataset, compiled
    den graph, model, den device form; one source of truth for the
    train/score pairing."""
    from torchain_tpu_torch.cli.graphs import _load_any_fst
    from torchain_tpu_torch.data import CegsDataset
    from torchain_tpu_torch.graphs import compile_den_graph
    from torchain_tpu_torch.ops import auto_den_graph

    if not args.den_fst:
        raise SystemExit("--cegs needs --den-fst")
    dataset = CegsDataset(
        args.cegs,
        append_ivector=not args.no_ivector,
        seed=args.seed,
        ignore_deriv_weights=getattr(args, "ignore_deriv_weights", False),
    )
    feat_dim, label_dim, bsz, t_out = dataset.peek()
    num_pdfs = args.num_pdfs or label_dim
    den_fst, fmt, _arct = _load_any_fst(args.den_fst)
    graph = compile_den_graph(den_fst, num_pdfs)
    print(
        f"[{tag}] {len(dataset.paths)} archive(s); merged batch={bsz} "
        f"t_out={t_out} feat_dim={feat_dim}; den.fst ({fmt}) "
        f"S={graph.num_states} A={graph.num_arcs} P={num_pdfs}"
    )
    model, _cfg = _build_model(args, num_pdfs, feat_dim, device)
    den = auto_den_graph(graph, device=device)
    print(f"[{tag}] den path: {type(den).__name__}")
    return dict(dataset=dataset, graph=graph, model=model, den=den, bsz=bsz, t_out=t_out,
                feat_dim=feat_dim, num_pdfs=num_pdfs)


def _print_line(text: str) -> None:
    """`text` and its newline in one write: the ranks of a distributed run
    share one stdout, and unbuffered `print` writes the two apart, so two
    ranks' summary lines could merge into one."""
    sys.stdout.write(text + "\n")
    sys.stdout.flush()


def _trainer_config(args, device, batch_size: int, decay_steps: int):
    from torchain_tpu_torch.ops import ChainLossOptions
    from torchain_tpu_torch.parallel import MeshConfig
    from torchain_tpu_torch.train import TrainerConfig

    return TrainerConfig(
        lr=args.lr,
        lr_final=args.lr_final,
        lr_decay_steps=decay_steps if args.lr_final > 0 else 0,
        grad_accum_steps=args.grad_accum_steps,
        optimizer=args.optimizer,
        dropout_schedule=args.dropout_schedule,
        frame_shift_cycle=args.frame_shift_cycle,
        max_param_change=args.max_param_change,
        max_change_per_component=args.max_change_per_component,
        backstitch_scale=args.backstitch_scale,
        backstitch_interval=args.backstitch_interval,
        batch_size=batch_size,
        num_epochs=args.epochs,
        semi_ortho_every=args.semi_ortho_every if args.model in ("tdnnf", "cnn-tdnn") else 0,
        checkpoint_dir=args.checkpoint_dir,
        loss=ChainLossOptions(
            l2_regularize=args.l2_regularize,
            leaky_hmm_coefficient=args.leaky_hmm_coefficient,
            xent_regularize=args.xent_regularize,
        ),
        log_every=args.log_every,
        device=str(device),
        mesh=MeshConfig(data=args.data_parallel, model=args.model_parallel),
    )


def _restore(args, trainer, tag: str) -> None:
    if args.checkpoint_dir and trainer.restore_checkpoint():
        print(f"[{tag}] resumed from step {int(trainer.state.step)} "
              f"(epoch {trainer.start_epoch}, batch {trainer.skip_batches})")


def _fit(args, trainer, dataset, tag: str, t0: float, restore: bool = True) -> dict:
    """Resume where a checkpoint is (unless `restore` is False: the caller
    did), train, write the metrics, combine; returns the CLI's result
    dict."""
    if restore:
        _restore(args, trainer, tag)
    start = int(trainer.state.step)
    results = trainer.fit(dataset, log_fn=print, max_steps=args.steps)
    if start == 0 and trainer.state.step == 0:
        # batching groups chunks by length and drops partial minibatches;
        # a batch size no bucket can fill trains nothing
        raise SystemExit(
            f"no full minibatch produced: --batch-size {args.batch_size} exceeds "
            "every same-length chunk bucket of this dataset — reduce --batch-size "
            "(or add data)"
        )
    print(f"[{tag}] done: {results} ({time.time() - t0:.1f}s)")
    if args.metrics_out and _rank()[0] == 0:
        trainer.dump_metrics(args.metrics_out)
    if args.combine_last and args.checkpoint_dir:
        n = trainer.combine(args.combine_last)
        print(f"[{tag}] combine: averaged last {n} checkpoints "
              "(subsequent stages use the combined model)")
    # host seconds and bytes of the run's stages (train/trainer.py timings)
    tm = trainer.timings
    place = tm["place_s"]
    timings = dict(
        sup_caps_s=tm["sup_caps_s"],
        place_n=len(place),
        place_ms_median=float(np.median(place)) * 1e3 if place else None,
        place_s_total=float(np.sum(place)),
        step_ms=trainer.step_ms(),
        ckpt_write=tm["ckpt_write"],
        ckpt_read=tm["ckpt_read"],
    )
    return dict(objf=results.objf, steps=int(trainer.state.step), timings=timings)


def _decay_steps(args, records: int) -> int:
    """Kaldi-style exponential decay reaches --lr-final at the last step of
    the scheduled run; gradient accumulation advances the schedule once per
    cycle, so the horizon is in optimizer updates."""
    steps = args.steps if args.steps else args.epochs * records
    return max(1, steps // max(1, args.grad_accum_steps))


def _train_from_cegs(args, device) -> dict:
    """Train from a completed Kaldi chain prep: merged cegs archives +
    den.fst, the torchain example workflow.  nnet3-chain-get-egs composed
    the normalization FST into the egs' supervision weights, so den.fst +
    egs are the complete training inputs."""
    from torchain_tpu_torch.train import Trainer

    t0 = time.time()
    setup = cegs_setup(args, device)
    dataset = setup["dataset"]
    decay = _decay_steps(args, dataset.count_records()) if args.lr_final > 0 else 0
    trainer = Trainer(setup["model"], setup["den"],
                      _trainer_config(args, device, setup["bsz"], decay))
    out = _fit(args, trainer, dataset, "cegs", t0)
    print(f"[cegs] chain objf/frame={out['objf']:.4f}")
    _print_line(json.dumps(out))
    return out


def tied_tree_stage(args, corpus) -> None:
    """Stage 0t: a tied tree of --tied-tree-pdfs pdfs from the corpus's
    alignments (subsampled by 3, the models' frame subsampling), in
    --tied-tree-context; replaces the corpus's tree, den graph, den FST and
    normalization FST (and drops its dense Moore form) before the model's
    head is sized."""
    from torchain_tpu_torch.graphs import (
        accumulate_tree_stats,
        build_tied_tree,
        compile_den_graph,
        make_den_fst,
        make_normalization_fst,
    )

    print(
        f"[stage 0t] building tied {args.tied_tree_context} tree "
        f"({args.tied_tree_pdfs} pdfs) from alignments"
    )
    stats = accumulate_tree_stats(
        corpus.utts,
        args.num_phones,
        frame_subsampling_factor=3,
        context=args.tied_tree_context,
    )
    tied = build_tied_tree(stats, num_pdfs=args.tied_tree_pdfs)
    den_fst = make_den_fst(corpus.phone_lm, tied)
    graph = compile_den_graph(den_fst, tied.num_pdfs)
    corpus.tree = tied
    corpus.den_graph = graph
    corpus.den_fst = den_fst
    corpus.dense_den = None
    corpus.norm_fst = make_normalization_fst(den_fst, graph.initial_probs)
    print(
        f"[stage 0t] tied tree: {tied.num_pdfs} pdfs, den graph "
        f"S={graph.num_states} A={graph.num_arcs}"
    )


def ivector_stage(args, corpus, valid_utts: list) -> None:
    """Stage 0i (Kaldi's online-ivector stages): a UBM of --ivector-gauss
    Gaussians and an extractor of --ivector-dim trained on the training
    utterances (host NumPy, float64), their online i-vectors appended to
    each frame; the same extractor applied to the held-out utterances (one
    i-vector every 10 frames, repeated).  Widens --feat-dim in place."""
    import dataclasses

    from torchain_tpu_torch.data import append_corpus_ivectors, extract_ivectors_online

    print(f"[stage 0i] training iVector extractor (dim {args.ivector_dim}, "
          f"{args.ivector_gauss} Gaussians)")
    corpus.utts, ivec_ext = append_corpus_ivectors(
        corpus.utts,
        ivector_dim=args.ivector_dim,
        num_gauss=args.ivector_gauss,
        seed=args.seed,
    )
    for i, u in enumerate(valid_utts):
        ivecs = extract_ivectors_online(ivec_ext, u.feats)
        per_frame = np.repeat(ivecs, 10, axis=0)[: u.feats.shape[0]]
        valid_utts[i] = dataclasses.replace(
            u, feats=np.concatenate([u.feats, per_frame.astype(u.feats.dtype)], axis=1)
        )
    args.feat_dim += args.ivector_dim


def _archive_bytes(path: str) -> int:
    """The size of an egs archive (np.savez_compressed adds ".npz" to a
    path without it)."""
    import os

    return os.path.getsize(path if os.path.exists(path) else path + ".npz")


def egs_stage(args, dataset, stages: dict) -> dict:
    """Stage 1's egs work on a ChainDataset (nothing elsewhere): compile
    every chunk's supervision in --precompile-egs worker processes, load a
    --load-egs archive, write a --save-egs archive, in that order.  Returns
    what was done: counts, host seconds and archive bytes."""
    egs: dict = {}
    if args.precompile_egs and hasattr(dataset, "precompile"):
        t0 = time.perf_counter()
        egs["precompiled"] = dataset.precompile(num_workers=args.precompile_egs)
        stages["precompile_s"] = time.perf_counter() - t0
        print(f"[stage 1] precompiled {egs['precompiled']} egs in "
              f"{stages['precompile_s']:.1f}s ({args.precompile_egs} workers)")
    if args.load_egs and hasattr(dataset, "load_egs"):
        t0 = time.perf_counter()
        egs["loaded"] = dataset.load_egs(args.load_egs)
        stages["load_egs_s"] = time.perf_counter() - t0
        egs["load_bytes"] = _archive_bytes(args.load_egs)
        print(f"[stage 1] loaded {egs['loaded']} egs from {args.load_egs}")
    if args.save_egs and hasattr(dataset, "save_egs") and _rank()[0] == 0:
        t0 = time.perf_counter()
        egs["saved"] = dataset.save_egs(args.save_egs)
        stages["save_egs_s"] = time.perf_counter() - t0
        egs["save_bytes"] = _archive_bytes(args.save_egs)
        print(f"[stage 1] wrote {egs['saved']} egs to {args.save_egs} "
              f"in {stages['save_egs_s']:.1f}s")
    return egs


def _posteriors(model, utts, left: int, right: int, fsf: int):
    """The chain head's output [T_out, P] of every utterance, one at a time
    at B=1 on the model's device (the decode stages' forward, as the
    reference runs it).  Returns (posteriors, host seconds)."""
    from torchain_tpu_torch.eval.align import with_context
    from torchain_tpu_torch.train.step import make_forward_fn

    forward = make_forward_fn(model)
    t0 = time.perf_counter()
    out = []
    for u in utts:
        x = torch.as_tensor(with_context(u.feats, fsf, left, right), device=forward.device)
        out.append(forward(x)[0].float().cpu().numpy())
    return out, time.perf_counter() - t0


def _decode_stages(args, corpus, word_corpus, posts, out: dict) -> None:
    """Stages 3-5: the phone decode and PER over the training phone LM;
    with a word corpus, the word HCLG decode and WER, with the LMWT sweep
    and MBR.  Host code; fills `out` (per, wer, best_lmwt, mbr_wer, and
    host seconds and sizes under "decode")."""
    from torchain_tpu_torch.eval import make_decoding_graph, viterbi_decode, wer
    from torchain_tpu_torch.graphs import PhoneLmOptions, estimate_phone_lm

    dec = out.setdefault("decode", {})
    print("[stage 3] decoding with the training LM")
    refs = [[p for p, _ in u.alignment] for u in corpus.utts]
    t0 = time.perf_counter()
    lm = estimate_phone_lm(refs, PhoneLmOptions(ngram_order=2, num_extra_lm_states=500))
    dgraph = make_decoding_graph(lm, corpus.tree)
    dec["phone_graph_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hyps = [
        viterbi_decode(dgraph, y, beam=args.decode_beam,
                       phone_bonus=args.phone_insertion_bonus)[0]
        for y in posts
    ]
    dec["phone_viterbi_s"] = time.perf_counter() - t0
    score = wer(refs, hyps)
    print(f"[stage 4] PER {score['wer']:.2f}% ({score})")
    out["per"] = score["wer"]
    if word_corpus is None:
        return
    # word-level decode over HCLG (latgen-faster-mapped role)
    from torchain_tpu_torch.data import train_word_lm
    from torchain_tpu_torch.eval import (
        lattice_decode,
        make_word_decoding_graph,
        mbr_decode,
        rescore_lattice,
        score_sweep,
    )

    print("[stage 5] word decode: building HCLG from training transcripts")
    t0 = time.perf_counter()
    word_lm = train_word_lm(word_corpus.transcripts, order=args.word_lm_order)
    wgraph = make_word_decoding_graph(word_lm, word_corpus.lexicon, corpus.tree)
    dec["hclg_s"] = time.perf_counter() - t0
    dec["hclg_states"] = int(wgraph.num_states)
    dec["hclg_arcs"] = int(wgraph.src.shape[0])
    print(f"[stage 5] HCLG: {wgraph.num_states} states, {wgraph.src.shape[0]} arcs")
    sweep = args.lmwt_max >= args.lmwt_min > 0
    t0 = time.perf_counter()
    if sweep:
        wlats = [lattice_decode(wgraph, y, beam=args.decode_beam) for y in posts]
        dec["word_lattice_s"] = time.perf_counter() - t0
        dec["lattice_arcs"] = int(sum(lat.num_arcs for lat in wlats))
        # score.sh role: one corpus-level LMWT picked by best WER
        t0 = time.perf_counter()
        best_lmwt, wscore, whyps, by_lmwt = score_sweep(
            wlats,
            word_corpus.transcripts,
            lmwt_range=range(args.lmwt_min, args.lmwt_max + 1),
        )
        dec["sweep_s"] = time.perf_counter() - t0
        print(f"[stage 5] lmwt sweep: {by_lmwt} -> best {best_lmwt}")
        out["best_lmwt"] = best_lmwt
        if args.mbr:
            # lattice-mbr-decode role: minimum-Bayes-risk word sequence
            # from the sausage, at the swept LMWT
            t0 = time.perf_counter()
            mhyps = [
                mbr_decode(rescore_lattice(lat, lm_scale=float(best_lmwt))).words
                for lat in wlats
            ]
            dec["mbr_s"] = time.perf_counter() - t0
            mscore = wer(word_corpus.transcripts, mhyps)
            print(f"[stage 5m] MBR WER {mscore['wer']:.2f}% ({mscore})")
            out["mbr_wer"] = mscore["wer"]
    else:
        whyps = [viterbi_decode(wgraph, y, beam=args.decode_beam)[0] for y in posts]
        dec["word_viterbi_s"] = time.perf_counter() - t0
        wscore = wer(word_corpus.transcripts, whyps)
    print(f"[stage 5] WER {wscore['wer']:.2f}% ({wscore})")
    out["wer"] = wscore["wer"]


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    if args.synthetic_words:
        args.synthetic = True
    if not args.synthetic and not args.wav_dir and not args.cegs:
        print(
            "Pass --synthetic (or --synthetic-words) for the built-in corpus, "
            "--wav-dir for a raw-audio Kaldi data dir, or --cegs + --den-fst "
            "for a completed Kaldi chain prep.",
            file=sys.stderr,
        )
        sys.exit(2)
    device = _join(args, resolve_device(args.device))
    rank, world = _rank()
    data_rank, data_size = _data_rank(args)
    if world > 1 and args.flat_start_ladder:
        raise SystemExit("--flat-start-ladder under several processes is not ported: its "
                         "alignment stage runs on one process")
    if world > 1 and args.materialize_egs == "device":
        raise SystemExit("--materialize-egs device is single-process (as in the JAX package): "
                         "several ranks stream their shards; use --materialize-egs ram")
    if args.cegs:
        return _train_from_cegs(args, device)

    from torchain_tpu_torch.data import ChainDataset, E2eChainDataset, synthetic_dataset
    from torchain_tpu_torch.graphs import SupervisionOptions
    from torchain_tpu_torch.ops import auto_den_graph
    from torchain_tpu_torch.train import Trainer

    t0 = time.time()
    stages: dict[str, float] = {}
    t_stage = time.perf_counter()
    word_corpus = None
    if args.wav_dir:
        from torchain_tpu_torch.data import load_wav_dir

        print(
            f"[stage 0] assembling corpus from raw-audio dir {args.wav_dir} "
            f"(cmvn={args.cmvn}, speed_perturb={args.speed_perturb})"
        )
        word_corpus = load_wav_dir(
            args.wav_dir,
            cmvn=None if args.cmvn == "none" else args.cmvn,
            speed_perturb=args.speed_perturb,
            context_width=args.context_width,
            device=device,
            timings=stages,
        )
        corpus = word_corpus.corpus
        args.feat_dim = corpus.feat_dim
        if word_corpus.lexicon is None or not any(word_corpus.transcripts):
            word_corpus = None  # no word decode without lexicon+text
    elif args.synthetic_words:
        from torchain_tpu_torch.data import synthetic_word_dataset

        print(f"[stage 0] preparing synthetic WORD corpus ({args.num_utts} utts, "
              f"vocab {args.vocab_size})")
        word_corpus = synthetic_word_dataset(
            num_utts=args.num_utts,
            vocab_size=args.vocab_size,
            num_phones=args.num_phones,
            feat_dim=args.feat_dim,
            context_width=args.context_width,
            seed=args.seed,
        )
        corpus = word_corpus.corpus
    else:
        print(f"[stage 0] preparing synthetic corpus ({args.num_utts} utts)")
        corpus = synthetic_dataset(
            num_utts=args.num_utts,
            num_phones=args.num_phones,
            feat_dim=args.feat_dim,
            context_width=args.context_width,
            seed=args.seed,
        )
    if data_size > 1 and args.e2e:
        # e2e path: each data rank its own utterances (the standard path
        # instead shards the rows of a (seed, epoch)-deterministic global
        # batch plan inside Trainer.fit / ChainDataset.batches)
        corpus.utts = corpus.utts[data_rank::data_size]
    valid_utts = []
    if args.valid_utts > 0:
        valid_utts = corpus.utts[-args.valid_utts :]
        corpus.utts = corpus.utts[: -args.valid_utts]
        if word_corpus is not None:
            word_corpus.transcripts = word_corpus.transcripts[: -args.valid_utts]
    stages["corpus_s"] = time.perf_counter() - t_stage
    if args.ivector_dim > 0:
        t_stage = time.perf_counter()
        ivector_stage(args, corpus, valid_utts)
        stages["ivector_s"] = time.perf_counter() - t_stage
    if args.tied_tree_pdfs > 0:
        t_stage = time.perf_counter()
        tied_tree_stage(args, corpus)
        stages["tree_s"] = time.perf_counter() - t_stage

    model, cfg = _build_model(args, corpus.tree.num_pdfs, args.feat_dim, device)
    left, right = cfg.context
    fsf = cfg.frame_subsampling_factor
    print(
        f"[stage 1] dataset: chunk={args.chunk_frames} ctx=({left},{right})"
        + (" e2e/flat-start" if args.e2e else "")
    )
    sup_opts = SupervisionOptions(
        left_tolerance=args.left_tolerance,
        right_tolerance=args.right_tolerance,
        frame_subsampling_factor=fsf,
    )

    def e2e_dataset():
        return E2eChainDataset(
            corpus.utts, corpus.tree, corpus.norm_fst, chunk_frames_out=args.chunk_frames,
            left_context=left, right_context=right, frame_subsampling_factor=fsf,
            seed=args.seed,
        )

    def chain_dataset():
        return ChainDataset(
            corpus.utts, corpus.tree, corpus.norm_fst, chunk_frames_out=args.chunk_frames,
            left_context=left, right_context=right, sup_opts=sup_opts, seed=args.seed,
        )

    e2e = args.e2e and not args.flat_start_ladder
    if e2e:
        dataset = e2e_dataset()
        n_records = len(corpus.utts)  # about one chunk an utterance
    else:
        dataset = chain_dataset()
        n_records = len(dataset.chunks)
    egs = egs_stage(args, dataset, stages)
    t_stage = time.perf_counter()
    # the phone LM and tree offer the de Bruijn lift on the card (a triphone
    # tree's right context rules it out)
    den = auto_den_graph(corpus.den_graph, device=device, phone_lm=corpus.phone_lm,
                         tree=corpus.tree)
    stages["den_s"] = time.perf_counter() - t_stage
    print(f"[stage 1] den path: {type(den).__name__}")
    decay = _decay_steps(args, max(1, n_records // args.batch_size))
    trainer = Trainer(model, den, _trainer_config(args, device, args.batch_size, decay),
                      tree=corpus.tree)
    if args.flat_start_ladder:
        from torchain_tpu_torch.data import Utterance
        from torchain_tpu_torch.eval import align_corpus
        from torchain_tpu_torch.train.step import make_forward_fn

        _restore(args, trainer, "ladder 1")
        print("[ladder 1] flat-start e2e training")
        t_stage = time.perf_counter()
        trainer.fit(e2e_dataset(), log_fn=print)
        stages["ladder_e2e_s"] = time.perf_counter() - t_stage
        ladder_steps = int(trainer.state.step)
        print("[ladder 2] forced alignment with the stage-1 model")
        t_stage = time.perf_counter()
        gen = align_corpus(
            make_forward_fn(model), corpus.utts, corpus.tree,
            frame_subsampling_factor=fsf, left_context=left, right_context=right,
        )
        corpus.utts = [
            Utterance(feats=u.feats, alignment=a, utt_id=u.utt_id)
            for u, a in zip(corpus.utts, gen)
        ]
        dataset = chain_dataset()
        stages["ladder_align_s"] = time.perf_counter() - t_stage
        trainer.begin_stage()
        print("[ladder 3] tolerance-lattice training on generated alignments")
    if args.materialize_egs:
        if args.frame_shift_cycle:
            raise SystemExit(
                "--materialize-egs pins the frame shift; drop "
                "--frame-shift-cycle or materialization"
            )
        from torchain_tpu_torch.data import MaterializedBatches

        t_stage = time.perf_counter()
        dataset = MaterializedBatches(
            dataset, args.batch_size,
            process_index=data_rank if data_size > 1 else None,
            process_count=data_size if data_size > 1 else None,
            device=device if args.materialize_egs == "device" else False,
        )
        stages["materialize_s"] = time.perf_counter() - t_stage
        egs.update(materialized=len(dataset), materialized_bytes=dataset.nbytes,
                   materialized_on=args.materialize_egs)
        print(f"[stage 2] materialized {len(dataset)} minibatches "
              f"({dataset.nbytes / 1e6:.0f} MB, {args.materialize_egs})")
    print(f"[stage 2] training {args.model} on {n_records} "
          + ("utterances" if e2e else "chunks"))
    t_stage = time.perf_counter()
    out = _fit(args, trainer, dataset, "stage 2", t0, restore=not args.flat_start_ladder)
    stages["train_s"] = time.perf_counter() - t_stage
    if egs:
        out["egs"] = egs
    if args.flat_start_ladder:
        out["ladder_steps"] = ladder_steps  # the e2e stage's; the rest are stage 3's
    if valid_utts and not e2e:
        valid_ds = ChainDataset(
            valid_utts, corpus.tree, corpus.norm_fst, chunk_frames_out=args.chunk_frames,
            left_context=left, right_context=right, sup_opts=sup_opts,
        )
        vres = trainer.evaluate(valid_ds)
        print(f"[stage 2v] valid: {vres}")
        out["valid_objf"] = vres.objf
    if args.decode and rank == 0:
        posts, forward_s = _posteriors(model, corpus.utts, left, right, fsf)
        out["decode"] = dict(
            utts=len(posts),
            frames=int(sum(y.shape[0] for y in posts)),
            forward_s=forward_s,
        )
        t_stage = time.perf_counter()
        _decode_stages(args, corpus, word_corpus, posts, out)
        stages["decode_s"] = time.perf_counter() - t_stage
    out["timings"]["stages_s"] = stages
    out["den"] = dict(form=type(den).__name__, states=corpus.den_graph.num_states,
                      arcs=corpus.den_graph.num_arcs, pdfs=corpus.tree.num_pdfs)
    _print_line(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
