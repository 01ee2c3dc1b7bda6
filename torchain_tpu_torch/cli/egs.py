"""Chain-egs archive tool: the roles of Kaldi's offline egs binaries
(`nnet3-chain-get-egs`, `-copy-egs`, `-shuffle-egs`, `-merge-egs` and the
implicit validate/info surface — kaldi/src/chainbin/*.cc) over the
binary cegs interchange (data/cegs.py).  The in-process loader (data/loader.py) remains the
primary training path; this tool exists for interchange workflows — e.g.
prepping archives once and training many times, or handing egs to/from a
Kaldi system.

Subcommands:
  get      corpus (synthetic or raw-audio Kaldi dir) -> merged cegs ark
  copy     copy records (optionally a subset / every-nth), re-keying
  shuffle  deterministic seeded permutation of records
  merge    re-merge records into a different minibatch size
  info     per-record and aggregate summary

Usage examples:
  python -m torchain_tpu_torch.cli.egs get --synthetic --batch-size 8 out.ark
  python -m torchain_tpu_torch.cli.egs get --wav-dir data/train --batch-size 32 \\
      --chunk-frames 50 out.ark --scp out.scp
  python -m torchain_tpu_torch.cli.egs shuffle in.ark out.ark --seed 7
  python -m torchain_tpu_torch.cli.egs merge in.ark out.ark --batch-size 64
  python -m torchain_tpu_torch.cli.egs info in.ark
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _cmd_get(args) -> int:
    from torchain_tpu_torch.data import ChainDataset
    from torchain_tpu_torch.data.cegs import dataset_to_cegs
    from torchain_tpu_torch.graphs import SupervisionOptions

    if args.synthetic:
        from torchain_tpu_torch.data import synthetic_dataset

        corpus = synthetic_dataset(
            num_utts=args.num_utts,
            num_phones=args.num_phones,
            feat_dim=args.feat_dim,
            utt_frames_out=(args.chunk_frames, args.chunk_frames + 10),
            seed=args.seed,
        )
        utts, tree, norm = corpus.utts, corpus.tree, corpus.norm_fst
    elif args.wav_dir:
        from torchain_tpu_torch.cli.train import resolve_device
        from torchain_tpu_torch.data.kaldi_compat import load_wav_dir

        # the filterbank runs on --device
        wc = load_wav_dir(args.wav_dir, cmvn=args.cmvn, device=resolve_device(args.device))
        utts, tree, norm = (
            wc.corpus.utts,
            wc.corpus.tree,
            wc.corpus.norm_fst,
        )
    else:
        print("egs get: pass --synthetic or --wav-dir", file=sys.stderr)
        return 2
    dataset = ChainDataset(
        utts,
        tree,
        norm,
        chunk_frames_out=args.chunk_frames,
        left_context=args.left_context,
        right_context=args.right_context,
        sup_opts=SupervisionOptions(
            left_tolerance=args.tolerance, right_tolerance=args.tolerance
        ),
    )
    n = dataset_to_cegs(
        dataset,
        args.output,
        batch_size=args.batch_size,
        compress=args.compress,
        scp_path=args.scp,
        shuffle_seed=args.seed,
    )
    print(f"wrote {n} merged records (B={args.batch_size}) to {args.output}")
    return 0


def _cmd_copy(args) -> int:
    from torchain_tpu_torch.data.cegs import iter_cegs_ark, write_cegs_ark

    out, k = [], 0
    for i, (key, eg) in enumerate(iter_cegs_ark(args.input)):
        if args.every_n > 1 and i % args.every_n != 0:
            continue
        if args.subset and k >= args.subset:
            break
        out.append((args.prefix + key if args.prefix else key, eg))
        k += 1
    write_cegs_ark(args.output, out, compress=args.compress, scp_path=args.scp)
    print(f"copied {k} records to {args.output}")
    return 0


def _cmd_shuffle(args) -> int:
    from torchain_tpu_torch.data.cegs import iter_cegs_ark, write_cegs_ark

    recs = list(iter_cegs_ark(args.input))
    rng = np.random.default_rng(args.seed)
    rng.shuffle(recs)
    write_cegs_ark(args.output, recs, compress=args.compress, scp_path=args.scp)
    print(f"shuffled {len(recs)} records to {args.output}")
    return 0


def _cmd_merge(args) -> int:
    """Re-merge records to a different minibatch size: split each stored
    example into per-sequence (feats, fst) pairs, regroup by
    frames_per_sequence, and rebuild merged examples — the
    nnet3-chain-merge-egs role over already-written archives."""
    from torchain_tpu_torch.data.cegs import (
        _rows_to_batch,
        iter_cegs_ark,
        make_chain_example,
        make_e2e_chain_example,
        split_merged_supervision_fst,
        write_cegs_ark,
    )

    singles = {}  # T_out -> list of (feat [T_in, F], fst, ivec or None)
    label_dim = None
    left_context = 0
    fsf = None
    e2e = None  # archive kind; standard and e2e records cannot mix
    for _key, eg in iter_cegs_ark(args.input):
        sup = eg.outputs[0].supervision
        if e2e is None:
            e2e = sup.is_e2e
        elif e2e != sup.is_e2e:
            print(
                "egs merge: archive mixes standard and e2e records",
                file=sys.stderr,
            )
            return 2
        label_dim = sup.label_dim
        feats = _rows_to_batch(eg.io("input").indexes, eg.io("input").features)
        in_ts = sorted({i[1] for i in eg.io("input").indexes})
        out_ts = sorted({i[1] for i in eg.outputs[0].indexes})
        left_context = -in_ts[0]
        fsf = out_ts[1] - out_ts[0] if len(out_ts) > 1 else 3
        ivecs = None
        if eg.has_io("ivector"):
            iv = eg.io("ivector")
            ivecs = _rows_to_batch(iv.indexes, iv.features)[:, 0, :]
        if sup.is_e2e:
            # flat-start records: the per-sequence pieces ARE the stored
            # cyclic FSTs (nnet3-chain-merge-egs appends e2e_fsts)
            fsts = sup.e2e_fsts
        else:
            fsts = split_merged_supervision_fst(
                sup.fst, sup.num_sequences, sup.frames_per_sequence
            )
        for b in range(sup.num_sequences):
            singles.setdefault(sup.frames_per_sequence, []).append(
                (feats[b], fsts[b], None if ivecs is None else ivecs[b])
            )
    out, n = [], 0
    for t_out in sorted(singles):
        items = singles[t_out]
        for b0 in range(0, len(items) - args.batch_size + 1, args.batch_size):
            group = items[b0 : b0 + args.batch_size]
            ivecs = None
            if group[0][2] is not None:
                ivecs = np.stack([g[2] for g in group])
            if e2e:
                eg = make_e2e_chain_example(
                    np.stack([g[0] for g in group]),
                    [g[1] for g in group],
                    label_dim,
                    frames_per_sequence=t_out,
                    frame_subsampling_factor=fsf,
                    left_context=left_context,
                    ivectors=ivecs,
                )
            else:
                eg = make_chain_example(
                    np.stack([g[0] for g in group]),
                    [g[1] for g in group],
                    label_dim,
                    frame_subsampling_factor=fsf,
                    left_context=left_context,
                    ivectors=ivecs,
                )
            out.append((f"merged-{n:06d}", eg))
            n += 1
    write_cegs_ark(args.output, out, compress=args.compress, scp_path=args.scp)
    print(f"merged into {n} records of B={args.batch_size} at {args.output}")
    return 0


def _cmd_info(args) -> int:
    from torchain_tpu_torch.data.cegs import iter_cegs_ark

    n = tot_seq = tot_frames = 0
    for key, eg in iter_cegs_ark(args.input):
        sup = eg.outputs[0].supervision
        feat = eg.io("input")
        dim = feat.features.shape[1]
        ivec = ""
        if eg.has_io("ivector"):
            ivec = f" ivector_dim={eg.io('ivector').features.shape[1]}"
        kind = "e2e" if sup.is_e2e else "fst"
        print(
            f"{key}: B={sup.num_sequences} T_out={sup.frames_per_sequence}"
            f" label_dim={sup.label_dim} feat_dim={dim} weight={sup.weight}"
            f" kind={kind}{ivec}"
        )
        n += 1
        tot_seq += sup.num_sequences
        tot_frames += sup.num_sequences * sup.frames_per_sequence
    print(
        f"total: {n} records, {tot_seq} sequences, {tot_frames} output frames"
        f" ({tot_frames * 3 * 0.010:.1f} audio-seconds at fsf=3)"
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="egs", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("get", help="corpus -> merged cegs archive")
    g.add_argument("output")
    g.add_argument("--synthetic", action="store_true")
    g.add_argument("--wav-dir")
    g.add_argument("--cmvn", default="speaker")
    g.add_argument(
        "--device", default="cuda",
        help="with --wav-dir: the torch device of the filterbank (default cuda)",
    )
    g.add_argument("--num-utts", type=int, default=32)
    g.add_argument("--num-phones", type=int, default=20)
    g.add_argument("--feat-dim", type=int, default=40)
    g.add_argument("--chunk-frames", type=int, default=50)
    g.add_argument("--left-context", type=int, default=14)
    g.add_argument("--right-context", type=int, default=14)
    g.add_argument("--tolerance", type=int, default=2)
    g.add_argument("--batch-size", type=int, default=8)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--compress", action="store_true")
    g.add_argument("--scp")
    g.set_defaults(fn=_cmd_get)

    c = sub.add_parser("copy", help="copy/subset records")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--subset", type=int, default=0, help="keep first N")
    c.add_argument("--every-n", type=int, default=1, help="keep every nth")
    c.add_argument("--prefix", default="", help="re-key with prefix")
    c.add_argument("--compress", action="store_true")
    c.add_argument("--scp")
    c.set_defaults(fn=_cmd_copy)

    s = sub.add_parser("shuffle", help="seeded permutation")
    s.add_argument("input")
    s.add_argument("output")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--compress", action="store_true")
    s.add_argument("--scp")
    s.set_defaults(fn=_cmd_shuffle)

    m = sub.add_parser("merge", help="re-merge to a new minibatch size")
    m.add_argument("input")
    m.add_argument("output")
    m.add_argument("--batch-size", type=int, required=True)
    m.add_argument("--compress", action="store_true")
    m.add_argument("--scp")
    m.set_defaults(fn=_cmd_merge)

    i = sub.add_parser("info", help="summarize an archive")
    i.add_argument("input")
    i.set_defaults(fn=_cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
