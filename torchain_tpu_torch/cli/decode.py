"""Standalone decoding CLI: posteriors ark -> transcripts / N-best / WER.

Behavioral reference: the reference recipe's decode stage shells out to
Kaldi binaries separately from training — `latgen-faster-mapped
--acoustic-scale=1.0 HCLG.fst ark:post.ark` followed by
`lattice-best-path` and `compute-wer` (SURVEY.md section 3.4).  This CLI
is that standalone surface for torchain_tpu_torch (a port of
torchain_tpu/cli/decode.py): it consumes a posteriors archive written by
cli.export_posteriors (or any Kaldi-format text/binary ark of
[T, num_pdfs] log-likelihoods) plus graph sources, and emits hypotheses,
optional N-best lists, and WER/PER against a reference.  It reads an ark
and decodes on the host: it needs no card and takes no --device.

Graph sources (all plain text files, but --hclg/--mdl):
  phone mode: --phone-lm (fstkit text acceptor over phones) + a tree
    (--tree Kaldi ContextDependency text, or --num-phones/--context-width
    for the enumerated flavors).
  word mode: adds --lexicon ("word_id phone1 phone2 ..." lines) and a
    word grammar (--word-lm fstkit text, or --transcripts to estimate an
    n-gram from reference word sequences).
  a Kaldi graph: --hclg HCLG.fst (binary or text OpenFst, transition-id
    input labels) with --mdl final.mdl (its TransitionModel maps them to
    pdfs); no graph is built.

Reference/transcript file format: one utterance per line,
"utt_id id1 id2 ..." (integer ids, matching the rest of the framework).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_argparser():
    p = argparse.ArgumentParser(
        "torchain-decode", description="decode a posteriors ark through a "
        "phone or word graph (latgen-faster-mapped + compute-wer roles)"
    )
    p.add_argument("--posteriors", required=True, help="text or binary ark of [T,P] loglikes")
    p.add_argument("--mode", choices=("phone", "word"), default="phone")
    p.add_argument(
        "--hclg",
        help="decode over a REAL Kaldi HCLG.fst (binary/text OpenFst, "
        "transition-id input labels) instead of building a graph; "
        "requires --mdl (nnet3-latgen-faster role)",
    )
    p.add_argument(
        "--mdl",
        help="final.mdl / trans.mdl providing the TransitionModel that "
        "maps --hclg input labels to pdfs",
    )
    p.add_argument(
        "--word-symbols",
        help="words.txt (OpenFst SymbolTable text): hypotheses, CTM rows "
        "and N-best lines print symbols instead of ids, and --ref may "
        "contain symbols",
    )
    # tree sources
    p.add_argument("--tree", help="Kaldi ContextDependency text file (TiedTree import)")
    p.add_argument("--num-phones", type=int, default=0, help="enumerated tree: phone count")
    p.add_argument("--context-width", type=int, default=1, choices=(1, 2))
    # phone mode
    p.add_argument("--phone-lm", help="fstkit text acceptor over phone ids")
    # word mode
    p.add_argument("--lexicon", help="text lexicon: 'word_id phone1 phone2 ...' per line")
    p.add_argument("--word-lm", help="fstkit text acceptor over word ids")
    p.add_argument("--word-lm-order", type=int, default=2)
    p.add_argument("--sil-phone", type=int, default=0)
    p.add_argument("--sil-prob", type=float, default=0.5)
    # decoding options
    p.add_argument("--beam", type=float, default=16.0)
    p.add_argument("--max-active", type=int, default=7000)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.add_argument("--phone-insertion-bonus", type=float, default=0.0)
    p.add_argument("--backend", choices=("auto", "native", "numpy"), default="auto")
    p.add_argument("--nbest", type=int, default=0, help="also emit N-best lists")
    p.add_argument(
        "--mbr", action="store_true",
        help="minimum-Bayes-risk decoding over the pruned lattice instead "
        "of the best path (lattice-mbr-decode / score_mbr.sh role); with "
        "an LMWT sweep, the sweep picks the weight by best path and the "
        "final hypotheses+score are MBR at that weight",
    )
    p.add_argument(
        "--confidence-out",
        help="with --mbr: write per-word sausage confidences "
        "('utt_id c1 c2 ...' lines)",
    )
    # LM rescoring (steps/lmrescore.sh role): subtract the old grammar's
    # scores, add the new one's, both via lattice composition
    p.add_argument(
        "--prune-beam", type=float, default=0.0,
        help="re-prune generated lattices to this beam before any other "
        "lattice consumer (lattice-prune role; 0 disables)",
    )
    p.add_argument("--lm-rescore", help="fstkit text acceptor: NEW grammar to rescore with")
    p.add_argument("--lm-rescore-old", help="fstkit text acceptor: OLD grammar to subtract first")
    p.add_argument("--lm-rescore-scale", type=float, default=1.0)
    # score.sh sweep (needs --ref): best-path at each LMWT in
    # [--lmwt-min, --lmwt-max], report the corpus-best weight
    p.add_argument("--lmwt-min", type=int, default=0)
    p.add_argument("--lmwt-max", type=int, default=0, help="0 disables the sweep")
    p.add_argument("--word-ins-penalty", type=float, default=0.0)
    # outputs / scoring
    p.add_argument("--hyp-out", help="write hypotheses here ('utt_id id...' lines)")
    p.add_argument(
        "--lattice-out",
        help="write beam-pruned lattices as a Kaldi-style text archive "
        "(lattice-copy ark,t: format, graph/acoustic cost pairs)",
    )
    p.add_argument(
        "--ctm-out",
        help="write word time alignments of the lattice best path as a "
        "NIST CTM file (lattice-align-words | nbest-to-ctm role); "
        "--frame-shift sets the output frame period",
    )
    p.add_argument(
        "--frame-shift", type=float, default=0.03,
        help="output frame period in seconds for --ctm-out (input shift "
        "x frame_subsampling_factor; Kaldi chain default 0.03)",
    )
    p.add_argument("--ref", help="reference transcripts for WER/PER scoring")
    p.add_argument(
        "--oracle", action="store_true",
        help="with --ref: also report the lattice ORACLE error rate "
        "(lattice-oracle role — best achievable over all lattice paths)",
    )
    return p


def read_transcripts(
    path: str, sym2id: dict[str, int] | None = None
) -> dict[str, list[int]]:
    out: dict[str, list[int]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if sym2id is not None:
                out[parts[0]] = [
                    sym2id[x] if x in sym2id else int(x) for x in parts[1:]
                ]
            else:
                out[parts[0]] = [int(x) for x in parts[1:]]
    return out


def read_lexicon(path: str):
    prons: dict[int, list[tuple[int, ...]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            w = int(parts[0])
            prons.setdefault(w, []).append(tuple(int(q) for q in parts[1:]))
    return prons


def load_tree(args):
    from torchain_tpu_torch.graphs import ContextTree
    from torchain_tpu_torch.graphs.tied_tree import read_kaldi_tree

    if args.tree:
        with open(args.tree) as f:
            return read_kaldi_tree(f.read())
    if args.num_phones <= 0:
        raise SystemExit("need --tree or --num-phones")
    return ContextTree(args.num_phones, context_width=args.context_width)


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    sweep = args.lmwt_max >= args.lmwt_min > 0
    if sweep and not args.ref:
        raise SystemExit("--lmwt-min/--lmwt-max sweep needs --ref to score")

    import numpy as np

    from torchain_tpu_torch import io as tio
    from torchain_tpu_torch.fstkit import Fst
    from torchain_tpu_torch.eval import (
        make_decoding_graph,
        make_word_decoding_graph,
        viterbi_decode,
        wer,
    )
    from torchain_tpu_torch.eval.lattice import lattice_decode, lattice_nbest

    posts = tio.read_ark(args.posteriors)
    if not posts:
        raise SystemExit(f"no utterances in {args.posteriors}")

    sym2id = id2sym = None
    if args.word_symbols:
        from torchain_tpu_torch.data.kaldi_compat import read_symbol_table

        sym2id = read_symbol_table(args.word_symbols)
        id2sym = {v: k for k, v in sym2id.items()}

    def fmt(ids):
        if id2sym is None:
            return " ".join(map(str, ids))
        return " ".join(id2sym.get(i, str(i)) for i in ids)

    if args.hclg:
        if not args.mdl:
            raise SystemExit("--hclg needs --mdl (transition-id -> pdf map)")
        from torchain_tpu_torch.eval import hclg_decoding_graph
        from torchain_tpu_torch.fstkit.openfst_io import read_openfst
        from torchain_tpu_torch.graphs.transition_model import read_transition_model

        hfst, holab = read_openfst(args.hclg)
        tm = read_transition_model(args.mdl)
        graph = hclg_decoding_graph(hfst, holab, tm)
    elif args.mode == "word":
        tree = load_tree(args)
        if not args.lexicon:
            raise SystemExit("word mode needs --lexicon")
        from torchain_tpu_torch.graphs.hclg import Lexicon

        lex = Lexicon(
            prons=read_lexicon(args.lexicon),
            sil_phone=args.sil_phone,
            sil_prob=args.sil_prob,
        )
        if args.word_lm:
            with open(args.word_lm) as f:
                g = Fst.from_text(f.read())
        elif args.ref:
            from torchain_tpu_torch.data import train_word_lm

            g = train_word_lm(
                list(read_transcripts(args.ref, sym2id).values()),
                order=args.word_lm_order
            )
        else:
            raise SystemExit("word mode needs --word-lm or --ref (to train one)")
        graph = make_word_decoding_graph(g, lex, tree, lm_scale=args.lm_scale)
    else:
        tree = load_tree(args)
        if not args.phone_lm:
            raise SystemExit("phone mode needs --phone-lm")
        with open(args.phone_lm) as f:
            plm = Fst.from_text(f.read())
        graph = make_decoding_graph(plm, tree, lm_scale=args.lm_scale)

    rescore_g = rescore_g_old = None
    if args.lm_rescore:
        with open(args.lm_rescore) as f:
            rescore_g = Fst.from_text(f.read())
        if args.lm_rescore_old:
            with open(args.lm_rescore_old) as f:
                rescore_g_old = Fst.from_text(f.read())
    elif args.lm_rescore_old:
        raise SystemExit("--lm-rescore-old needs --lm-rescore")
    if args.confidence_out and not args.mbr:
        raise SystemExit("--confidence-out needs --mbr")
    if args.oracle and not args.ref:
        raise SystemExit("--oracle needs --ref")

    hyps: dict[str, list[int]] = {}
    nbests: dict[str, list] = {}
    lats: dict[str, object] = {}
    confidences: dict[str, list[float]] = {}
    need_lat = (
        sweep
        or args.nbest > 0
        or bool(args.lattice_out)
        or bool(args.ctm_out)
        or args.mbr
        or args.oracle
        or rescore_g is not None
    )
    for utt, ll in posts.items():
        ll = np.asarray(ll, np.float32) * args.acoustic_scale
        if need_lat:
            # --max-active needs the native generator; under auto a numpy
            # fallback would reject it, so it applies to native only
            lat = lattice_decode(
                graph,
                ll,
                beam=args.beam,
                phone_bonus=args.phone_insertion_bonus,
                backend=args.backend,
                max_active=args.max_active if args.backend == "native" else 0,
            )
            if args.prune_beam > 0:
                from torchain_tpu_torch.eval.lattice import prune_lattice

                lat = prune_lattice(lat, args.prune_beam)
            if rescore_g is not None:
                from torchain_tpu_torch.eval.lattice import lmrescore_lattice

                if rescore_g_old is not None:
                    lat = lmrescore_lattice(
                        lat, rescore_g_old, -args.lm_rescore_scale
                    )
                lat = lmrescore_lattice(lat, rescore_g, args.lm_rescore_scale)
                if lat.num_states == 0:
                    raise SystemExit(
                        f"--lm-rescore grammar rejects every path of {utt}"
                    )
            lats[utt] = lat
            if args.nbest > 0:
                nb = lattice_nbest(lat, args.nbest)
                nbests[utt] = [(seq, float(s)) for seq, s in nb]
            if sweep:
                hyps[utt] = []  # filled from the sweep's best LMWT below
            elif args.mbr:
                from torchain_tpu_torch.eval.lattice import mbr_decode

                res = mbr_decode(lat)
                hyps[utt] = res.words
                confidences[utt] = res.confidences
            elif args.nbest > 0:
                hyps[utt] = nbests[utt][0][0] if nbests[utt] else []
            else:
                from torchain_tpu_torch.eval.lattice import lattice_best_path

                hyps[utt] = lattice_best_path(lat)[0]
        else:
            hyp, _ = viterbi_decode(
                graph,
                ll,
                beam=args.beam,
                backend=args.backend,
                phone_bonus=args.phone_insertion_bonus,
                max_active=args.max_active,
            )
            hyps[utt] = hyp

    if args.lattice_out:
        from torchain_tpu_torch.eval.lattice import write_lattice_ark

        write_lattice_ark(args.lattice_out, lats)
    if args.ctm_out:
        from torchain_tpu_torch.eval.lattice import best_path_ctm, write_ctm

        write_ctm(
            args.ctm_out,
            {
                u: best_path_ctm(lat, frame_shift_s=args.frame_shift)
                for u, lat in lats.items()
            },
            words_txt=id2sym,
        )

    result = {"num_utts": len(hyps)}
    score = None
    if args.ref:
        refs = read_transcripts(args.ref, sym2id)
        common = [u for u in hyps if u in refs]
        missing = [u for u in hyps if u not in refs]
        if missing:
            print(f"# {len(missing)} utts missing from --ref, unscored", file=sys.stderr)
        label = "WER" if args.mode == "word" else "PER"
        if sweep:
            from torchain_tpu_torch.eval.lattice import score_sweep

            best_lmwt, score, best_hyps, by_lmwt = score_sweep(
                [lats[u] for u in common],
                [refs[u] for u in common],
                lmwt_range=range(args.lmwt_min, args.lmwt_max + 1),
                word_insertion_penalty=args.word_ins_penalty,
            )
            for u, h in zip(common, best_hyps):
                hyps[u] = h
            if args.mbr:
                # final decode is MBR at the sweep's winning weight
                from torchain_tpu_torch.eval.lattice import mbr_decode, rescore_lattice

                for u in common + missing:
                    res = mbr_decode(
                        rescore_lattice(lats[u], lm_scale=float(best_lmwt))
                    )
                    hyps[u] = res.words
                    confidences[u] = res.confidences
                score = wer([refs[u] for u in common], [hyps[u] for u in common])
                result["mbr"] = True
            # unscored utts (absent from --ref) still get a decode: their
            # lattice best path at the sweep's winning weight
            from torchain_tpu_torch.eval.lattice import (
                lattice_best_path,
                rescore_lattice,
            )

            for u in missing:
                if args.mbr:
                    continue  # already MBR-decoded above
                hyps[u] = lattice_best_path(
                    rescore_lattice(lats[u], lm_scale=float(best_lmwt))
                )[0]
            for w in sorted(by_lmwt):
                print(f"# {label}_lmwt{w} {by_lmwt[w]:.2f}%", file=sys.stderr)
            result["best_lmwt"] = best_lmwt
        else:
            score = wer([refs[u] for u in common], [hyps[u] for u in common])
        if args.oracle:
            from torchain_tpu_torch.eval import lattice_oracle

            edits = sum(lattice_oracle(lats[u], refs[u])[1] for u in common)
            ref_words = sum(len(refs[u]) for u in common)
            result["oracle_wer"] = round(100.0 * edits / max(ref_words, 1), 4)
            print(f"# oracle {label} {result['oracle_wer']:.2f}%", file=sys.stderr)
        result.update(score)

    if args.confidence_out:
        with open(args.confidence_out, "w") as f:
            for utt, cs in confidences.items():
                f.write(utt + " " + " ".join(f"{c:.4f}" for c in cs) + "\n")
    if args.hyp_out:
        with open(args.hyp_out, "w") as f:
            for utt, hyp in hyps.items():
                f.write(utt + " " + fmt(hyp) + "\n")
    for utt, hyp in hyps.items():
        print(f"{utt} {fmt(hyp)}")
    if args.nbest > 0:
        for utt, nb in nbests.items():
            for i, (seq, s) in enumerate(nb):
                print(f"# nbest {utt} [{i}] {s:.3f} {fmt(seq)}")
    if score is not None:
        label = "WER" if args.mode == "word" else "PER"
        print(f"# {label} {score['wer']:.2f}% {score}", file=sys.stderr)
    print(json.dumps(result), file=sys.stderr)
    result["hyps"] = hyps  # for programmatic callers; not in the JSON line
    return result


if __name__ == "__main__":
    main()
