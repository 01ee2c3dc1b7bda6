"""Graph-building CLI (a port of torchain_tpu/cli/graphs.py): the roles of
Kaldi's graph binaries over this repo's graph stack — `chain-make-den-fst`
([K] chainbin/chain-make-den-fst.cc; SURVEY.md section 3.5 offline prep)
and `ali-to-phones` ([K] bin/ali-to-phones.cc) — plus an
`fstinfo`/`fstcompile`-style inspect/convert surface for the binary
OpenFst interchange.  Host code: it needs no card and takes no --device.

Subcommands:
  make-den-fst   phone alignments -> den.fst + normalization.fst (+ tree)
  ali-to-phones  final.mdl + transition-id alignments -> phone alignments
  info           summarize any FST (binary VectorFst/ConstFst or fstkit text)
  convert        re-serialize between text and binary / vector and const

Usage examples:
  python -m torchain_tpu_torch.cli.graphs ali-to-phones exp/chain/final.mdl \
      exp/chain/ali.1.gz --out data/train/ali.txt --write-lengths
  python -m torchain_tpu_torch.cli.graphs make-den-fst data/train out/ \
      --context-width 2 --lm-order 4 --lm-extra-states 2000
  python -m torchain_tpu_torch.cli.graphs info out/den.fst
  python -m torchain_tpu_torch.cli.graphs convert in.fst out.fst --fsttype const
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _load_any_fst(path: str):
    """Read binary OpenFst or fstkit text format; returns (Fst, fsttype,
    arctype)."""
    from torchain_tpu_torch.fstkit.openfst_io import read_openfst_raw, to_fstkit

    try:
        raw = read_openfst_raw(path)
        fst, _finals = to_fstkit(raw)
        return fst, raw.fsttype, raw.arctype
    except ValueError:
        from torchain_tpu_torch.fstkit.fst import Fst

        return Fst.from_text(open(path).read()), "text", "standard"


def _cmd_make_den_fst(args) -> int:
    from torchain_tpu_torch.data.kaldi_compat import read_alignments
    from torchain_tpu_torch.fstkit.openfst_io import from_fstkit, write_openfst_raw
    from torchain_tpu_torch.graphs.den_graph import (
        compile_den_graph,
        make_den_fst,
        make_normalization_fst,
    )
    from torchain_tpu_torch.graphs.phone_lm import PhoneLmOptions, estimate_phone_lm
    from torchain_tpu_torch.graphs.topology import ContextTree

    data = pathlib.Path(args.data_dir)
    alis = read_alignments(str(data / "ali.txt"))
    if not alis:
        print(f"no alignments in {data}/ali.txt", file=sys.stderr)
        return 2
    sents = [[p for p, _d in ali] for ali in alis.values()]
    num_phones = args.num_phones or max(max(s) for s in sents)
    lm = estimate_phone_lm(
        sents,
        PhoneLmOptions(
            ngram_order=args.lm_order, num_extra_lm_states=args.lm_extra_states
        ),
    )
    tree = ContextTree(num_phones, context_width=args.context_width)
    den_fst = make_den_fst(lm, tree)
    graph = compile_den_graph(den_fst, tree.num_pdfs)
    norm = make_normalization_fst(den_fst, graph.initial_probs)
    out = pathlib.Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_openfst_raw(
        str(out / "den.fst"), from_fstkit(den_fst, arctype="standard")
    )
    write_openfst_raw(
        str(out / "normalization.fst"), from_fstkit(norm, arctype="standard")
    )
    (out / "tree.json").write_text(
        json.dumps(
            dict(
                kind="context_tree",
                num_phones=num_phones,
                context_width=args.context_width,
                num_pdfs=tree.num_pdfs,
            )
        )
    )
    print(
        f"den.fst: {den_fst.num_states} states / {den_fst.num_arcs} arcs, "
        f"{tree.num_pdfs} pdfs; wrote den.fst normalization.fst tree.json "
        f"to {out}"
    )
    return 0


def _cmd_info(args) -> int:
    fst, fsttype, arctype = _load_any_fst(args.input)
    n_final = sum(1 for s in range(fst.num_states) if fst.is_final(s))
    n_eps = sum(1 for _s, a in fst.all_arcs() if a.label == 0)
    labels = {a.label for _s, a in fst.all_arcs()}
    print(f"path        {args.input}")
    print(f"fst type    {fsttype}")
    print(f"arc type    {arctype}")
    print(f"# states    {fst.num_states}")
    print(f"# arcs      {fst.num_arcs}")
    print(f"# final     {n_final}")
    print(f"# eps arcs  {n_eps}")
    print(f"max label   {max(labels) if labels else 0}")
    return 0


def _cmd_convert(args) -> int:
    from torchain_tpu_torch.fstkit.openfst_io import from_fstkit, write_openfst_raw

    fst, _fsttype, arctype = _load_any_fst(args.input)
    if args.text:
        with open(args.output, "w") as f:
            f.write(fst.to_text())
    else:
        write_openfst_raw(
            args.output,
            from_fstkit(fst, arctype=args.arctype or arctype),
            fsttype=args.fsttype,
            aligned=args.aligned,
        )
    print(f"wrote {args.output}")
    return 0


def _cmd_ali_to_phones(args) -> int:
    from torchain_tpu_torch.graphs.transition_model import (
        read_ali_ark,
        read_transition_model,
    )

    tm = read_transition_model(args.model)
    alis = {}
    for ark in args.ali:
        alis.update(read_ali_ark(ark))
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        for utt, tids in alis.items():
            segs = tm.ali_to_phones(tids, reorder=not args.no_reorder)
            if args.write_lengths:
                body = " ; ".join(f"{p} ,{d}" for p, d in segs)
            else:
                body = " ".join(f"{p}:{d}" for p, d in segs)
            out.write(f"{utt} {body}\n")
    finally:
        if args.out:
            out.close()
    print(
        f"ali-to-phones: {len(alis)} utterances"
        + (f" -> {args.out}" if args.out else ""),
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphs", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser(
        "make-den-fst", help="alignments -> den.fst + normalization.fst"
    )
    d.add_argument("data_dir", help="dir containing ali.txt")
    d.add_argument("output_dir")
    d.add_argument("--num-phones", type=int, default=0)
    d.add_argument("--context-width", type=int, default=2, choices=(1, 2))
    d.add_argument("--lm-order", type=int, default=4)
    d.add_argument("--lm-extra-states", type=int, default=2000)
    d.set_defaults(fn=_cmd_make_den_fst)

    i = sub.add_parser("info", help="summarize an FST")
    i.add_argument("input")
    i.set_defaults(fn=_cmd_info)

    c = sub.add_parser("convert", help="re-serialize an FST")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--text", action="store_true", help="write fstkit text")
    c.add_argument("--fsttype", choices=("vector", "const"), default=None)
    c.add_argument("--arctype", default=None)
    c.add_argument("--aligned", action="store_true")
    c.set_defaults(fn=_cmd_convert)

    a = sub.add_parser(
        "ali-to-phones",
        help="final.mdl + Kaldi transition-id alignment archives -> "
        "phone/duration alignments (ali-to-phones role; output feeds "
        "load_kaldi_dir / make-den-fst directly)",
    )
    a.add_argument("model", help="final.mdl / trans.mdl (binary or text)")
    a.add_argument("ali", nargs="+", help="ali archives (ark/txt/.gz)")
    a.add_argument("--out", help="output path (default stdout)")
    a.add_argument(
        "--write-lengths", action="store_true",
        help="emit 'utt p ,d ; p ,d' lines (ali-to-phones "
        "--write-lengths=true format) instead of 'utt p:d p:d'",
    )
    a.add_argument(
        "--no-reorder", action="store_true",
        help="alignment graphs were built with --reorder=false",
    )
    a.set_defaults(fn=_cmd_ali_to_phones)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
