"""FST inspection CLI: an `fstinfo`/`fstcompile`-style inspect/convert
surface for the binary OpenFst interchange (fstkit/openfst_io.py), the
counterpart of torchain_tpu/cli/graphs.py's `info` and `convert`.

Subcommands:
  info          summarize any FST (binary VectorFst/ConstFst or fstkit text)
  convert       re-serialize between text and binary / vector and const

Usage examples:
  python -m torchain_tpu_torch.cli.graphs info exp/chain/den.fst
  python -m torchain_tpu_torch.cli.graphs convert in.fst out.fst --fsttype const
  python -m torchain_tpu_torch.cli.graphs convert den.fst den.txt --text
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphs", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
