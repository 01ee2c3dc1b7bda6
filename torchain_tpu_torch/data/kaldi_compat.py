"""Kaldi symbol tables (part of a port of torchain_tpu/data/kaldi_compat.py).

This module is partial: it holds only the OpenFst symbol-table text
format (`phones.txt`, `words.txt`), which `cli.decode --word-symbols`
reads.  The rest of the JAX package's module (Kaldi data directories,
wav, CMVN, transcripts) is not ported yet.
"""

from __future__ import annotations


def read_phone_table(path: str) -> dict[str, int]:
    """phones.txt / words.txt: `symbol id` per line (OpenFst SymbolTable
    text format, as every Kaldi data/lang dir ships)."""
    table: dict[str, int] = {}
    for line in open(path):
        parts = line.split()
        if len(parts) >= 2:
            table[parts[0]] = int(parts[1])
    return table


#: words.txt has the identical format
read_symbol_table = read_phone_table


def write_symbol_table(path: str, table: dict[str, int]) -> None:
    """Write an OpenFst-format symbol table (id-sorted)."""
    with open(path, "w") as f:
        for sym, idx in sorted(table.items(), key=lambda kv: kv[1]):
            f.write(f"{sym} {idx}\n")
