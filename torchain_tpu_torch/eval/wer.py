"""Word/phone error rate scoring (compute-wer parity); a copy of
torchain_tpu/eval/wer.py."""

from __future__ import annotations


def edit_distance(ref: list, hyp: list) -> tuple[int, int, int, int]:
    """Levenshtein alignment; returns (substitutions, deletions,
    insertions, total_edits)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, ins)
    prev = [(j, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0)] + [None] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur[j] = prev[j - 1]
            else:
                sub = (prev[j - 1][0] + 1, prev[j - 1][1] + 1, prev[j - 1][2], prev[j - 1][3])
                dele = (prev[j][0] + 1, prev[j][1], prev[j][2] + 1, prev[j][3])
                ins = (cur[j - 1][0] + 1, cur[j - 1][1], cur[j - 1][2], cur[j - 1][3] + 1)
                cur[j] = min(sub, dele, ins)
        prev = cur
    cost, subs, dels, ins = prev[m]
    return subs, dels, ins, cost


def wer(refs: list[list], hyps: list[list]) -> dict:
    """Corpus-level WER with sub/del/ins breakdown (Kaldi compute-wer
    output fields)."""
    if len(refs) != len(hyps):
        raise ValueError("refs/hyps length mismatch")
    tot_err = tot_sub = tot_del = tot_ins = tot_ref = 0
    for r, h in zip(refs, hyps):
        s, d, i, e = edit_distance(list(r), list(h))
        tot_sub += s
        tot_del += d
        tot_ins += i
        tot_err += e
        tot_ref += len(r)
    return dict(
        wer=100.0 * tot_err / max(tot_ref, 1),
        sub=tot_sub,
        dele=tot_del,
        ins=tot_ins,
        errors=tot_err,
        ref_words=tot_ref,
        num_utts=len(refs),
    )
