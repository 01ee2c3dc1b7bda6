"""Kaldi HmmTopology / TransitionModel interchange + the ali-to-phones role
(a copy of torchain_tpu/graphs/transition_model.py, which imports no JAX).

Behavioral reference: [K] hmm/hmm-topology.{h,cc}, [K] hmm/transition-model.{h,cc}
and [K] bin/ali-to-phones.cc.  A real Kaldi chain prep arrives with
`final.mdl` (TransitionModel + nnet — we read the TransitionModel prefix)
and `ali.*.gz` archives of TRANSITION-ID alignments; this module converts
them to the phone-level (phone, duration) alignments the rest of the
framework consumes (`data/kaldi_compat.read_alignments`), removing the
last Kaldi-binary dependency (`ali-to-phones`) from the real-corpus path.

Transition-id numbering (transition-model.cc ComputeDerived): tuples
(phone, hmm_state, forward_pdf, self_loop_pdf) define transition STATES
1..N in tuple order; each owns `len(topology_entry[hmm_state].transitions)`
consecutive transition IDs starting at `state2id[s]`, with IDs starting
at 1.  A transition's pdf is the tuple's self_loop_pdf when it loops on
its own hmm_state, else the forward_pdf.

Provenance caveat (same as the other binary interchange modules): byte
fidelity is pinned by self-written golden fixtures — the reference mount
is empty and there is no network.  On first contact with a real Kaldi
system run the JAX package's `tools/crosscheck_kaldi.py --mdl final.mdl
--ali ali.1.gz` (the port has no counterpart of that tool yet).
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io
import struct
from typing import BinaryIO, Iterable

import numpy as np

from torchain_tpu_torch.utils.kaldi_io import (
    expect_binary_marker,
    expect_token,
    read_basic_float,
    read_basic_int32,
    read_float_vector,
    read_integer_vector,
    read_token,
    write_basic_float,
    write_basic_int32,
    write_binary_marker,
    write_float_vector,
    write_integer_vector,
    write_token,
)

NO_PDF = -1  # kaldi kNoPdf


@dataclasses.dataclass
class HmmState:
    """One state of a topology entry ([K] hmm-topology.h HmmState)."""

    forward_pdf_class: int = NO_PDF
    self_loop_pdf_class: int = NO_PDF
    #: (next_state, initial_prob) pairs
    transitions: list[tuple[int, float]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class HmmTopology:
    """Per-phone HMM prototypes ([K] hmm/hmm-topology.h)."""

    phones: list[int]  # sorted
    phone2idx: list[int]  # indexed by phone; -1 = absent
    entries: list[list[HmmState]]

    def entry_for(self, phone: int) -> list[HmmState]:
        if phone <= 0 or phone >= len(self.phone2idx) or self.phone2idx[phone] < 0:
            raise ValueError(f"phone {phone} not covered by topology")
        return self.entries[self.phone2idx[phone]]

    @classmethod
    def chain(cls, phones: Iterable[int]) -> "HmmTopology":
        """The 1-emitting-state 'chain' topology (forward pdf-class 0 on
        the entry transition, self-loop pdf-class 1), shared by all
        phones — the topology chain recipes generate.

        Transition ORDER matters: transition-id numbering is derived from
        it (tids 2p-1, 2p per phone p).  Kaldi's
        steps/nnet3/chain/gen_topo.py emits ``<Transition> 0 0.5
        <Transition> 1 0.5`` — the SELF-LOOP first, then the forward
        transition — so tid 2p-1 is the self-loop and 2p the forward
        transition, and we match that here.  This ordering is pinned from
        training-data recall of gen_topo.py, not a verified artifact
        (reference mount empty): on first real-system contact verify with
        the JAX package's ``tools/crosscheck_kaldi.py --mdl final.mdl`` (models READ from a
        real final.mdl are unaffected either way — their order comes from
        the file)."""
        phones = sorted(set(int(p) for p in phones))
        if not phones or phones[0] <= 0:
            raise ValueError("phones must be positive")
        entry = [
            HmmState(0, 1, [(0, 0.5), (1, 0.5)]),
            HmmState(NO_PDF, NO_PDF, []),
        ]
        phone2idx = [-1] * (max(phones) + 1)
        for p in phones:
            phone2idx[p] = 0
        return cls(phones=phones, phone2idx=phone2idx, entries=[entry])

    # -- binary IO (format of [K] hmm-topology.cc Write/Read) --------------

    def is_hmm(self) -> bool:
        """[K] hmm-topology.cc IsHmm(): true iff every state has
        forward_pdf_class == self_loop_pdf_class (chain topologies are
        NOT HMM: forward 0, self-loop 1)."""
        return all(
            st.forward_pdf_class == st.self_loop_pdf_class
            for entry in self.entries
            for st in entry
        )

    def write_binary(self, f: BinaryIO) -> None:
        """[K] hmm-topology.cc Write: for non-HMM topologies (the
        extended format with separate self-loop pdf-classes — every chain
        topology) an int32 -1 sentinel precedes the entry count and
        self_loop_pdf_class is written per state; HMM topologies omit
        both, so a 1990s-era reader still parses them."""
        write_token(f, "<Topology>")
        write_integer_vector(f, self.phones)
        write_integer_vector(f, self.phone2idx)
        is_hmm = self.is_hmm()
        if not is_hmm:
            write_basic_int32(f, -1)
        write_basic_int32(f, len(self.entries))
        for entry in self.entries:
            write_basic_int32(f, len(entry))
            for st in entry:
                write_basic_int32(f, st.forward_pdf_class)
                if not is_hmm:
                    write_basic_int32(f, st.self_loop_pdf_class)
                write_basic_int32(f, len(st.transitions))
                for nxt, prob in st.transitions:
                    write_basic_int32(f, nxt)
                    write_basic_float(f, prob)
        write_token(f, "</Topology>")

    @classmethod
    def read_binary(cls, f: BinaryIO) -> "HmmTopology":
        expect_token(f, "<Topology>")
        phones = read_integer_vector(f)
        phone2idx = read_integer_vector(f)
        sz = read_basic_int32(f)
        is_hmm = True
        if sz == -1:  # extended-format flag ([K] hmm-topology.cc Read)
            is_hmm = False
            sz = read_basic_int32(f)
        entries = []
        for _ in range(sz):
            entry = []
            for _ in range(read_basic_int32(f)):
                fwd = read_basic_int32(f)
                slf = fwd if is_hmm else read_basic_int32(f)
                trans = []
                for _ in range(read_basic_int32(f)):
                    nxt = read_basic_int32(f)
                    prob = read_basic_float(f)
                    trans.append((nxt, prob))
                entry.append(HmmState(fwd, slf, trans))
            entries.append(entry)
        expect_token(f, "</Topology>")
        return cls(phones=phones, phone2idx=phone2idx, entries=entries)

    # -- text IO (the <TopologyEntry> form chain recipes generate) ---------

    def write_text(self) -> str:
        out = ["<Topology>"]
        # group phones by entry index, preserving entry order
        by_idx: dict[int, list[int]] = {}
        for p in self.phones:
            by_idx.setdefault(self.phone2idx[p], []).append(p)
        for idx, entry in enumerate(self.entries):
            out.append("<TopologyEntry>")
            out.append("<ForPhones>")
            out.append(" ".join(str(p) for p in by_idx.get(idx, [])))
            out.append("</ForPhones>")
            for j, st in enumerate(entry):
                parts = [f"<State> {j}"]
                if st.forward_pdf_class != NO_PDF:
                    if st.forward_pdf_class == st.self_loop_pdf_class:
                        parts.append(f"<PdfClass> {st.forward_pdf_class}")
                    else:
                        parts.append(
                            f"<ForwardPdfClass> {st.forward_pdf_class} "
                            f"<SelfLoopPdfClass> {st.self_loop_pdf_class}"
                        )
                for nxt, prob in st.transitions:
                    parts.append(f"<Transition> {nxt} {prob}")
                parts.append("</State>")
                out.append(" ".join(parts))
            out.append("</TopologyEntry>")
        out.append("</Topology>")
        return "\n".join(out) + "\n"

    @classmethod
    def read_text(cls, toks: "_TokenStream") -> "HmmTopology":
        toks.expect("<Topology>")
        entries: list[list[HmmState]] = []
        entry_phones: list[list[int]] = []
        while True:
            t = toks.next()
            if t == "</Topology>":
                break
            if t != "<TopologyEntry>":
                raise ValueError(f"expected <TopologyEntry>, got {t!r}")
            toks.expect("<ForPhones>")
            phones_here = []
            while True:
                t = toks.next()
                if t == "</ForPhones>":
                    break
                phones_here.append(int(t))
            entry: list[HmmState] = []
            while True:
                t = toks.next()
                if t == "</TopologyEntry>":
                    break
                if t != "<State>":
                    raise ValueError(f"expected <State>, got {t!r}")
                j = int(toks.next())
                if j != len(entry):
                    raise ValueError(f"non-sequential state {j} in topology")
                st = HmmState()
                while True:
                    t = toks.next()
                    if t == "</State>":
                        break
                    if t == "<PdfClass>":
                        st.forward_pdf_class = st.self_loop_pdf_class = int(toks.next())
                    elif t == "<ForwardPdfClass>":
                        st.forward_pdf_class = int(toks.next())
                    elif t == "<SelfLoopPdfClass>":
                        st.self_loop_pdf_class = int(toks.next())
                    elif t == "<Transition>":
                        nxt = int(toks.next())
                        prob = float(toks.next())
                        st.transitions.append((nxt, prob))
                    else:
                        raise ValueError(f"unexpected token {t!r} in <State>")
                entry.append(st)
            entries.append(entry)
            entry_phones.append(phones_here)
        phones = sorted(p for ps in entry_phones for p in ps)
        phone2idx = [-1] * (max(phones) + 1 if phones else 1)
        for idx, ps in enumerate(entry_phones):
            for p in ps:
                phone2idx[p] = idx
        return cls(phones=phones, phone2idx=phone2idx, entries=entries)


class _TokenStream:
    def __init__(self, text: str):
        self._toks = text.split()
        self._i = 0

    def next(self) -> str:
        if self._i >= len(self._toks):
            raise ValueError("unexpected end of Kaldi text stream")
        t = self._toks[self._i]
        self._i += 1
        return t

    def peek(self) -> str:
        return self._toks[self._i] if self._i < len(self._toks) else ""

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise ValueError(f"expected {tok!r}, got {got!r}")


@dataclasses.dataclass
class TransitionModel:
    """[K] hmm/transition-model.h: topology + (phone, hmm-state, pdf)
    tuples + transition log-probs, with the derived transition-id maps."""

    topo: HmmTopology
    #: (phone, hmm_state, forward_pdf, self_loop_pdf) per transition state
    tuples: list[tuple[int, int, int, int]]
    #: log transition probs, 1-indexed by transition id (entry 0 unused)
    log_probs: np.ndarray

    # derived (built in __post_init__)
    state2id: np.ndarray = dataclasses.field(init=False)
    id2state: np.ndarray = dataclasses.field(init=False)
    id2pdf: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        n = len(self.tuples)
        state2id = np.zeros(n + 2, np.int32)
        state2id[1] = 1
        for s, (phone, hmm_state, _f, _s) in enumerate(self.tuples, start=1):
            entry = self.topo.entry_for(phone)
            state2id[s + 1] = state2id[s] + len(entry[hmm_state].transitions)
        num_ids = int(state2id[n + 1]) - 1
        id2state = np.zeros(num_ids + 1, np.int32)
        id2pdf = np.full(num_ids + 1, NO_PDF, np.int32)
        for s, (phone, hmm_state, fwd, slf) in enumerate(self.tuples, start=1):
            entry = self.topo.entry_for(phone)
            for ti, (nxt, _prob) in enumerate(entry[hmm_state].transitions):
                tid = int(state2id[s]) + ti
                id2state[tid] = s
                id2pdf[tid] = slf if nxt == hmm_state else fwd
        self.state2id = state2id
        self.id2state = id2state
        self.id2pdf = id2pdf

    # -- queries ------------------------------------------------------------

    @property
    def num_transition_ids(self) -> int:
        return len(self.id2state) - 1

    @property
    def num_pdfs(self) -> int:
        m = -1
        for _p, _h, f, s in self.tuples:
            m = max(m, f, s)
        return m + 1

    def transition_id_to_pdf(self, tid: int) -> int:
        return int(self.id2pdf[tid])

    def transition_id_to_phone(self, tid: int) -> int:
        return self.tuples[int(self.id2state[tid]) - 1][0]

    def transition_id_to_hmm_state(self, tid: int) -> int:
        return self.tuples[int(self.id2state[tid]) - 1][1]

    def is_self_loop(self, tid: int) -> bool:
        s = int(self.id2state[tid])
        phone, hmm_state, _f, _s = self.tuples[s - 1]
        ti = tid - int(self.state2id[s])
        nxt = self.topo.entry_for(phone)[hmm_state].transitions[ti][0]
        return nxt == hmm_state

    def is_final(self, tid: int) -> bool:
        """True when the transition enters the entry's (non-emitting)
        final state — the [K] hmm-utils.cc SplitToPhones phone-boundary
        test."""
        s = int(self.id2state[tid])
        phone, hmm_state, _f, _s = self.tuples[s - 1]
        entry = self.topo.entry_for(phone)
        nxt = entry[hmm_state].transitions[tid - int(self.state2id[s])][0]
        return entry[nxt].forward_pdf_class == NO_PDF

    def ali_to_phones(
        self, alignment: Iterable[int], reorder: bool = True
    ) -> list[tuple[int, int]]:
        """Transition-id alignment -> (phone, duration) pairs — the
        [K] bin/ali-to-phones.cc --write-lengths role (SplitToPhones).

        `reorder` names the convention the training graph was built with
        ([K] hmm-utils.h AddSelfLoops --reorder, default TRUE everywhere
        in modern recipes incl. chain): each emitting state's forward
        transition precedes its self-loops, so a phone instance STARTS at
        a non-self-loop transition out of hmm-state 0.  With
        reorder=False (classic order) an instance ENDS at the transition
        into the entry's final state."""
        out: list[tuple[int, int]] = []
        cur_phone, cur_len = 0, 0
        for tid in alignment:
            tid = int(tid)
            if tid < 1 or tid > self.num_transition_ids:
                raise ValueError(f"transition id {tid} out of range")
            phone = self.transition_id_to_phone(tid)
            starts = (
                reorder
                and self.transition_id_to_hmm_state(tid) == 0
                and not self.is_self_loop(tid)
            )
            if cur_len and (phone != cur_phone or starts):
                out.append((cur_phone, cur_len))
                cur_phone, cur_len = phone, 1
            else:
                cur_phone = phone
                cur_len += 1
            if not reorder and self.is_final(tid):
                out.append((cur_phone, cur_len))
                cur_phone, cur_len = 0, 0
        if cur_len:
            out.append((cur_phone, cur_len))
        return out

    def ali_to_pdfs(self, alignment: Iterable[int]) -> list[int]:
        """[K] bin/ali-to-pdf.cc role."""
        return [self.transition_id_to_pdf(int(t)) for t in alignment]

    # -- binary IO ([K] transition-model.cc Write/Read) ---------------------

    def write_binary(self, f: BinaryIO) -> None:
        write_token(f, "<TransitionModel>")
        self.topo.write_binary(f)
        # [K] transition-model.cc keys <Triples>/<Tuples> off
        # HmmTopology::IsHmm(), NOT off whether the pdfs happen to
        # coincide — a non-HMM topology always writes <Tuples>.
        triples = self.topo.is_hmm()
        write_token(f, "<Triples>" if triples else "<Tuples>")
        write_basic_int32(f, len(self.tuples))
        for phone, hmm_state, fwd, slf in self.tuples:
            write_basic_int32(f, phone)
            write_basic_int32(f, hmm_state)
            write_basic_int32(f, fwd)
            if not triples:
                write_basic_int32(f, slf)
        write_token(f, "</Triples>" if triples else "</Tuples>")
        write_token(f, "<LogProbs>")
        write_float_vector(f, np.asarray(self.log_probs, np.float32))
        write_token(f, "</LogProbs>")
        write_token(f, "</TransitionModel>")

    @classmethod
    def read_binary(cls, f: BinaryIO) -> "TransitionModel":
        expect_token(f, "<TransitionModel>")
        topo = HmmTopology.read_binary(f)
        tok = read_token(f)
        if tok not in ("<Triples>", "<Tuples>"):
            raise ValueError(f"expected <Triples>/<Tuples>, got {tok!r}")
        triples = tok == "<Triples>"
        tuples = []
        for _ in range(read_basic_int32(f)):
            phone = read_basic_int32(f)
            hmm_state = read_basic_int32(f)
            fwd = read_basic_int32(f)
            slf = fwd if triples else read_basic_int32(f)
            tuples.append((phone, hmm_state, fwd, slf))
        expect_token(f, "</Triples>" if triples else "</Tuples>")
        expect_token(f, "<LogProbs>")
        log_probs = read_float_vector(f)
        expect_token(f, "</LogProbs>")
        expect_token(f, "</TransitionModel>")
        return cls(topo=topo, tuples=tuples, log_probs=log_probs)

    # -- text IO -------------------------------------------------------------

    def write_text(self) -> str:
        out = ["<TransitionModel>"]
        out.append(self.topo.write_text().rstrip("\n"))
        triples = self.topo.is_hmm()
        out.append("<Triples>" if triples else "<Tuples>")
        out.append(str(len(self.tuples)))
        for phone, hmm_state, fwd, slf in self.tuples:
            row = [phone, hmm_state, fwd] + ([] if triples else [slf])
            out.append(" ".join(map(str, row)))
        out.append("</Triples>" if triples else "</Tuples>")
        lp = " ".join(repr(float(v)) for v in np.asarray(self.log_probs))
        out.append(f"<LogProbs>\n [ {lp} ]\n</LogProbs>")
        out.append("</TransitionModel>")
        return "\n".join(out) + "\n"

    @classmethod
    def read_text(cls, text: str) -> "TransitionModel":
        toks = _TokenStream(text)
        toks.expect("<TransitionModel>")
        topo = HmmTopology.read_text(toks)
        tok = toks.next()
        if tok not in ("<Triples>", "<Tuples>"):
            raise ValueError(f"expected <Triples>/<Tuples>, got {tok!r}")
        triples = tok == "<Triples>"
        n = int(toks.next())
        tuples = []
        for _ in range(n):
            phone = int(toks.next())
            hmm_state = int(toks.next())
            fwd = int(toks.next())
            slf = fwd if triples else int(toks.next())
            tuples.append((phone, hmm_state, fwd, slf))
        toks.expect("</Triples>" if triples else "</Tuples>")
        toks.expect("<LogProbs>")
        toks.expect("[")
        vals = []
        while True:
            t = toks.next()
            if t == "]":
                break
            vals.append(float(t))
        toks.expect("</LogProbs>")
        toks.expect("</TransitionModel>")
        return cls(topo=topo, tuples=tuples, log_probs=np.asarray(vals, np.float32))


def read_transition_model(path: str) -> TransitionModel:
    """Read a TransitionModel from a Kaldi model file (`final.mdl` /
    `trans.mdl`, binary or text; .mdl files may carry a trailing nnet,
    which is left unread)."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x00B":
            expect_binary_marker(f)
            return TransitionModel.read_binary(f)
        text = f.read().decode()
    # text model: parse only up to </TransitionModel>
    end = text.find("</TransitionModel>")
    if end < 0:
        raise ValueError(f"{path}: no </TransitionModel> found")
    return TransitionModel.read_text(text[: end + len("</TransitionModel>")])


def write_transition_model(path: str, tm: TransitionModel, binary: bool = True) -> None:
    with open(path, "wb") as f:
        if binary:
            write_binary_marker(f)
            tm.write_binary(f)
        else:
            f.write(tm.write_text().encode())


def chain_transition_model(
    num_phones: int, phone_to_pdfs: "dict[int, tuple[int, int]] | None" = None
) -> TransitionModel:
    """Build the chain-topology TransitionModel: one tuple per phone with
    (forward_pdf, self_loop_pdf).  Without an explicit map, pdfs are
    numbered (2p-2, 2p-1) per phone p — the monophone chain layout."""
    topo = HmmTopology.chain(range(1, num_phones + 1))
    tuples = []
    for p in range(1, num_phones + 1):
        fwd, slf = (
            phone_to_pdfs[p] if phone_to_pdfs else (2 * (p - 1), 2 * (p - 1) + 1)
        )
        tuples.append((p, 0, fwd, slf))
    # uniform 0.5/0.5 transition probs, 1-indexed over 2 ids per phone
    n_ids = 2 * num_phones
    lp = np.full(n_ids + 1, np.log(0.5), np.float32)
    lp[0] = 0.0
    return TransitionModel(topo=topo, tuples=tuples, log_probs=lp)


# ---------------------------------------------------------------------------
# alignment archives ([K] Int32VectorWriter format; ali.JOB.gz)
# ---------------------------------------------------------------------------


def _open_maybe_gz(path: str) -> BinaryIO:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb")


def read_ali_ark(path: str) -> dict[str, list[int]]:
    """Read a Kaldi alignment archive (text or binary, optionally .gz):
    `utt_id tid tid ...` per record — the `ark:gunzip -c ali.1.gz|` input
    of [K] bin/ali-to-phones.cc."""
    out: dict[str, list[int]] = {}
    with _open_maybe_gz(path) as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos < n:
        # skip whitespace between records
        while pos < n and data[pos : pos + 1] in (b" ", b"\n", b"\t", b"\r"):
            pos += 1
        if pos >= n:
            break
        sp = data.find(b" ", pos)
        if sp < 0:
            raise ValueError(f"{path}: truncated archive key at byte {pos}")
        key = data[pos:sp].decode()
        pos = sp + 1
        if data[pos : pos + 2] == b"\x00B":
            f2 = _io.BytesIO(data[pos + 2 :])
            vec = read_integer_vector(f2)
            pos = pos + 2 + f2.tell()
        else:
            nl = data.find(b"\n", pos)
            if nl < 0:
                nl = n
            toks = data[pos:nl].split()
            vec = [int(t) for t in toks]
            pos = nl + 1
        out[key] = vec
    return out


def write_ali_ark(
    path: str, alis: dict[str, list[int]], binary: bool = True
) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:  # type: ignore[arg-type]
        for key, vec in alis.items():
            f.write(key.encode() + b" ")
            if binary:
                f.write(b"\x00B")
                write_integer_vector(f, [int(v) for v in vec])
            else:
                f.write((" ".join(str(int(v)) for v in vec) + "\n").encode())
