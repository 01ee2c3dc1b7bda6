"""`auto_den_graph` on the CPU holds a graph to the 16-bit index limit of
the card's denominator kernels (`den_form_indexed`): a graph that K1/K2
(K9f/K9b) would refuse by its sizes takes another form on the CPU too, and
no slot-dense or Moore V of its size is built.  Without that test the CPU
took the resident form of any graph, and a triphone den graph of 62,917
states (K 2, S_pad 63,744) asked it for a 32.5 GB V.

The graphs are built directly with NumPy: a ring of 32,768 states, each
entered by two arcs of distinct pdfs (K 2: K * S_pad = 65,536 slots), and a
graph of 128 states each entered by 512 pdfs (E 65,536 expanded states,
whose Moore V of 32 MiB would fit the V budget; its slot layout clones
each state 255 times)."""

import tracemalloc

import numpy as np
import pytest

pytest.importorskip("jax")

from torchain_tpu.graphs.den_graph import DenGraph as JDenGraph
from torchain_tpu.ops import device_graphs as jdg
from torchain_tpu_torch import kernels
from torchain_tpu_torch.graphs.den_graph import DenGraph
from torchain_tpu_torch.ops import den_resident as tdr
from torchain_tpu_torch.ops import device_graphs as tdg


def _graph(cls, S, in_pdfs):
    """S states; state s entered from s-1-j (mod S) with pdf j for each j of
    `in_pdfs` pdfs, each arc of probability 1/in_pdfs."""
    dst = np.repeat(np.arange(S), in_pdfs)
    src = (dst - 1 - np.tile(np.arange(in_pdfs), S)) % S
    pdf = np.tile(np.arange(in_pdfs), S)
    logw = np.full(S * in_pdfs, -np.log(in_pdfs), np.float32)
    by_src = np.lexsort((dst, src))
    off = np.arange(0, S * in_pdfs + 1, in_pdfs, dtype=np.int32)
    return cls(num_states=S, num_pdfs=in_pdfs, in_src=src.astype(np.int32),
               in_pdf=pdf.astype(np.int32), in_logw=logw, in_offsets=off,
               out_dst=dst[by_src].astype(np.int32), out_pdf=pdf[by_src].astype(np.int32),
               out_logw=logw[by_src], out_offsets=off,
               initial_probs=np.full(S, 1.0 / S, np.float32))


@pytest.fixture
def no_dense_v(monkeypatch):
    """Fail on any slot-dense or Moore V, and on any query of the library."""
    def refuse(*a, **k):
        raise AssertionError("a dense V was built, or the library asked, on the CPU")

    monkeypatch.setattr(tdr.DeviceResidentDenGraph, "_from_layout", staticmethod(refuse))
    monkeypatch.setattr(tdg, "make_dense_den_graph", refuse)
    monkeypatch.setattr(kernels, "entry", refuse)


@pytest.mark.parametrize("S,in_pdfs", [(32768, 2), (128, 512)])
def test_a_graph_past_the_index_limit_takes_the_scan_on_the_cpu(no_dense_v, S, in_pdfs):
    g = _graph(DenGraph, S, in_pdfs)
    S_pad, K = tdr.slot_sizes(g, 128)  # past 2 slots, states are cloned
    assert K * S_pad >= tdr.INDEX16_LIMIT
    assert not tdg.den_form_indexed("resident", (S_pad, K, g.num_pdfs))
    tracemalloc.start()
    try:
        den = tdg.auto_den_graph(g, device="cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert type(den) is tdg.DeviceDenGraph
    assert peak < 64 << 20, peak  # either slot-dense V would take 4 or 8 GiB
    assert den.num_states == S


def test_the_jax_package_takes_the_scan_for_the_ring_on_the_cpu():
    """The JAX package's `auto_den_graph`, off the accelerator, takes its
    sparse scan for the same ring: the V budget refuses the Moore form."""
    den = jdg.auto_den_graph(_graph(JDenGraph, 32768, 2))
    assert type(den) is jdg.DeviceDenGraph


def test_the_index_limit_is_the_cards():
    limit = tdr.INDEX16_LIMIT
    assert tdg.den_form_indexed("resident", (limit // 2 - 128, 2, 80))
    assert not tdg.den_form_indexed("resident", (limit // 2, 2, 80))
    assert tdg.den_form_indexed("dense", (2176, limit - 128))
    assert not tdg.den_form_indexed("dense", (128, limit))


# ---------------------------------------------------------------------------
# the card's shared-memory limit on the CPU: a graph past K1/K2's carried
# state takes the form the card takes, and builds no slot-dense V
# ---------------------------------------------------------------------------


def test_a_graph_of_12k_padded_states_builds_no_slot_dense_v_on_the_cpu(no_dense_v):
    """A ring of 12,288 states entered by two pdfs each: its 24,576 slots
    take 16-bit indices, but K2 would carry 246,032 bytes a sequence, past
    the H100's 232,448, so the card refuses the resident form; on the CPU
    `auto_den_graph` takes the scan too (the Moore V of 1.2 GB is past its
    budget), with host memory under 64 MiB (the slot-dense V would take
    1.2 GB)."""
    g = _graph(DenGraph, 12288, 2)
    sizes = (*tdr.slot_sizes(g, 128), g.num_pdfs)
    assert sizes[:2] == (12288, 2) and tdg.den_form_indexed("resident", sizes)
    assert tdr.carried_bytes(1, *sizes) == 246_032 > tdr.H100_SHARED_LIMIT
    tracemalloc.start()
    try:
        den = tdg.auto_den_graph(g, device="cpu")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert type(den) is tdg.DeviceDenGraph
    assert peak < 64 << 20, peak
    jden = jdg.auto_den_graph(_graph(JDenGraph, 12288, 2))
    assert type(jden) is jdg.DeviceDenGraph


@pytest.mark.parametrize("S,resident", [(11520, True), (11648, False)])
def test_the_cpu_holds_the_resident_form_to_the_cards_limit(monkeypatch, S, resident):
    """At K 2 and P 2, K2's carried state reaches the H100's limit between
    11,520 padded states (230,672 bytes: resident) and 11,648 (233,232:
    not); `den_form_fits` keeps its CPU answer, True, either way."""
    built = []
    monkeypatch.setattr(tdr.DeviceResidentDenGraph, "_from_layout",
                        staticmethod(lambda *a, **k: built.append(a) or "resident"))
    monkeypatch.setattr(tdg, "make_dense_den_graph", lambda *a, **k: pytest.fail("Moore V"))
    g = _graph(DenGraph, S, 2)
    sizes = (*tdr.slot_sizes(g, 128), g.num_pdfs)
    assert tdg.den_form_fits("resident", sizes, "cpu")
    assert (tdr.carried_bytes(1, *sizes) <= tdr.H100_SHARED_LIMIT) == resident
    den = tdg.auto_den_graph(g, device="cpu")
    assert (den == "resident") == resident and len(built) == int(resident)
