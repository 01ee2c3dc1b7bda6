"""The port's Kaldi binary stream primitives (utils/kaldi_io.py) and matrix
archives (io.py) against the JAX package's: the same bytes from every
writer for the same seeded inputs, and the same arrays from every reader,
exactly (float32 and float64 bit for bit).  The golden fixtures
tests/fixtures/golden_{fm,cm}.ark decode to golden_expected.npz as the JAX
package's reader decodes them."""

import io
import pathlib
import struct

import numpy as np
import pytest

import torchain_tpu.io as jio
import torchain_tpu.utils.kaldi_io as jk
import torchain_tpu_torch.io as tio
import torchain_tpu_torch.utils.kaldi_io as tk

FIX = pathlib.Path(__file__).parent / "fixtures"

#: (writer, value) pairs covering every basic type of utils/kaldi_io.py
WRITES = [
    ("write_token", "<Nnet3ChainEg>"),
    ("write_basic_int32", -123456),
    ("write_basic_float", 0.1),
    ("write_basic_float", -3.5e-20),
    ("write_basic_bool", True),
    ("write_basic_bool", False),
    ("write_integer_vector", []),
    ("write_integer_vector", [3, -1, 2**31 - 1]),
    ("write_float_vector", np.random.default_rng(0).normal(size=7).astype(np.float32)),
    ("write_float_vector", np.zeros(0, np.float32)),
]
READS = {
    "write_token": "read_token", "write_basic_int32": "read_basic_int32",
    "write_basic_float": "read_basic_float", "write_basic_bool": "read_basic_bool",
    "write_integer_vector": "read_integer_vector", "write_float_vector": "read_float_vector",
}


def _bytes(mod, name, value):
    buf = io.BytesIO()
    getattr(mod, name)(buf, value)
    return buf.getvalue()


@pytest.mark.parametrize("name,value", WRITES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(WRITES)])
def test_kaldi_io_writers_give_the_same_bytes_and_read_back(name, value):
    got = _bytes(tk, name, value)
    assert got == _bytes(jk, name, value)
    back_t = getattr(tk, READS[name])(io.BytesIO(got))
    back_j = getattr(jk, READS[name])(io.BytesIO(got))
    if isinstance(value, np.ndarray):
        assert back_t.dtype == back_j.dtype == np.float32
        np.testing.assert_array_equal(back_t, back_j)
        np.testing.assert_array_equal(back_t, value)
    else:
        assert back_t == back_j
        assert back_t == (np.float32(value).item() if isinstance(value, float) else value)


def test_kaldi_io_stream_conventions_match():
    """The marker, PeekToken's skipped '<', a double-width float, a DV
    vector, and the errors of a truncated or malformed stream."""
    stream = (b"\x00B<Supervision> <End2End> X \x08" + struct.pack("<d", 1 / 3)
              + b"DV \x04" + struct.pack("<i", 2) + struct.pack("<2d", 0.25, -1e-3))
    for mod in (tk, jk):
        f = io.BytesIO(stream)
        mod.expect_binary_marker(f)
        assert mod.peek_token_first_char(f) == "S"
        mod.expect_token(f, "<Supervision>")
        assert mod.peek_token_first_char(f) == "E"
        mod.expect_token(f, "<End2End>")
        assert mod.peek_token_first_char(f) == "X"
        assert mod.read_token(f) == "X"
        assert mod.read_basic_float(f) == 1 / 3
        np.testing.assert_array_equal(mod.read_float_vector(f), np.float32([0.25, -1e-3]))
        assert mod.peek_token_first_char(f) == ""
        buf = io.BytesIO()
        mod.write_binary_marker(buf)
        assert buf.getvalue() == b"\x00B"
    for bad, fn, match in [
        (b"\x04\x01\x00", "read_basic_int32", "truncated"),
        (b"\x02\x01\x00", "read_basic_int32", "size byte"),
        (b"Q", "read_basic_bool", "T/F"),
        (b"<A> ", "expect_binary_marker", "marker"),
        (b" ", "read_token", "empty token"),
        (b"\x04" + struct.pack("<i", -5), "read_integer_vector", "implausible"),
        (b"FM ", "read_float_vector", "FV/DV"),
    ]:
        errs = []
        for mod in (tk, jk):
            with pytest.raises(ValueError, match=match) as e:
                getattr(mod, fn)(io.BytesIO(bad))
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="expected token"):
        tk.expect_token(io.BytesIO(b"<B> "), "<A>")


def _mats(seed=0, double=False):
    rng = np.random.default_rng(seed)
    dt = np.float64 if double else np.float32
    return {
        "utt-a": (rng.normal(size=(9, 4)) * 2).astype(dt),
        "utt_b-1": rng.normal(size=(1, 6)).astype(dt),
        "c": (rng.normal(size=(17, 3)) * 5 + 1).astype(dt),
    }


def test_golden_arks_decode_to_the_expected_arrays():
    expected = dict(np.load(FIX / "golden_expected.npz"))
    fm_t = tio.read_ark_binary(str(FIX / "golden_fm.ark"))
    fm_j = jio.read_ark_binary(str(FIX / "golden_fm.ark"))
    assert list(fm_t) == list(fm_j) == list(expected)
    for k, v in expected.items():
        np.testing.assert_array_equal(fm_t[k], v)
        assert fm_t[k].dtype == fm_j[k].dtype
    cm_t = tio.read_ark_binary(str(FIX / "golden_cm.ark"))
    cm_j = jio.read_ark_binary(str(FIX / "golden_cm.ark"))
    for k, v in expected.items():
        np.testing.assert_array_equal(cm_t[k], cm_j[k])
        assert np.abs(cm_t[k] - v).max() <= 0.01 * (v.max() - v.min() + 1e-8)


@pytest.mark.parametrize("kind", ["FM", "DM", "CM"])
def test_binary_ark_writer_gives_the_same_bytes_and_scp(tmp_path, kind):
    mats = _mats(3, double=kind == "DM")
    out = {}
    for side, mod in (("t", tio), ("j", jio)):
        d = tmp_path / side
        d.mkdir()
        ark, scp = str(d / "feats.ark"), str(d / "feats.scp")
        mod.write_ark_binary(ark, mats, compress=kind == "CM", scp_path=scp)
        out[side] = (pathlib.Path(ark).read_bytes(),
                     pathlib.Path(scp).read_text().replace(str(d), "DIR"))
    assert out["t"] == out["j"]
    ark = str(tmp_path / "t" / "feats.ark")
    back_t, back_j = tio.read_ark_binary(ark), jio.read_ark_binary(ark)
    for k in mats:
        assert back_t[k].dtype == back_j[k].dtype
        np.testing.assert_array_equal(back_t[k], back_j[k])
        if kind != "CM":
            np.testing.assert_array_equal(back_t[k], mats[k])
    # random access through the scp index, one ark open for all records
    r = tio.ScpReader(str(tmp_path / "t" / "feats.scp"))
    assert list(r.keys()) == list(mats) and len(r) == 3 and "c" in r and "zz" not in r
    np.testing.assert_array_equal(r["c"], back_t["c"])
    for (k1, v1), (k2, v2) in zip(r.items(), jio.ScpReader(
            str(tmp_path / "t" / "feats.scp")).items()):
        assert k1 == k2
        np.testing.assert_array_equal(v1, v2)


def test_matrix_bodies_of_every_token_decode_alike():
    """FV/DV vectors and the CM2/CM3 formats, built by hand."""
    rng = np.random.default_rng(4)
    bodies = [
        b"FV \x04" + struct.pack("<i", 3) + rng.normal(size=3).astype("<f4").tobytes(),
        b"DV \x04" + struct.pack("<i", 2) + rng.normal(size=2).astype("<f8").tobytes(),
        b"CM2 " + struct.pack("<ffii", -1.5, 3.0, 2, 3)
        + rng.integers(0, 65536, size=6).astype("<u2").tobytes(),
        b"CM3 " + struct.pack("<ffii", 0.5, 2.0, 3, 2)
        + rng.integers(0, 256, size=6).astype(np.uint8).tobytes(),
    ]
    for body in bodies:
        a = tio.read_kaldi_matrix_binary(io.BytesIO(body))
        b = jio.read_kaldi_matrix_binary(io.BytesIO(body))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unsupported"):
        tio.read_kaldi_matrix_binary(io.BytesIO(b"XM "))


def test_matrix_writer_text_gives_the_same_bytes_and_reads_back(tmp_path):
    mats = _mats(5)
    for side, mod in (("t", tio), ("j", jio)):
        with mod.MatrixWriter(str(tmp_path / f"{side}.txt")) as w:
            for k, v in mats.items():
                w[k] = v
        # write() opens the file itself when used outside `with`
        w2 = mod.MatrixWriter(str(tmp_path / f"{side}2.txt"))
        w2.write("x", mats["c"])
        w2.close()
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t2.txt").read_bytes() == (tmp_path / "j2.txt").read_bytes()
    back_t = tio.read_ark_text(str(tmp_path / "t.txt"))
    back_j = jio.read_ark_text(str(tmp_path / "t.txt"))
    for k, v in mats.items():
        np.testing.assert_array_equal(back_t[k], back_j[k])
        np.testing.assert_allclose(back_t[k], v, rtol=1e-6)
    with pytest.raises(ValueError, match="spaces"):
        tio.MatrixWriter(str(tmp_path / "bad.txt")).write("a b", mats["c"])
    with pytest.raises(ValueError, match=r"\[T, D\]"):
        tio.MatrixWriter(str(tmp_path / "bad.txt")).write("a", np.zeros(3))
    for text, match in [("x  [\n 1 2 \n", "unterminated"), ("1 2\n", "outside"),
                        ("1 2 ]\n", "before any")]:
        (tmp_path / "m.txt").write_text(text)
        with pytest.raises(ValueError, match=match):
            tio.read_ark_text(str(tmp_path / "m.txt"))


def test_rspecifiers_and_autodetect_read_alike(tmp_path):
    mats = _mats(6)
    b, t, s = (str(tmp_path / n) for n in ("b.ark", "t.ark", "b.scp"))
    tio.write_ark_binary(b, mats, scp_path=s)
    with tio.MatrixWriter(t) as w:
        for k, v in mats.items():
            w[k] = v
    for spec in (b, t, f"ark:{b}", f"ark,t:{t}", f"scp:{s}", f"ark,s,cs:{b}"):
        got, want = tio.read_rspecifier(spec), jio.read_rspecifier(spec)
        assert list(got) == list(want) == list(mats)
        for k in mats:
            np.testing.assert_array_equal(got[k], want[k])
    for k, v in tio.read_ark(b).items():
        np.testing.assert_array_equal(v, mats[k])
    with pytest.raises(ValueError, match="unsupported rspecifier"):
        tio.read_rspecifier(f"foo:{b}")
    (tmp_path / "bad.scp").write_text("utt b.ark\n")
    with pytest.raises(ValueError, match="without offset"):
        tio.ScpReader(str(tmp_path / "bad.scp"))
    (tmp_path / "trunc.ark").write_bytes(b"u1 FM ")
    with pytest.raises(ValueError, match="not a binary ark record"):
        tio.read_ark_binary(str(tmp_path / "trunc.ark"))


def test_io_reexports_the_port_datasets_lazily():
    from torchain_tpu_torch.data import loader

    assert tio.ChainDataset is loader.ChainDataset
    assert tio.E2eChainDataset is loader.E2eChainDataset
    assert callable(tio.select_device)  # a torch device check (tests/test_torch_materialize.py)
