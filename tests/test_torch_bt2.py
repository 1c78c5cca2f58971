"""The port's `.bt2` index writer and reader against the JAX package's: the
six files byte-identical (several contigs, N runs, the 32-bit and the
64-bit layout, other -o/-t), `load_bt2_index` equal array by array (also
through the rebuild fallback), `detect_index` on both formats, a `.bt2`
index aligning as the native build of the same FASTA, and the CLI's
`build --bt2` and `inspect` equal to the JAX CLI's."""
import contextlib
import io
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.__main__ import main as jax_main  # noqa: E402
from bowtie2_server_tpu.index import bt2_reader as jreader  # noqa: E402
from bowtie2_server_tpu.index import bt2_writer as jwriter  # noqa: E402
from bowtie2_server_tpu_torch.align.pipeline import (  # noqa: E402
    UnpairedAligner)
from bowtie2_server_tpu_torch.index import bt2_reader as treader  # noqa
from bowtie2_server_tpu_torch.index import bt2_writer as twriter  # noqa
from bowtie2_server_tpu_torch.index.build import (  # noqa: E402
    build_index, parse_fasta)
from bowtie2_server_tpu_torch.index.fm import FmIndex  # noqa: E402
from bowtie2_server_tpu_torch.io.fastq import make_batch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FILES = ("1", "2", "3", "4", "rev.1", "rev.2")
DIRECTION_FIELDS = ("bwt", "occ", "cnt", "sa", "primary", "ftab_top",
                    "ftab_bot")


@pytest.fixture(scope="module")
def multi_fa(tmp_path_factory):
    """Three sequences with leading, inner and trailing N runs, full
    header lines with spaces (the shape of tests/test_bt2_writer.py), and
    a 20 kbp chromosome."""
    rng = np.random.default_rng(5)

    def rand(n):
        return "".join("ACGT"[c] for c in rng.integers(0, 4, n))

    fa = (">seq one with spaces\n" + "N" * 7 + rand(300) + "NN"
          + rand(150) + "NNNN\n"
          ">seq2\n" + rand(400) + "\n"
          ">seq3 trailing\nNNN" + rand(80) + "N" + rand(60) + "\n"
          ">chr4\n" + rand(20_000) + "\n")
    p = tmp_path_factory.mktemp("torch_bt2") / "multi.fa"
    p.write_text(fa)
    return p


def _files(base: Path, ext: str) -> dict[str, bytes]:
    return {f: Path(f"{base}.{f}{ext}").read_bytes() for f in FILES}


@pytest.mark.parametrize("off_rate,ftab_chars", [(4, 10), (3, 8)])
def test_write_bt2_byte_identical(multi_fa, tmp_path, off_rate, ftab_chars):
    kw = dict(off_rate=off_rate, ftab_chars=ftab_chars)
    jwriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "jax"), **kw)
    twriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "port"), **kw)
    want = _files(tmp_path / "jax", ".bt2")
    got = _files(tmp_path / "port", ".bt2")
    for f in FILES:
        assert got[f] == want[f], f".{f}.bt2 differs"


def _offu(data: bytes, pos: int, n: int, large: bool) -> np.ndarray:
    return np.frombuffer(data, np.uint64 if large else np.uint32, n,
                         pos).astype(np.uint64)


def _dir_tables(path: Path, meta: dict):
    """(zOff, fchr, ftab entries, eftab) of one direction's .1 file, with
    each eftab marker (e ^ OFF_MASK) read back as -1 - e."""
    data = path.read_bytes()
    osz = 8 if meta["large"] else 4
    k = meta["ftab_chars"]
    pos = meta["ebwt_pos"] + meta["num_sides"] * meta["side_sz"]
    n_ftab = (1 << (2 * k)) + 1
    v = _offu(data, pos, 6 + n_ftab + 2 * k, meta["large"]).astype(object)
    mask = (1 << (8 * osz)) - 1
    ftab = [x if x <= mask - 2 * k else -1 - (x ^ mask)
            for x in v[6 : 6 + n_ftab]]
    return v[0], list(v[1:6]), ftab, list(v[6 + n_ftab :])


def test_write_bt2_large(multi_fa, tmp_path):
    """The 64-bit layout (.bt2l). The JAX writer cannot write it: it
    stores each eftab marker, e ^ 0xFFFFFFFFFFFFFFFF, into an int64 array
    and raises OverflowError. The port's writer keeps the marker's bit
    pattern. Where the JAX writer raises, the port's .bt2l set is held to
    the JAX .bt2 set of the same FASTA field by field (every offset
    widened, the sides repacked at 32 BWT bytes a side) and through the
    JAX reader; where it writes, byte by byte."""
    jwriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "small"))
    twriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "port"),
                                 large=True)
    try:
        jwriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "jax"),
                                     large=True)
    except OverflowError:
        pass
    else:
        assert _files(tmp_path / "port", ".bt2l") == \
            _files(tmp_path / "jax", ".bt2l")
    small, port = str(tmp_path / "small"), str(tmp_path / "port")
    for tag in ("", ".rev"):
        (ms, ps, ns), (ml, pl, nl) = (jreader.read_bt2_metadata(small + tag),
                                      jreader.read_bt2_metadata(port + tag))
        assert ml["large"] and ml["ext"] == ".bt2l" and not ms["large"]
        assert ml["side_bwt_sz"] == 32 and ms["side_bwt_sz"] == 48
        for key in ("length", "line_rate", "off_rate", "ftab_chars",
                    "n_pat", "bwt_len", "zoff"):
            assert ml[key] == ms[key], key
        assert np.array_equal(ml["rstarts"], ms["rstarts"])
        assert np.array_equal(pl, ps) and nl == ns
        assert _dir_tables(Path(port + tag + ".1.bt2l"), ml) == \
            _dir_tables(Path(small + tag + ".1.bt2"), ms)
        bs, zs = jreader.read_bt2_ebwt(small + tag)
        bl, zl = jreader.read_bt2_ebwt(port + tag)
        assert zs == zl and np.array_equal(bs, bl)
        d2s = Path(small + tag + ".2.bt2").read_bytes()
        d2l = Path(port + tag + ".2.bt2l").read_bytes()
        assert d2s[:4] == d2l[:4]
        assert np.array_equal(_offu(d2s, 4, (len(d2s) - 4) // 4, False),
                              _offu(d2l, 4, (len(d2l) - 4) // 8, True))
    assert Path(port + ".4.bt2l").read_bytes() == \
        Path(small + ".4.bt2").read_bytes()
    d3s = Path(small + ".3.bt2").read_bytes()
    d3l = Path(port + ".3.bt2l").read_bytes()
    n_recs = int(_offu(d3s, 4, 1, False)[0])
    assert int(_offu(d3l, 4, 1, True)[0]) == n_recs
    for r in range(n_recs):
        a, b = 8 + 9 * r, 12 + 17 * r
        assert list(_offu(d3s, a, 2, False)) == list(_offu(d3l, b, 2, True))
        assert d3s[a + 8] == d3l[b + 16]
    _assert_index_equal(jreader.load_bt2_index(port),
                        jreader.load_bt2_index(small))


def _assert_index_equal(got, want):
    for d in ("fw", "mirror"):
        g, w = getattr(got, d), getattr(want, d)
        assert (g is None) == (w is None), d
        if w is None:
            continue
        for f in DIRECTION_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), (d, f)
            else:
                assert a == b, (d, f)
    for f in ("joined", "ref_lens", "run_joined_start", "ref_full",
              "ref_full_start"):
        a, b = getattr(got, f), getattr(want, f)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f
    assert got.ref_names == want.ref_names
    assert got.n == want.n and got.n_refs == want.n_refs


@pytest.mark.parametrize("large", [False, True])
def test_load_bt2_index_equal(multi_fa, tmp_path, large):
    base = str(tmp_path / "idx")
    # the port's writer: the JAX one cannot write the 64-bit layout
    twriter.write_bt2_from_fasta(str(multi_fa), base, large=large)
    got = treader.load_bt2_index(base)
    want = jreader.load_bt2_index(base)
    assert got.fw is not None and got.mirror is not None
    _assert_index_equal(got, want)
    assert got.cache_base == want.cache_base == base


def test_load_bt2_rebuild_fallback(multi_fa, tmp_path):
    """Without the .rev files both readers rebuild from the genome the
    .1/.3/.4 files hold: the same arrays again."""
    base = str(tmp_path / "idx")
    twriter.write_bt2_from_fasta(str(multi_fa), base)
    for f in ("rev.1", "rev.2"):
        Path(f"{base}.{f}.bt2").unlink()
    _assert_index_equal(treader.load_bt2_index(base),
                        jreader.load_bt2_index(base))


def test_metadata_and_reference_equal(multi_fa, tmp_path):
    base = str(tmp_path / "idx")
    twriter.write_bt2_from_fasta(str(multi_fa), base)
    (tm, tplen, tnames), (jm, jplen, jnames) = (
        treader.read_bt2_metadata(base), jreader.read_bt2_metadata(base))
    assert tnames == jnames and np.array_equal(tplen, jplen)
    assert {k: v for k, v in tm.items() if k != "rstarts"} == \
        {k: v for k, v in jm.items() if k != "rstarts"}
    assert np.array_equal(tm["rstarts"], jm["rstarts"])
    tn, ts = treader.read_bt2_reference(base)
    jn, js = jreader.read_bt2_reference(base)
    assert tn == jn and all(np.array_equal(a, b) for a, b in zip(ts, js))
    names, seqs = parse_fasta(str(multi_fa))
    assert [n.split()[0] for n in tn] == [n.split()[0] for n in names]
    assert all(np.array_equal(a, b) for a, b in zip(ts, seqs))


def test_detect_index(multi_fa, tmp_path):
    nat = tmp_path / "nat"
    build_index(str(multi_fa)).save(nat)
    kind, loader = treader.detect_index(str(nat))
    assert kind == "native" and loader == FmIndex.load
    twriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "b"))
    kind, loader = treader.detect_index(str(tmp_path / "b"))
    assert kind == "bt2" and loader is treader.load_bt2_index
    twriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "l"),
                                 large=True)
    assert treader.detect_index(str(tmp_path / "l"))[0] == "bt2"
    with pytest.raises(FileNotFoundError):
        treader.detect_index(str(tmp_path / "absent"))


def test_bt2_index_aligns_as_native(multi_fa, tmp_path):
    """write_bt2 -> load_bt2_index aligns as the native build of the same
    FASTA on the port's aligner (the $-after-everything rows of a .bt2
    index go through the same search code)."""
    twriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "rt"))
    idx_rt = treader.load_bt2_index(str(tmp_path / "rt"))
    idx_nat = build_index(str(multi_fa))
    _, seqs = parse_fasta(str(multi_fa))
    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    while len(reads) < 96:
        s = seqs[int(rng.integers(0, len(seqs)))]
        rl = int(rng.integers(30, 80))
        if len(s) <= rl:
            continue
        st = int(rng.integers(0, len(s) - rl))
        rd = s[st : st + rl].copy()
        if (rd > 3).any():
            continue
        if rng.random() < 0.5:
            rd = (3 - rd)[::-1]
        reads.append(bases[rd].tobytes())
    b = make_batch([f"r{i}" for i in range(len(reads))], reads,
                   [b"I" * len(r) for r in reads])
    out = []
    for idx in (idx_rt, idx_nat):
        recs = UnpairedAligner(idx, device="cpu").align_batch(b)
        out.append([(r.aligned, r.ref_id, r.pos, r.fw, r.cigar, r.score,
                     r.mapq) for r in recs])
    assert out[0] == out[1]
    assert sum(r[0] for r in out[0]) == len(reads)


def _port_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "bowtie2_server_tpu_torch", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_cli_build_bt2(multi_fa, tmp_path):
    r = _port_cli("build", "--bt2", "-o", "3", "-t", "8", str(multi_fa),
                  str(tmp_path / "port"))
    assert r.returncode == 0, r.stderr
    jwriter.write_bt2_from_fasta(str(multi_fa), str(tmp_path / "jax"),
                                 off_rate=3, ftab_chars=8)
    assert _files(tmp_path / "port", ".bt2") == \
        _files(tmp_path / "jax", ".bt2")


@pytest.fixture(scope="module")
def indexes(multi_fa, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bt2_inspect")
    build_index(str(multi_fa)).save(d / "nat")
    twriter.write_bt2_from_fasta(str(multi_fa), str(d / "bt2"))
    return {"native": str(d / "nat"), "bt2": str(d / "bt2")}


@pytest.mark.parametrize("fmt", ["native", "bt2"])
@pytest.mark.parametrize("opt", ["-n", "-s", "fasta"])
def test_cli_inspect_equals_jax(indexes, fmt, opt):
    argv = ["inspect", indexes[fmt]] + ([] if opt == "fasta" else [opt])
    r = _port_cli(*argv)
    assert r.returncode == 0, r.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_main(argv)
    assert r.stdout == buf.getvalue()
    assert len(r.stdout.splitlines()) >= 4


def test_port_reader_reads_bowtie2_build_layout(multi_fa, tmp_path):
    """A .bt2 set copied elsewhere (the way users point a server at an
    index built once) loads the same; the k-mer table cache follows the
    new base."""
    src = tmp_path / "a"
    twriter.write_bt2_from_fasta(str(multi_fa), str(src))
    dst = tmp_path / "moved"
    dst.mkdir()
    for f in FILES:
        shutil.copy(f"{src}.{f}.bt2", dst / f"b.{f}.bt2")
    got = treader.load_bt2_index(str(dst / "b"))
    _assert_index_equal(got, treader.load_bt2_index(str(src)))
    assert got.cache_base == str(dst / "b")


def test_cli_align_reads_bt2(indexes, multi_fa, tmp_path):
    """`align -x` on a .bt2 set writes the records it writes on the native
    index of the same FASTA."""
    _, seqs = parse_fasta(str(multi_fa))
    rng = np.random.default_rng(4)
    with open(tmp_path / "r.fq", "w") as f:
        for i in range(60):
            s = seqs[3]
            st = int(rng.integers(0, len(s) - 70))
            rd = "".join("ACGT"[c] for c in s[st : st + 70])
            f.write(f"@r{i}\n{rd}\n+\n{'I' * 70}\n")
    recs = {}
    for fmt in ("native", "bt2"):
        out = tmp_path / f"{fmt}.sam"
        r = _port_cli("align", "-x", indexes[fmt], "-U",
                      str(tmp_path / "r.fq"), "-S", str(out), "--device",
                      "cpu")
        assert r.returncode == 0, r.stderr
        recs[fmt] = [ln for ln in out.read_text().splitlines()
                     if not ln.startswith("@PG")]
    assert recs["bt2"] == recs["native"]
    assert sum(not ln.startswith("@") for ln in recs["bt2"]) == 60
