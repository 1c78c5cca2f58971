"""The port's `align` command line against the JAX CLI on the CPU, option
group by option group: scoring, presets, --dpad and -M; input formats and
trims; SAM options; --un/--al and their conc and compressed forms; paired
options. Each case runs `python -m bowtie2_server_tpu align ... --cpu` and
`python -m bowtie2_server_tpu_torch align ... --device cpu` in process on
one synthetic genome (a seeded numpy RNG) and holds the SAM (@PG aside),
the alignment summary and every output file byte-identical; BAM output is
compared after decoding its BGZF blocks."""
import bz2
import gc
import gzip

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.__main__ import main as jax_main  # noqa: E402
from bowtie2_server_tpu_torch.__main__ import main as port_main  # noqa
from bowtie2_server_tpu_torch.io.bam import (  # noqa: E402
    BamWriter, _bgzf_blocks)

READ_LEN = 100
CONTIGS = (30_000, 4_000, 3_000)
N_READS, N_PAIRS = 120, 80
_BASES = np.frombuffer(b"ACGT", np.uint8)


def _seq(codes) -> str:
    return _BASES[codes].tobytes().decode()


def _mutate(rng, r):
    """A copy of r with 0-3 substitutions."""
    r = r.copy()
    for _ in range(int(rng.integers(0, 4))):
        r[rng.integers(0, len(r))] = rng.integers(0, 4)
    return r


def make_reads(rng, ctg, n):
    """(name with a comment, seq, qual) of n reads of 100 bp: 0-3
    substitutions, every 7th with a 2-base deletion, every 30th with an N,
    half reverse complemented, every 20th random (unaligned)."""
    out = []
    for i in range(n):
        c = ctg[int(rng.integers(0, len(ctg)))]
        s = int(rng.integers(0, len(c) - READ_LEN - 2))
        r = _mutate(rng, c[s : s + READ_LEN])
        if i % 7 == 3:
            p = int(rng.integers(20, 80))
            r = np.concatenate([r[:p], r[p + 2:], c[s + READ_LEN:
                                                   s + READ_LEN + 2]])
        if i % 20 == 11:
            r = rng.integers(0, 4, READ_LEN).astype(np.uint8)
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        seq = _seq(r)
        if i % 30 == 5:
            k = int(rng.integers(0, READ_LEN))
            seq = seq[:k] + "N" + seq[k + 1:]
        qual = bytes(rng.integers(35, 74, READ_LEN).astype(np.uint8)).decode()
        out.append((f"r{i} comment{i}", seq, qual))
    return out


def make_pairs(rng, chrom, n):
    """FR pairs of 100 bp mates on contig 0: mate 2 starts 20 bases before
    mate 1 (dovetail) up to 300 after; so some pairs overlap, contain each
    other (same start) or dovetail. Every 10th mate 2 is random."""
    out = []
    for p in range(n):
        s1 = int(rng.integers(100, len(chrom) - 600))
        s2 = s1 + int(rng.choice([-20, -5, 0, 40, 150, 200, 250, 300]))
        m1 = _mutate(rng, chrom[s1 : s1 + READ_LEN])
        m2 = (3 - _mutate(rng, chrom[s2 : s2 + READ_LEN]))[::-1]
        if p % 10 == 7:
            m2 = rng.integers(0, 4, READ_LEN).astype(np.uint8)
        q1, q2 = (bytes(rng.integers(35, 74, READ_LEN).astype(
            np.uint8)).decode() for _ in range(2))
        out.append((f"p{p}", _seq(m1), q1, _seq(m2), q2))
    return out


def _phred64(q):
    return "".join(chr(ord(c) + 31) for c in q)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The genome's index (built by the port CLI, read by both) and the
    reads in every input format the cases use."""
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(7)
    ctg = [rng.integers(0, 4, n).astype(np.uint8) for n in CONTIGS]
    (d / "ref.fa").write_text("".join(
        f">ctg{i} contig {i}\n{_seq(c)}\n" for i, c in enumerate(ctg)))
    port_main(["build", str(d / "ref.fa"), str(d / "idx")])
    reads = make_reads(rng, ctg, N_READS)
    pairs = make_pairs(rng, ctg[0], N_PAIRS)
    f = {}

    def put(name, text):
        f[name] = d / name
        f[name].write_text(text)

    put("reads.fq", "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in reads))
    put("reads.fa", "".join(f">{n}\n{s}\n" for n, s, _ in reads))
    put("reads.raw", "".join(f"{s}\n" for _, s, _ in reads))
    put("reads.tab", "".join(f"{n.split()[0]}\t{s}\t{_phred64(q)}\n"
                             for n, s, q in reads))
    put("reads_int.fq", "".join(
        f"@{n}\n{s}\n+\n{' '.join(str(ord(c) - 33) for c in q)}\n"
        for n, s, q in reads))
    # qseq: 11 fields; every 9th read fails QC (filter flag 0)
    put("reads.qseq", "".join(
        f"M1\t7\t1\t11\t{i}\t{2 * i}\t0\t1\t{s.replace('N', '.')}\t"
        f"{_phred64(q)}\t{0 if i % 9 == 4 else 1}\n"
        for i, (_, s, q) in enumerate(reads)))
    put("long.fa", "".join(f">chunk{k}\n{_seq(ctg[1][k * 900:(k + 1) * 900])}"
                           "\n" for k in range(3)))
    f["csv"] = ",".join(s for _, s, _ in reads[:12])
    put("m1.fq", "".join(f"@{n}/1\n{a}\n+\n{qa}\n"
                         for n, a, qa, _, _ in pairs))
    put("m2.fq", "".join(f"@{n}/2\n{b}\n+\n{qb}\n"
                         for n, _, _, b, qb in pairs))
    put("pairs.il", "".join(f"@{n}/1\n{a}\n+\n{qa}\n@{n}/2\n{b}\n+\n{qb}\n"
                            for n, a, qa, b, qb in pairs[:40]))
    put("pairs.tab", "".join(f"{n}\t{a}\t{qa}\t{n}\t{b}\t{qb}\n"
                             for n, a, qa, b, qb in pairs))
    # BAM inputs written by the port's BamWriter: unaligned records with
    # tags; every 4th record on the reverse strand (flag 16) and a
    # secondary one (skipped by the readers)
    f["reads.bam"] = d / "reads.bam"
    with open(f["reads.bam"], "wb") as fh:
        w = BamWriter(fh, "@HD\tVN:1.0\tSO:unsorted\n", [], [])
        for i, (n, s, q) in enumerate(reads):
            flag = 4 | (16 if i % 4 == 1 else 0)
            if flag & 16:
                s = s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
                q = q[::-1]
            w.write_sam_line(f"{n.split()[0]}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t"
                             f"{s}\t{q}\tRG:Z:lane{i % 3}\tXI:i:{i}")
        w.write_sam_line(f"sec\t260\t*\t0\t0\t*\t*\t0\t0\t{reads[0][1]}\t"
                         f"{reads[0][2]}")
        w.close()
    f["pairs.bam"] = d / "pairs.bam"
    with open(f["pairs.bam"], "wb") as fh:
        w = BamWriter(fh, "@HD\tVN:1.0\n", [], [])
        for n, a, qa, b, qb in pairs:
            w.write_sam_line(f"{n}\t77\t*\t0\t0\t*\t*\t0\t0\t{a}\t{qa}")
            w.write_sam_line(f"{n}\t141\t*\t0\t0\t*\t*\t0\t0\t{b}\t{qb}")
        w.write_sam_line(f"lone\t4\t*\t0\t0\t*\t*\t0\t0\t{reads[1][1]}\t"
                         f"{reads[1][2]}")
        w.close()
    return d, f


def _read_out(path):
    name = path.name
    if name.endswith(".gz"):
        return gzip.open(path, "rt").read()
    if name.endswith(".bz2"):
        return bz2.open(path, "rt").read()
    if name.endswith(".bam"):
        with open(path, "rb") as fh:
            return b"".join(_bgzf_blocks(fh))
    return path.read_text()


def run_both(inputs, tmp_path, monkeypatch, capsys, argv, outputs=()):
    """argv through both CLIs (each in a directory of its own, -S out.sam
    unless argv names -S): {"jax"|"port": (SAM lines without @PG, summary
    lines, {output: content}, the names of -t's stage times)}."""
    d, _ = inputs
    got = {}
    for tag, fn, dev in (("jax", jax_main, ["--cpu"]),
                         ("port", port_main, ["--device", "cpu"])):
        run = tmp_path / tag
        run.mkdir()
        monkeypatch.chdir(run)
        capsys.readouterr()
        out = [] if "-S" in argv else ["-S", "out.sam"]
        fn(["align", "-x", str(d / "idx"), *argv, *out, *dev])
        gc.collect()   # the JAX CLI leaves its log files to the collector
        err = capsys.readouterr().err
        sam = ([ln for ln in (run / "out.sam").read_text().splitlines()
                if not ln.startswith("@PG")]
               if (run / "out.sam").exists() else [])
        summ = [ln for ln in err.splitlines()
                if not ln.startswith(("#", "Time ", "Overall time"))]
        times = [ln.split(":")[0] for ln in err.splitlines()
                 if ln.startswith(("Time ", "Overall time"))]
        got[tag] = (sam, summ, {o: _read_out(run / o) for o in outputs},
                    times)
    return got


def assert_same(got):
    (jsam, jsum, jout, _), (tsam, tsum, tout, _) = got["jax"], got["port"]
    assert tsam == jsam
    assert tsum == jsum
    assert tout.keys() == jout.keys()
    for k in jout:
        assert tout[k] == jout[k], k


# ---- scoring, presets, --dpad, -M ----
SCORING = {
    "presets_dpad_M": ["--very-sensitive", "--dpad", "20", "-M", "3",
                       "--mp", "5,1", "--rdg", "4,2", "--rfg", "6,3",
                       "--gbar", "3", "--score-min", "L,-0.7,-0.7",
                       "--mapq-v", "3"],
    "local_scoring_wide": ["--very-fast-local", "--ma", "3", "--np", "2",
                           "--n-ceil", "L,0,0.2", "--ignore-quals",
                           "--dpad", "32", "--norc"],
    "policy": ["--multiseed", "0,20,S,1,0.5", "-D", "5", "-R", "3",
               "--seed-boost", "100", "--no-1mm-upfront", "--454", "-k", "3",
               "--omit-sec-seq", "--sam-opt-config=-md,-xs",
               "--show-rand-seed"],
}


@pytest.mark.parametrize("opts", list(SCORING.values()), ids=list(SCORING))
def test_scoring_options(inputs, tmp_path, monkeypatch, capsys, opts):
    _, f = inputs
    got = run_both(inputs, tmp_path, monkeypatch, capsys,
                   ["-U", str(f["reads.fq"]), *opts])
    assert_same(got)
    assert len(got["port"][0]) >= N_READS


# ---- input formats and trims (with SAM and --un/--al options that do
# not interact with the reader) ----
FORMATS = {
    "fasta_trims_sam": (["-f", "-U", "reads.fa", "--trim-to", "3:80", "-s",
                         "5", "-u", "100", "--xeq", "--rg-id", "x", "--rg",
                         "SM:y", "--rg", "PL:z", "--un", "un.fq", "--al-gz",
                         "al.fq.gz"], ("un.fq", "al.fq.gz")),
    "tab_phred64_sam": (["--tab6", "reads.tab", "--phred64", "--no-unal",
                         "--no-sq", "--refidx", "--un-bz2", "un.fq.bz2",
                         "--al", "al.fq"], ("un.fq.bz2", "al.fq")),
    "raw_sample": (["-r", "-U", "reads.raw", "--sample", "0.5", "--seed",
                    "7", "--no-hd", "--fullref", "-5", "3", "-3", "2"], ()),
    "qseq_qc_filter": (["--qseq", "-U", "reads.qseq", "--qc-filter",
                        "--quiet"], ()),
    "fasta_continuous": (["-F", "k:50,i:40", "-U", "long.fa"], ()),
    "cmdline": (["-c", "csv"], ()),
    "int_quals_fastq_sam": (["--int-quals", "-U", "reads_int.fq",
                             "--sam-append-comment", "--sam-no-qname-trunc",
                             "--passthrough"], ()),
    "bam_preserve_tags": (["-b", "-U", "reads.bam", "--preserve-tags"], ()),
    "bam_to_bam": (["-b", "-U", "reads.bam", "--output-bam", "--rg-id", "g",
                    "-S", "out.bam"], ("out.bam",)),
}


def _resolve(f, argv):
    return [str(f[a]) if a in f else a for a in argv]


@pytest.mark.parametrize("case", list(FORMATS.values()), ids=list(FORMATS))
def test_input_formats_and_sam_options(inputs, tmp_path, monkeypatch, capsys,
                                       case):
    _, f = inputs
    argv, outputs = case
    got = run_both(inputs, tmp_path, monkeypatch, capsys, _resolve(f, argv),
                   outputs)
    assert_same(got)
    sam, _, outs, _ = got["port"]
    assert sam or outs.get("out.bam")
    for name in outputs:
        assert outs[name]


# ---- paired options and inputs ----
PAIRED = {
    "dovetail_conc": (["-1", "m1.fq", "-2", "m2.fq", "--dovetail", "-I",
                       "50", "-X", "400", "--un-conc", "unc%.fq",
                       "--al-conc-gz", "alc%.fq.gz"],
                      ("unc1.fq", "unc2.fq", "alc1.fq.gz", "alc2.fq.gz")),
    "no_contain_overlap": (["-1", "m1.fq", "-2", "m2.fq", "--no-contain",
                            "--no-overlap", "--no-unal", "--un-conc-bz2",
                            "unc%.fq.bz2", "--al-conc", "alc%.fq"],
                           ("unc1.fq.bz2", "unc2.fq.bz2", "alc1.fq",
                            "alc2.fq")),
    "interleaved_local_tlen": (["--interleaved", "pairs.il", "--local",
                                "--soft-clipped-unmapped-tlen"], ()),
    "tab6_pairs": (["--tab6", "pairs.tab"], ()),
    "bam_pairs": (["-b", "-U", "pairs.bam", "--align-paired-reads"], ()),
}


@pytest.mark.parametrize("case", list(PAIRED.values()), ids=list(PAIRED))
def test_paired_options(inputs, tmp_path, monkeypatch, capsys, case):
    _, f = inputs
    argv, outputs = case
    got = run_both(inputs, tmp_path, monkeypatch, capsys, _resolve(f, argv),
                   outputs)
    assert_same(got)
    sam, summ, _, _ = got["port"]
    assert any("were paired" in ln for ln in summ)
    assert len(sam) >= 2 * 40


# ---- the paired inputs other than -1/-2 take the JAX CLI's branches: the
# options beyond orientation and fragment lengths do not apply there ----
PAIR_ONLY_OPTS = ["--no-unal", "--nofw", "--dovetail", "--no-contain",
                  "--no-overlap", "--un-conc", "unc%.fq", "--al-conc",
                  "alc%.fq", "--sample", "0.5", "--seed", "3", "--met-file",
                  "met.tsv"]
OTHER_PAIRED = {
    "bam_pairs": ["-b", "-U", "pairs.bam", "--align-paired-reads"],
    "tab6_pairs": ["--tab6", "pairs.tab"],
    "interleaved": ["--interleaved", "pairs.il"],
}
# the --met TSV's columns that are not counters: wall time, and memory
# peaks (the process's RSS, and each package's own index and SA arrays)
NOT_COUNTERS = {"Time", "MemPeak", "EbwtMemPeak", "ResolveMemPeak"}


def _tsv_counters(text):
    rows = [ln.split("\t") for ln in text.splitlines()]
    keep = [k for k, c in enumerate(rows[0] if rows else [])
            if c not in NOT_COUNTERS]
    return [[r[k] for k in keep] for r in rows]


@pytest.mark.parametrize("src", list(OTHER_PAIRED.values()),
                         ids=list(OTHER_PAIRED))
def test_other_paired_inputs_as_jax_branches(inputs, tmp_path, monkeypatch,
                                             capsys, src):
    """-b --align-paired-reads, paired --tab6 and --interleaved under the
    options the JAX CLI ignores on them: SAM, the summary, the set of files
    written (no --un-conc/--al-conc file) and each file are exact against
    the JAX CLI's (the --met TSV by its counter columns)."""
    _, f = inputs
    got = run_both(inputs, tmp_path, monkeypatch, capsys,
                   _resolve(f, src + PAIR_ONLY_OPTS))
    assert_same(got)
    # files only: the JAX CLI also makes its compile cache's directory
    files = {tag: sorted(p.name for p in (tmp_path / tag).iterdir()
                         if p.is_file())
             for tag in ("jax", "port")}
    assert files["port"] == files["jax"]
    assert "met.tsv" in files["port"]
    assert not any(n.startswith(("unc", "alc")) for n in files["port"])
    for name in files["jax"]:
        if name == "out.sam":
            continue
        want, have = ((tmp_path / tag / name).read_text()
                      for tag in ("jax", "port"))
        if name == "met.tsv":
            want, have = _tsv_counters(want), _tsv_counters(have)
        assert have == want, name
    # --no-unal and --nofw did not apply; --sample applies but to BAM
    sam = [ln for ln in got["port"][0] if not ln.startswith("@")]
    flags = [int(ln.split("\t")[1]) for ln in sam]
    assert any(fl & 4 for fl in flags)
    assert any(not fl & 4 and not fl & 16 for fl in flags)
    n_pairs = 40 if src[0] == "--interleaved" else N_PAIRS
    assert (len(sam) < 2 * n_pairs) == (src[0] != "-b")


def test_preserve_tags_needs_bam(inputs):
    _, f = inputs
    with pytest.raises(SystemExit) as e:
        port_main(["align", "-x", "i", "-U", str(f["reads.fq"]),
                   "--preserve-tags"])
    assert "--preserve-tags can only be used" in str(e.value)
