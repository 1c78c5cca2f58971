"""XS:i on the mates of a concordant pair (the port's PairedAligner, device
'cpu'): each CP mate carries its own second best, the best score of its
other candidates, which may pass its AS:i (Bowtie 2 manual, XS:i; bowtie2's
own output in tests/data/golden_paired_local_full.sam.gz, r402 `AS:i:66
XS:i:80 YT:Z:CP`), by the rule the unpaired selection uses
(`UnpairedAligner.second_best`). The JAX package gives CP mates no XS:i;
the port departs from it here, to match bowtie2.

(a) Pairs cut from inside the planted, 0-1% diverged repeat copies of the
benchmark's tiny paired configuration (portbench/tests/tiny_pe150.json),
pairs outside them, and discordant pairs made by swapping mates between
far-apart pairs: every CP mate's XS:i is the helper's value, worked out
here again from the mate's scored candidates; where the search found a
second candidate it is at least the second best that the benchmark's
plain reference (portbench.reference.Judge) finds over the copies, and
the mates whose search found none stay within `repeat_xs_pct`'s limit;
fast-committed and discordant pairs carry none, and the helper gives
none for a fast pair's mates. (b) The tiny paired cell's served
path (`bt2srv._align_rows`, CPU aligners) holds every limit of
tiny_pe150.stream.json, `repeat_xs_pct` among them."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each
torch.set_num_threads(1)

import portbench  # noqa: E402
from portbench import genome as gmod  # noqa: E402
from portbench import reference as R  # noqa: E402
from portbench import run  # noqa: E402
from portbench.traffic import ReadSource  # noqa: E402

TINY = Path(portbench.__file__).resolve().parent / "tests"
N_DRAWN = 4000      # pairs drawn; those inside copies are kept
N_SERVED = 300


@pytest.fixture(scope="module")
def tiny():
    """The tiny paired configuration, its genome and its index (built once
    into the harness's cache), and a CPU PairedAligner over it."""
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.index.bt2_reader import detect_index
    cfg = json.loads((TINY / "tiny_pe150.json").read_text())
    gdir = run.genome_dir(cfg)
    gen = gmod.load_genome(gdir)
    _, loader = detect_index(str(gdir / "genome"))
    idx = loader(str(gdir / "genome"))
    return cfg, gen, idx, PairedAligner(idx, device="cpu")


def _read(t: dict) -> bytes:
    return gmod.BASES[np.frombuffer(bytes.fromhex(t["codes"]),
                                    np.uint8)].tobytes()


def _pairs(cfg, gen):
    """[[mate-1 truth, mate-2 truth]]: the drawn pairs whose mates both lie
    inside a planted copy; 48 pairs outside the copies, for the fast path;
    then 24 discordant pairs (mate 2 taken from a pair drawn at least 20
    kbp away or on the other sequence)."""
    judge = R.Judge(cfg, gen)
    _, samples = ReadSource(gen, cfg, {"sample": 1.0}, 11, 0).chunk(N_DRAWN)
    truths = list(samples.values())
    inside = [t for t in truths
              if all(judge.copy_of(m) is not None for m in t)]
    plain = [t for t in truths
             if all(judge.copy_of(m) is None for m in t)]
    disc = []
    for a, b in zip(plain[48::2], plain[49::2]):
        if a[0]["chrom"] != b[1]["chrom"] or \
                abs(a[0]["start"] - b[1]["start"]) > 20_000:
            disc.append([a[0], b[1]])
    return inside + plain[:48] + disc[:24]


def _capture(pal):
    """Wraps the aligner's decision, commits and fast path on this instance:
    returns {pair: (st1, st2, s1, s2)} of the decided pairs, {(id(st), i):
    the candidate committed to the read's record}, and the fast-committed
    masks [(st1, st2, mask)]."""
    decided, committed, fast = {}, {}, []
    decide, finish, commit = pal._decide, pal.up.finish_candidate, \
        pal._commit_fast_cp

    def _decide(st1, st2, i, s1, s2, combos):
        decided[i] = (st1, st2, s1, s2)
        return decide(st1, st2, i, s1, s2, combos)

    def _finish(st, i, ci, bsc, sec, rec=None):
        ok = finish(st, i, ci, bsc, sec, rec)
        if ok and rec is None:
            committed[(id(st), i)] = ci
        return ok

    def _commit(st1, st2, mask, f_sc, f_ci):
        m = commit(st1, st2, mask, f_sc, f_ci)
        fast.append((st1, st2, m))
        return m

    pal._decide, pal.up.finish_candidate, pal._commit_fast_cp = \
        _decide, _finish, _commit
    return decided, committed, fast


def _want_xs(up, st, i, scored, ci):
    """The second best of a mate reporting candidate ci, worked out from
    its scored candidates: the best other score, else the perfect score
    where exact copies beyond the candidates exist, else None."""
    others = [sc for sc, c in scored if c != ci]
    if others:
        return max(others)
    em = int(st.exact_mult[i])
    return int(st.perfect[i]) if em > 1 or em > up._resolve_cap() else None


def test_cp_mates_carry_their_second_best(tiny):
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    cfg, gen, idx, pal = tiny
    pairs = _pairs(cfg, gen)
    decided, committed, fast = _capture(pal)
    qual = bytes([gmod.quality_char(cfg["reads"])]) * 150
    names = [f"p{k}".encode() for k in range(len(pairs))]
    batches = [make_batch(names, [_read(t[m]) for t in pairs],
                          [qual] * len(pairs)) for m in (0, 1)]
    recs = pal.align_batch(*batches)

    judge = R.Judge(cfg, gen)
    truths = [t[m] for t in pairs for m in (0, 1)]
    reads = [_read(t) for t in truths]
    quals = [qual] * len(reads)
    best = R.best_at_origin(judge.sc, gen, reads, quals, truths)
    second = judge.second_best(reads, quals, truths, best)
    smin = judge.sc.min_score(150)

    n_multi = n_judged = n_missed = n_fast = n_dp = 0
    for i, (r1, r2) in enumerate(recs):
        if r1.yt == "DP":
            n_dp += 1
            assert r1.secbest is None and r2.secbest is None, i
        if r1.yt != "CP" or i not in decided:
            continue
        st1, st2, s1, s2 = decided[i]
        for m, (r, st, s) in enumerate(((r1, st1, s1), (r2, st2, s2))):
            ci = committed[(id(st), i)]
            rank = next(k for k, (_, c) in enumerate(s) if c == ci)
            want = _want_xs(pal.up, st, i, s, ci)
            assert r.secbest == want == pal.up.second_best(st, i, s, rank), \
                (i, m, r.secbest, want, s)
            n_multi += len(s) > 1
            sec = second[2 * i + m]
            if sec is None or sec < smin:
                continue
            # a second alignment over the copies: the mate's XS:i (which
            # may pass its AS:i) reaches it where the search found another
            # candidate; where it found none, the mate counts against
            # repeat_xs_pct
            n_judged += 1
            if len(s) > 1:
                assert r.secbest >= sec, (i, m, r.score, r.secbest, sec)
            else:
                n_missed += 1
    # the fast path: one candidate a mate, no hidden exact copy, no XS
    for st1, st2, mask in fast:
        for i in np.nonzero(mask)[0]:
            n_fast += 1
            r1, r2 = recs[int(i)]
            assert r1.yt == "CP" and r1.secbest is None and \
                r2.secbest is None
            for st in (st1, st2):
                s = pal.up.scored_candidates(st, int(i))
                assert len(s) == 1 and \
                    pal.up.second_best(st, int(i), s, 0) is None
    limit = json.loads((TINY / "tiny_pe150.stream.json").read_text())[
        "repeat_xs_pct"]["limit"]
    assert n_multi > 200 and n_judged > 200
    assert 100 * n_missed <= limit * n_judged
    assert n_fast > 10 and n_dp > 10


def test_served_tiny_paired_cell_holds_every_limit(tiny):
    """N_SERVED pairs of tiny_pe150, every one sampled, through the
    server's row path; the judge's every number within its limit in
    tiny_pe150.stream.json, and no share of nothing."""
    from bowtie2_server_tpu_torch.server.bt2srv import _align_rows
    cfg, gen, idx, pal = tiny
    rows, samples = ReadSource(gen, cfg, {"sample": 1.0}, 2**31 + 9,
                               0).chunk(N_SERVED)
    wire = [(f"{k:04X}/1", f[0], f[1], f"{k:04X}/2", f[2], f[3])
            for k, f in rows]
    recs, cur = {}, []
    for line in _align_rows(pal.up, pal, wire, idx.ref_names):
        if line.startswith("@CO END READ"):
            recs[int(line.split("\t")[1], 16)] = cur
            cur = []
        else:
            cur.append(line)
    v = R.Judge(cfg, gen).judge([{"key": k, "truth": t,
                                  "records": recs.get(k)}
                                 for k, t in samples.items()])
    assert v["missing"] == 0 and v["pairs"] == N_SERVED, v["faults"]
    limits = json.loads((TINY / "tiny_pe150.stream.json").read_text())
    got = {"unanswered": (v["missing"], None), **R.numbers(v)}
    assert set(limits) == set(got) == R.number_names(cfg)
    for k, lim in limits.items():
        value, base = got[k]
        assert base != 0, (k, "a share of nothing")
        assert value <= lim["limit"], (k, value, v["faults"])
    assert v["repeat"] > 0
