"""The plain reference agrees with the port's server on the CPU; a
corrupted field, reads left unaligned and XS dropped on repeat reads fail
it; its control fails the cells' limits through the run's own checks."""
import json

import numpy as np
import pytest

from portbench import genome as gmod
from portbench import reference as R
from portbench import run
from portbench.traffic import ReadSource

from tinycells import tiny_config

N_READS = 600


def served_samples(name, seed=5):
    """Samples of N_READS reads (every one sampled) with the records the
    port's server path (`bt2srv._align_rows`, CPU aligners) gives them."""
    from bowtie2_server_tpu_torch.align.paired import PairedAligner
    from bowtie2_server_tpu_torch.index.bt2_reader import detect_index
    from bowtie2_server_tpu_torch.server.bt2srv import _align_rows
    cfg = tiny_config(name)
    gdir = run.genome_dir(cfg)
    gen = gmod.load_genome(gdir)
    _, loader = detect_index(str(gdir / "genome"))
    idx = loader(str(gdir / "genome"))
    pal = PairedAligner(idx, device="cpu")
    rows, samples = ReadSource(gen, cfg, {"sample": 1.0}, seed, 0).chunk(
        N_READS)
    wire = [(f"{k:04X}/1", f[0], f[1], None, None, None) for k, f in rows]
    recs, cur = {}, []
    for line in _align_rows(pal.up, pal, wire, idx.ref_names):
        if line.startswith("@CO END READ"):
            recs[int(line.split("\t")[1].split("/")[0], 16)] = cur
            cur = []
        else:
            cur.append(line)
    return cfg, gen, [{"key": k, "truth": t, "records": recs.get(k)}
                      for k, t in samples.items()]


@pytest.fixture(scope="module")
def served():
    return served_samples("tiny_se100")


def limits():
    return json.loads((run.HERE / "limits" / "ecoli_se100.stream.json")
                      .read_text())


def test_reference_agrees_with_the_server(served):
    cfg, gen, samples = served
    v = R.Judge(cfg, gen).judge(samples)
    assert v["field_faults"] == 0, v["faults"]
    assert v["missing"] == 0
    assert v["gapped"] > 0 and v["repeat"] > 0
    lim = limits()
    assert 100.0 * v["below"] / v["judged"] <= lim["below_pct"]["limit"]
    assert 100.0 * v["repeat_short"] / v["repeat"] <= \
        lim["repeat_xs_pct"]["limit"], v["faults"]


def _aligned(samples):
    for s in samples:
        if int(s["records"][0].split("\t")[1]) & 4 == 0:
            return s
    raise AssertionError("no aligned sample")


@pytest.mark.parametrize("field", [1, 3, 4, 5, 8, "AS", "MD", "NM", "YT"])
def test_a_corrupted_field_fails(served, field):
    cfg, gen, samples = served
    s = dict(_aligned(samples))
    f = s["records"][0].split("\t")
    if isinstance(field, int):
        f[field] = str(int(f[field]) + (16 if field == 1 else 1)) \
            if field != 5 else f[field].replace("M", "M1I", 1)
    else:
        k = next(i for i, t in enumerate(f) if t.startswith(field + ":"))
        typ = f[k].split(":")[1]
        f[k] = (f"{field}:i:{int(f[k].split(':')[2]) - 1}" if typ == "i"
                else f"{field}:Z:X" + f[k].split(":")[2])
    s["records"] = ["\t".join(f)] + s["records"][1:]
    v = R.Judge(cfg, gen).judge([s])
    assert v["field_faults"] == 1


def _set(rec: str, k: int, v: str) -> str:
    f = rec.split("\t")
    f[k] = v
    return "\t".join(f)


def test_reads_left_unaligned_fail_below_pct(served):
    """A tenth of the answers turned into unaligned records, formatted as
    the program formats them, passes the field checks and fails below_pct."""
    cfg, gen, samples = served
    cut = []
    for k, s in enumerate(samples):
        rec = s["records"][0]
        f = rec.split("\t")
        if k % 10 == 0 and not int(f[1]) & 4:
            fw = not int(f[1]) & 16
            seq = f[9] if fw else R.revcomp(f[9].encode()).decode()
            qual = f[10] if fw else f[10][::-1]
            rec = "\t".join([f[0], "4", "*", "0", "0", "*", "*", "0", "0",
                             seq, qual, "YT:Z:UU"])
        cut.append(dict(s, records=[rec]))
    v = R.Judge(cfg, gen).judge(cut)
    assert v["field_faults"] == 0, v["faults"]
    assert 100.0 * v["below"] / v["judged"] > limits()["below_pct"]["limit"]


def test_xs_dropped_on_repeat_reads_fails(served):
    """XS taken off every repeat read and MAPQ recomputed to match, as a
    program that never looked at a second copy would answer: the fields
    are consistent, repeat_xs_pct is not."""
    cfg, gen, samples = served
    judge = R.Judge(cfg, gen)
    sc = R.Scoring(cfg)
    dropped = []
    for s in samples:
        rec = s["records"][0]
        f = rec.split("\t")
        if judge.siblings(s["truth"][0]) and "\tXS:i:" in rec:
            tags = [t for t in f[11:] if not t.startswith("XS:")]
            a = int(next(t for t in tags if t.startswith("AS:"))[5:])
            f[4] = str(R.mapq_v2(a, None, sc.min_score(len(f[9]))))
            rec = "\t".join(f[:11] + tags)
        dropped.append(dict(s, records=[rec]))
    v = R.Judge(cfg, gen).judge(dropped)
    assert v["field_faults"] == 0, v["faults"]
    assert 100.0 * v["repeat_short"] / v["repeat"] > \
        limits()["repeat_xs_pct"]["limit"]


def test_siblings_are_the_same_place_of_the_other_copies(served):
    """A read cut without errors from inside a copy scores at each other
    copy's same place (on the right strand) as two copies 0-1% diverged
    each from their unit allow: a tenth of its bases mismatched at most
    (at a wrong place or strand three quarters mismatch)."""
    cfg, gen, _ = served
    judge = R.Judge(cfg, gen)
    sc = R.Scoring(cfg)
    rc = dict(cfg["reads"], error_rate=1e-9, mutation_rate=0.0)
    r = gmod.simulate_unpaired(gen, rc, np.random.default_rng(4), 4000)
    n = 0
    for i in range(4000):
        t = dict(chrom=int(r.chrom[i]), start=int(r.start[i]),
                 span=int(r.span[i]), fw=bool(r.fw[i]))
        sibs = judge.siblings(t)
        if not sibs:
            continue
        n += 1
        rd = gmod.BASES[r.codes[i]].tobytes()
        q = b"I" * len(rd)
        u = R.best_ungapped(sc, gen, [rd] * len(sibs), [q] * len(sibs), sibs)
        assert u.min() >= -6 * 10, (t, u)
    assert n > 50


def test_the_control_fails_through_the_runs_checks(served):
    """The control's records, judged by run.finish as a run's are, come
    out not correct: they fail gapped_below_pct and repeat_xs_pct."""
    from portbench.control import control_results
    cfg, gen, _ = served
    cell = run.Cell("tiny.stream", cfg, dict(
        run.load_traffic("stream"), chunk=64, sample=1.0), 1,
        [{"name": "reads_per_s", "unit": "reads/s"}], [], limits())
    out, lines = run.finish(cell, gen, control_results(cell, gen, 3, 512),
                            1.0, 0.0, 0, {}, None, None, None, None, "cpu",
                            1, False)
    assert not out["correct"], lines
    c = out["checks"]
    assert c["field_faults"]["value"] == 0 and c["unanswered"]["value"] == 0
    for k in ("gapped_below_pct", "repeat_xs_pct"):
        assert c[k]["value"] > c[k]["limit"], lines


def test_best_at_origin_matches_a_plain_loop():
    """The vectorised dynamic program equals a cell-by-cell loop of the
    same recurrence on a few reads."""
    cfg = tiny_config("tiny_se100")
    gen = gmod.make_genome(cfg)
    sc = R.Scoring(cfg)
    r = gmod.simulate_unpaired(gen, dict(cfg["reads"], mutation_rate=0.02),
                               np.random.default_rng(9), 12)
    reads = [gmod.BASES[c].tobytes() for c in r.codes]
    quals = [b"5" * len(x) for x in reads]
    truths = [dict(chrom=int(r.chrom[i]), start=int(r.start[i]),
                   span=int(r.span[i]), fw=bool(r.fw[i])) for i in range(12)]
    got = R.best_at_origin(sc, gen, reads, quals, truths, pad=8)
    for i in range(12):
        rd, q = reads[i], quals[i]
        if not truths[i]["fw"]:
            rd, q = R.revcomp(rd), q[::-1]
        chrom = gen.chrom(truths[i]["chrom"])
        lo = truths[i]["start"] - 8
        ref = gmod.BASES[chrom[lo: lo + len(rd) + 16 + 32]].tobytes()
        assert got[i] == _loop_best(sc, rd, sc.mm_pen(q), ref)


def _loop_best(sc, rd, pen, ref):
    NEG = -10**9
    L, W = len(rd), len(ref)
    ro, re_ = sc.rdg[0] + sc.rdg[1], sc.rdg[1]
    fo, fe = sc.rfg[0] + sc.rfg[1], sc.rfg[1]
    H = [0] * (W + 1)
    F = [NEG] * (W + 1)
    for i in range(L):
        ok = sc.gbar <= i < L - sc.gbar
        Hn, Fn, base = [NEG] * (W + 1), [NEG] * (W + 1), [NEG] * (W + 1)
        for j in range(W + 1):
            d = H[j - 1] + (0 if rd[i] == ref[j - 1] else -int(pen[i])) \
                if j else NEG
            Fn[j] = max(H[j] - fo, F[j] - fe) if ok else NEG
            base[j] = max(d, Fn[j])
        e = NEG
        for j in range(W + 1):
            e = max(base[j - 1] - ro, e - re_) if ok and j else NEG
            Hn[j] = max(base[j], e)
        H, F = Hn, Fn
    return max(H)
