"""The traffic is the same for the same seed and differs across seeds."""
import numpy as np

from portbench import genome as gmod
from portbench.traffic import ReadSource, load_traffic

from tinycells import tiny_config


def _gen(cfg):
    return gmod.make_genome(cfg)


def test_reads_follow_the_seed():
    cfg = tiny_config("tiny_se100")
    gen = _gen(cfg)
    tr = load_traffic("stream")
    a = ReadSource(gen, cfg, tr, 2**31 + 17, 1).chunk(300)
    b = ReadSource(gen, cfg, tr, 2**31 + 17, 1).chunk(300)
    c = ReadSource(gen, cfg, tr, 2**31 + 18, 1).chunk(300)
    assert a[0] == b[0] and a[1] == b[1]
    assert a[0] != c[0]


def test_genome_follows_its_config_only():
    cfg = tiny_config("tiny_se100")
    g1, g2 = _gen(cfg), _gen(cfg)
    assert np.array_equal(g1.seq, g2.seq)
    gc = np.isin(g1.seq, (1, 2)).mean()
    assert abs(gc - cfg["genome"]["gc"]) < 0.01


def test_reads_carry_their_truth():
    cfg = tiny_config("tiny_se100")
    gen = _gen(cfg)
    rng = np.random.default_rng(3)
    r = gmod.simulate_unpaired(gen, cfg["reads"], rng, 2000)
    clean = ~r.indel
    for i in np.nonzero(clean)[0][:200]:
        ref = gen.chrom(int(r.chrom[i]))[r.start[i]:r.start[i] + r.span[i]]
        read = r.codes[i] if r.fw[i] else gmod.COMP[r.codes[i]][::-1]
        # wgsim's 2% errors and 0.085% substitutions: few mismatches
        assert (ref != read).sum() <= 12


def test_genome_records_its_repeat_copies():
    """Each planted copy is where the genome says, on its strand: two
    copies of a family read alike up to their divergence (0-1% each)."""
    cfg = tiny_config("tiny_se100")
    gen = _gen(cfg)
    fams = cfg["genome"]["repeats"]
    assert len(gen.copies) == sum(f["copies"] for f in fams)
    for f in range(len(fams)):
        cs = [c for c in gen.copies if c[0] == f]
        units = []
        for _, chrom, start, n, fwd in cs:
            assert n == fams[f]["length"]
            s = gen.chrom(chrom)[start:start + n]
            units.append(s if fwd else gmod.COMP[s][::-1])
        for u in units[1:]:
            assert (u != units[0]).mean() <= 0.02
