"""The traceback kernel (ops/csrc/sw_banded_tb.cu) on the card: bit for bit
the numpy oracle `banded_traceback` on random problems, the per-read
selection loop traces on it one candidate at a time, and a served pack of
the benchmark configuration's reads gives the same SAM and the same --met
traceback counts on 'cuda' as on 'cpu'. Every test here needs a
CUDA device and skips without one; none imports JAX, so on a machine with
the card run them with
    python -m pytest --noconftest tests/test_torch_sw_banded_tb.py -q
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bowtie2_server_tpu_torch.ops import kernels  # noqa: E402
from bowtie2_server_tpu_torch.ops import sw as tsw  # noqa: E402
from bowtie2_server_tpu_torch.ops import sw_banded as tsb  # noqa: E402
from torch_tiles import CFGS, indel_reads, traceback_problems  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# problems a (band, scoring) case: 3 bands x 4 scorings x 850 = 10200
PROBLEMS = 850


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def end_cells(rd, mm, band, lens, cfg, K, dev, rng):
    """The fill kernels' end cells (banded_dp on the card), one in five
    moved: end-to-end to another band cell of the last row, --local to any
    cell of any row (mostly before the last)."""
    def put(a):
        return torch.from_numpy(
            np.ascontiguousarray(a.T.astype(np.int32))).to(dev)
    _, bi, bk = tsb.banded_dp(cfg, K, put(rd), put(mm),
                              torch.from_numpy(lens.copy()).to(dev),
                              put(band))
    bi, bk = bi.cpu().numpy().copy(), bk.cpu().numpy().copy()
    move = rng.random(len(lens)) < 0.2
    bk[move] = rng.integers(0, K, int(move.sum()))
    if cfg.local:
        bi[move] = (rng.random(int(move.sum())) * lens[move]).astype(int)
    return bi, bk


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("K", tsb.TB_BANDS)
def test_traceback_kernel_equals_oracle(name, K, cuda_device):
    cfg = tsw.SwConfig(**CFGS[name])
    seed = 1000 * K + list(CFGS).index(name)
    rd, mm, band, lens = traceback_problems(seed, PROBLEMS, K)
    rng = np.random.default_rng(seed)
    bi, bk = end_cells(rd, mm, band, lens, cfg, K, cuda_device, rng)
    if cfg.local:
        assert (bi < lens - 1).any()
    n0 = kernels.LAUNCHES["sw_banded_tb"]
    got, on_card = tsb.banded_traceback_batch(rd, mm, band, lens, bi, bk,
                                              cfg, K, device=cuda_device)
    assert kernels.LAUNCHES["sw_banded_tb"] == n0 + 1
    assert on_card.all()
    gaps = 0
    for t in range(len(lens)):
        rl = int(lens[t])
        want = tsb.banded_traceback(rd[t, :rl], mm[t, :rl],
                                    band[t, : rl + K], cfg, int(bi[t]),
                                    int(bk[t]), K=K)
        assert got[t] == want, (t, rl, int(bi[t]), int(bk[t]))
        gaps += any(e[0] != "M" for e in want[0])
    assert gaps > len(lens) // 4


def test_traceback_kernel_flags_what_it_cannot_walk(cuda_device):
    """An end cell outside its problem goes to the oracle, which raises
    as it does on the host."""
    rd, mm, band, lens = traceback_problems(3, 4, 64)
    cfg = tsw.SwConfig()
    bi = lens - 1
    bk = np.array([5, 70, 6, 7])
    with pytest.raises(IndexError):
        tsb.banded_traceback_batch(rd, mm, band, lens, bi, bk, cfg, 64,
                                   device=cuda_device)


def test_served_pack_cuda_equals_cpu(cuda_device, tmp_path):
    """One pack of 4096 reads of the benchmark's configuration (its genome
    model cut to 1 Mbp, its read model with ten times the mutations, so
    that about one read in ten carries a planted indel) to
    Bt2Server(device='cuda') and to the CPU server: the same response, the
    same Bt/BtSucc/BtFail/BtCell counts, and the card's tracebacks on the
    kernel."""
    import sys
    sys.path.insert(0, str(ROOT))
    from bowtie2_server_tpu_torch.index.build import build_index
    from bowtie2_server_tpu_torch.server.bt2srv import Bt2Server
    from portbench import genome as gmod
    from torch_serving import raw_request, serving
    cfg = json.loads((ROOT / "portbench/configs/ecoli_se100.json")
                     .read_text())
    cfg["genome"]["sequences"] = [["NC_000913.3", 1_000_000]]
    gen = gmod.make_genome(cfg)
    (tmp_path / "genome.fa").write_bytes(gen.fasta())
    build_index(str(tmp_path / "genome.fa")).save(str(tmp_path / "genome"))
    rc = dict(cfg["reads"], mutation_rate=0.01)
    reads = gmod.simulate_unpaired(gen, rc, np.random.default_rng(16), 4096)
    assert reads.indel.mean() > 0.05
    qual = bytes([gmod.quality_char(rc)]) * int(rc["length"])
    lines = [b"r%d\t%s\t%s" % (k, gmod.BASES[c].tobytes(), qual)
             for k, c in enumerate(reads.codes)]
    bodies, ctrs = {}, {}
    for dev in ("cpu", "cuda"):
        srv = Bt2Server(str(tmp_path / "genome"), batch_size=4096,
                        device=dev)
        try:
            with serving(srv) as port:
                kernels.reset_launches()
                _, bodies[dev] = raw_request(port, lines)
                launches = dict(kernels.LAUNCHES)
            ctrs[dev] = dict(srv.up.bt_ctr)
            tb_card = srv.up.tb_card
        finally:
            srv.close()
    assert bodies["cuda"] == bodies["cpu"]
    assert bodies["cuda"].count(b"@CO END READ\t") == len(lines)
    assert ctrs["cuda"] == ctrs["cpu"]
    assert launches["sw_banded_tb"] >= 1
    assert ctrs["cuda"]["bt"] > 100 and tb_card >= 0.9 * ctrs["cuda"]["bt"]


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_slow_loop_traces_on_the_card(local, cuda_device):
    """The per-read selection loop (`select_unpaired`) over every read of
    a batch with planted indels (`torch_tiles.indel_reads`; 1024 reads
    end-to-end, 256 in --local): each candidate it commits is traced
    alone, and on the card at least 99% of those tracebacks run on the
    kernel; the records and the Bt/BtSucc/BtFail/BtCell counts are the
    CPU's."""
    from bowtie2_server_tpu_torch.align.pipeline import (SearchPolicy,
                                                         UnpairedAligner)
    from bowtie2_server_tpu_torch.index.build import build_index
    from bowtie2_server_tpu_torch.io.fastq import make_batch
    from bowtie2_server_tpu_torch.io.sam import sam_record
    from bowtie2_server_tpu_torch.utils.presets import preset_params
    fasta, names, seqs, quals = indel_reads(256 if local else 1024)
    idx = build_index(fasta)
    sc, pol = preset_params(None, local)
    batch = make_batch(names, seqs, quals)
    sams, ctrs, card = {}, {}, {}
    for dev in ("cpu", "cuda"):
        al = UnpairedAligner(idx, scoring=sc, policy=SearchPolicy(**pol),
                             device=dev)
        st = al.collect(batch)
        for i in range(len(names)):
            al.select_unpaired(st, i)
        sams[dev] = [sam_record(st.recs[i], idx.ref_names)
                     for i in range(len(names))]
        ctrs[dev], card[dev] = dict(al.bt_ctr), al.tb_card
    assert sams["cuda"] == sams["cpu"]
    assert ctrs["cuda"] == ctrs["cpu"]
    assert ctrs["cuda"]["bt"] > (200 if local else 100)
    assert card["cpu"] == 0 and card["cuda"] >= 0.99 * ctrs["cuda"]["bt"]
