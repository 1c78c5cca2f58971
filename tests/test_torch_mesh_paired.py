"""Pairs and the server's device groups over the port's 'dp' mesh, against
the JAX package on the CPU (JAX on the 8 virtual CPU devices of
tests/conftest.py, the port on logical CPU shards). Tolerance 0: the
paired SAM over a mesh equals the JAX PairedAligner's whose `up` runs on a
mesh (as the JAX server shares it) and the port's one-device SAM, with
mate rescue taking place; two mesh workers of the server answer a pack
with the same bytes, and as a one-device worker does."""
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.align import paired as jpaired  # noqa: E402
from bowtie2_server_tpu.align.pipeline import (  # noqa: E402
    SearchPolicy as JPolicy, UnpairedAligner as JAligner)
from bowtie2_server_tpu.io.fastq import make_batch as j_make_batch  # noqa
from bowtie2_server_tpu.io.sam import sam_record as j_sam  # noqa: E402
from bowtie2_server_tpu.parallel.mesh import make_mesh  # noqa: E402
from bowtie2_server_tpu.utils.presets import preset_params  # noqa: E402
from bowtie2_server_tpu_torch.align import paired as tpaired  # noqa: E402
from bowtie2_server_tpu_torch.align.pipeline import SearchPolicy  # noqa
from bowtie2_server_tpu_torch.io.fastq import make_batch  # noqa: E402
from bowtie2_server_tpu_torch.io.sam import sam_record  # noqa: E402
from bowtie2_server_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from bowtie2_server_tpu_torch.server.bt2srv import Bt2Server  # noqa: E402
from bowtie2_server_tpu_torch.server.dispatch import (  # noqa: E402
    AlignDispatcher)
from test_torch_paired import _sam_lines, workload  # noqa: E402,F401

N_PAIRS = 200
CPU = torch.device("cpu")


def test_paired_sam_over_mesh_equal(workload, monkeypatch):
    """Exact: PairedAligner(mesh=Mesh([cpu] * 2)) SAM equals the JAX
    PairedAligner's with `pal.up = UnpairedAligner(mesh=make_mesh(2))`
    and the port's one-device SAM; mate rescue ran its rectangle DP."""
    jidx, tidx, (names, (s1, q1), (s2, q2)) = workload
    names, s1, q1, s2, q2 = (x[:N_PAIRS] for x in (names, s1, q1, s2, q2))
    sc, pol = preset_params(None, False)
    jpal = jpaired.PairedAligner(jidx, scoring=sc, policy=JPolicy(**pol),
                                 engine="xla")
    jpal.up = JAligner(jidx, scoring=sc, policy=JPolicy(**pol),
                       engine="xla", mesh=make_mesh(2))
    want = _sam_lines(jpal.align_batch(j_make_batch(names, s1, q1),
                                       j_make_batch(names, s2, q2)),
                      j_sam, jidx.ref_names)
    rescues = []
    orig = tpaired.sw_align_batch
    monkeypatch.setattr(tpaired, "sw_align_batch", lambda *a, **k: (
        rescues.append(len(a[0])), orig(*a, **k))[1])
    b1, b2 = make_batch(names, s1, q1), make_batch(names, s2, q2)
    got = {}
    for tag, where in (("mesh", dict(mesh=Mesh([CPU] * 2))),
                       ("one", dict(device="cpu"))):
        tpal = tpaired.PairedAligner(tidx, scoring=sc,
                                     policy=SearchPolicy(**pol), **where)
        got[tag] = _sam_lines(tpal.align_batch(b1, b2), sam_record,
                              tidx.ref_names)
    assert tpal.up.mesh is None
    assert got["mesh"] == want
    assert got["one"] == want
    assert len(rescues) == 2, "mate rescue never ran its rectangle DP"
    yt = [ln.rsplit("YT:Z:", 1)[1][:2] for ln in got["mesh"]]
    assert {"CP", "UP", "DP"} <= set(yt)


def test_two_mesh_groups_align_identically(workload):
    """The twin of tests/test_dispatch.py's device-group test on a
    synthetic genome: two workers, each a mesh of two logical CPU shards
    built as Bt2Server builds a group's aligners, answer the same pack of
    unpaired and paired rows with the same bytes, and those of a
    one-device worker."""
    _, tidx, (names, (s1, q1), (s2, q2)) = workload
    rows = [(names[i] + "/1", s1[i], q1[i], None, None, None)
            for i in range(40)]
    rows += [(names[i] + "/1", s1[i], q1[i], names[i] + "/2", s2[i], q2[i])
             for i in range(40, 60)]
    workers = []
    for where in (dict(mesh=Mesh([CPU] * 2)), dict(mesh=Mesh([CPU] * 2)),
                  dict(device="cpu")):
        pal = tpaired.PairedAligner(tidx, **where)
        workers.append((pal.up, pal))
    d = AlignDispatcher(workers)
    try:
        outs = [d.submit(c, Bt2Server._align_pack, rows,
                         tidx.ref_names).result(timeout=600)
                for c in range(len(workers))]
    finally:
        d.shutdown()
    assert workers[0][0].mesh.size == 2
    assert outs[0] == outs[1] == outs[2]
    assert outs[0].count(b"@CO END READ") == len(rows)
