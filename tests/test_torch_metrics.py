"""The port's --met TSV, --dp-log/--log-dp-opp problem logs, -t stage times
and the dp subcommand against the JAX CLI on the CPU, on the synthetic
genome of tests/test_torch_cli.py (the JAX package's own test of these,
tests/test_qual_encodings.py, reads the lambda genome): the TSV's counter
columns equal (the time and memory columns aside: the memory columns sum
each package's own arrays), the logged problems equal line by line, and dp
on them prints the same lines."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.__main__ import main as jax_main  # noqa: E402
from bowtie2_server_tpu_torch.__main__ import main as port_main  # noqa
from bowtie2_server_tpu_torch.io.metrics import PERF_COLUMNS  # noqa: E402
from test_torch_cli import N_PAIRS, N_READS, inputs, run_both  # noqa

# columns that are not counters: wall time, and memory peaks (the process's
# RSS, and each package's own index and SA arrays)
NOT_COUNTERS = {"Time", "MemPeak", "EbwtMemPeak", "ResolveMemPeak"}


def tsv_counters(text):
    """The TSV's counter columns, line by line."""
    lines = text.splitlines()
    assert lines[0].split("\t") == list(PERF_COLUMNS)
    keep = [k for k, c in enumerate(PERF_COLUMNS) if c not in NOT_COUNTERS]
    return [[row.split("\t")[k] for k in keep] for row in lines[1:]]


def column(rows, name):
    keep = [c for c in PERF_COLUMNS if c not in NOT_COUNTERS]
    return [int(r[keep.index(name)]) for r in rows]


CASES = {
    # three batches of the fused path, each a TSV line
    "fused": (["-U", "reads.fq", "--batch", "40"], "--dp-log", "dp.txt"),
    # --local: every winner goes through the host traceback (DP16ExBt*)
    "local": (["-U", "reads.fq", "--local"], "--dp-log", "dp.txt"),
    # the host path (-k above 1024)
    "host": (["-U", "reads.fq", "-k", "2000"], "--dp-log", "dp.txt"),
    # pairs: both mates' counters and the mate-rescue problems
    "paired": (["-1", "m1.fq", "-2", "m2.fq"], "--log-dp-opp", "opp.txt"),
}


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_met_tsv_and_dp_log_equal_jax(inputs, tmp_path, monkeypatch,  # noqa
                                      capsys, case):
    _, f = inputs
    argv, log_opt, log = case
    argv = [str(f[a]) if a in f else a for a in argv]
    got = run_both(inputs, tmp_path, monkeypatch, capsys,
                   [*argv, "--met-file", "met.tsv", "--met-read", log_opt,
                    log, "-t"], outputs=("met.tsv", log))
    (jsam, _, jout, jt), (tsam, _, tout, tt) = got["jax"], got["port"]
    assert tsam == jsam
    assert tt == jt and "Overall time" in tt
    if log == "dp.txt":
        assert "Time dp" in tt if "-k" in argv else "Time device_fetch" in tt
    want, have = tsv_counters(jout["met.tsv"]), tsv_counters(tout["met.tsv"])
    assert have == want
    assert tout[log] == jout[log]
    assert tout[log].count("\n") > 4
    assert column(have, "Read")[-1] == (2 * N_PAIRS if log == "opp.txt"
                                        else N_READS)
    if "-k" not in argv:   # the host path fills only the outcome columns
        assert column(have, "SeedSearch")[-1] > 0
    if "--local" in argv:
        assert column(have, "DP16ExBtSucc")[-1] > 0
    if log == "opp.txt":
        assert column(have, "DP16MateDps")[-1] > 0


def _dp_lines(fn, path, capsys, opts):
    capsys.readouterr()
    fn(["dp", str(path), *opts])
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_dp_on_logged_problems_equal_jax(inputs, tmp_path, monkeypatch,  # noqa
                                         capsys, local):
    """--dp-log's problems (the banded windows of the fused path and the
    rectangles of the run-boundary candidates) through the JAX dp and the
    port's."""
    _, f = inputs
    monkeypatch.chdir(tmp_path)
    port_main(["align", "-x", str(inputs[0] / "idx"), "-U",
               str(f["reads.fq"]), "-S", "o.sam", "--dp-log", "dp.txt",
               "--device", "cpu"])
    rows = (tmp_path / "dp.txt").read_text().splitlines()
    assert len(rows) > 100
    opts = ["--local"] if local else []
    want = _dp_lines(jax_main, tmp_path / "dp.txt", capsys, opts + ["--cpu"])
    got = _dp_lines(port_main, tmp_path / "dp.txt", capsys,
                    opts + ["--device", "cpu"])
    assert got == want
    assert len(got) == len(rows)
    scores = np.array([int(ln.split("\t")[0]) for ln in got])
    assert (scores > (0 if local else -60)).mean() > 0.9
