"""The port's serving path on the CPU (device 'cpu', the plain torch
versions of the kernels) against the JAX package: the dispatcher, the
device groups, `_align_pack` byte-identical to the JAX server's on a mixed
pack, the config block, the BT2SRV socket protocol (banner, /config, 400,
405, raw tab6 requests, the port's and the JAX client, concurrent
clients, --passthrough, the --remote-worker relay, a failing pack), the
client's request bytes equal to the JAX client's, and the CLI's `server`,
`client` and `align --server-host/--server-port` in subprocesses.

Exactness is checked on requests with fixed names (raw tab6) or on
`_align_pack` directly: the per-read random seed hashes the read's name,
and the client's %04X wire names depend on which slots the server has
answered already."""
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the test workers share the cores: one intra-op thread each, so that
# torch's thread pools do not contend with each other and with XLA's
torch.set_num_threads(1)

from bowtie2_server_tpu.align.paired import (  # noqa: E402
    PairedAligner as JPaired)
from bowtie2_server_tpu.align.pipeline import (  # noqa: E402
    SearchPolicy as JPolicy, UnpairedAligner as JAligner)
from bowtie2_server_tpu.index.build import (  # noqa: E402
    build_index as j_build_index)
from bowtie2_server_tpu.server import bt2srv as jsrv  # noqa: E402
from bowtie2_server_tpu.server.client import (  # noqa: E402
    Bt2Client as JClient)
from bowtie2_server_tpu.utils import dna  # noqa: E402
from bowtie2_server_tpu.utils.presets import (  # noqa: E402
    preset_params as j_preset_params)
from bowtie2_server_tpu_torch.align.paired import PairedAligner  # noqa
from bowtie2_server_tpu_torch.align.pipeline import SearchPolicy  # noqa
from bowtie2_server_tpu_torch.index import bt2_writer  # noqa: E402
from bowtie2_server_tpu_torch.index.fm import FmIndex  # noqa: E402
from bowtie2_server_tpu_torch.server import bt2srv as tsrv  # noqa: E402
from bowtie2_server_tpu_torch.server.client import Bt2Client  # noqa: E402
from bowtie2_server_tpu_torch.server.dispatch import (  # noqa: E402
    AlignDispatcher, make_device_groups)
from bowtie2_server_tpu_torch.utils.presets import preset_params  # noqa
from torch_serving import http, raw_request, serving, tab6_line  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CHROM_LEN = 60_000
BATCH = 64          # the test servers' pack size: requests span packs


# ------------------------------------------------------------ dispatcher -

def test_round_robin_fairness():
    """A connection with many queued packs cannot starve a later one:
    with one worker, packs interleave across connections."""
    order = []
    lock = threading.Lock()

    def work(_worker, tag):
        with lock:
            order.append(tag)
        time.sleep(0.01)
        return tag

    d = AlignDispatcher([object()])
    futs = [d.submit(1, work, ("c1", k)) for k in range(6)]
    futs += [d.submit(2, work, ("c2", k)) for k in range(2)]
    for f in futs:
        f.result(timeout=10)
    d.shutdown()
    assert order.index(("c2", 0)) < 5, order


def test_per_connection_order_and_results():
    def work(_w, tag):
        time.sleep(0.002 * (tag[1] % 3))
        return tag

    d = AlignDispatcher([object(), object()])
    futs = {c: [d.submit(c, work, (c, k)) for k in range(8)]
            for c in (1, 2, 3)}
    for c, fl in futs.items():
        assert [f.result(timeout=10) for f in fl] == [(c, k) for k in range(8)]
    assert d.n_workers == 2
    d.shutdown()


def test_worker_exception_propagates():
    def boom(_w):
        raise ValueError("pack failed")

    d = AlignDispatcher([object()])
    with pytest.raises(ValueError, match="pack failed"):
        d.submit(1, boom).result(timeout=10)
    # the worker survives a failed pack
    assert d.submit(1, lambda _w: 7).result(timeout=10) == 7
    d.shutdown()


def test_device_groups_cpu():
    assert make_device_groups(1, "cpu") == [torch.device("cpu")]
    assert make_device_groups(0, torch.device("cpu")) == [torch.device("cpu")]
    with pytest.raises(ValueError,
                       match=r"^2 workers need >= 2 devices \(have 1\)$"):
        make_device_groups(2, "cpu")


@pytest.mark.parametrize("n_cards,n_workers,device,want", [
    (1, 1, "cuda", ["cuda:0"]),
    (2, 2, "cuda", ["cuda:0", "cuda:1"]),
    (3, 2, "cuda", ["cuda:0", "cuda:1"]),
    (4, 1, "cuda:2", ["cuda:2"]),
])
def test_device_groups_cards(monkeypatch, capsys, n_cards, n_workers, device,
                             want):
    """One card a worker; cards left over are named, never dropped in
    silence."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    got = make_device_groups(n_workers, device)
    assert got == [torch.device(w) for w in want]
    err = capsys.readouterr().err
    assert ("cuda:2" in err and "idle" in err) == (n_cards == 3)


@pytest.mark.parametrize("n_cards,n_workers,want,idle", [
    (2, 1, [[0, 1]], []),
    (4, 2, [[0, 1], [2, 3]], []),
    (8, 3, [[0, 1], [2, 3], [4, 5]], [6, 7]),
    (3, 2, [[0], [1]], [2]),
])
def test_device_groups_mesh_refused(monkeypatch, capsys, n_cards, n_workers,
                                    want, idle):
    """A group of more than one card is the JAX server's 'dp' mesh (it was
    refused before the port had one): one worker over several cards gets
    one mesh over all of them, N workers each cards // N, a Mesh when that
    is more than one card and the card itself otherwise; the cards left
    over are named idle on stderr."""
    from bowtie2_server_tpu_torch.parallel.mesh import Mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    got = make_device_groups(n_workers, "cuda")
    assert len(got) == n_workers
    for g, w in zip(got, want):
        cards = [torch.device("cuda", k) for k in w]
        if len(w) > 1:
            assert isinstance(g, Mesh) and list(g.devices) == cards
        else:
            assert g == cards[0]
    err = capsys.readouterr().err
    assert ("idle" in err) == bool(idle)
    for k in idle:
        assert f"cuda:{k}" in err


def test_device_groups_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match=r"\(have 0\)"):
        make_device_groups(1, "cuda")


# ------------------------------------------------------------- workload -

def _mutate(rng, r, nmm):
    for _ in range(int(rng.integers(0, nmm + 1))):
        r[rng.integers(0, len(r))] = rng.integers(0, 4)
    return r


def _qual(rng, n):
    return bytes(rng.integers(35, 74, n).astype(np.uint8))


def unpaired_rows(rng, chroms, n, lens, prefix, nmm=2):
    """(rows, origin): tab6 rows (name, seq, qual, None, None, None) of
    reads with 0..nmm substitutions, half reverse complemented; origin
    maps a name to (chromosome, 1-based position, forward?)."""
    rows, origin = [], {}
    for i in range(n):
        rl = int(lens[i % len(lens)])
        ci = int(rng.integers(0, len(chroms)))
        s = int(rng.integers(0, CHROM_LEN - rl))
        r = _mutate(rng, chroms[ci][s : s + rl].copy(), nmm)
        fw = bool(rng.random() < 0.5)
        if not fw:
            r = dna.revcomp(r)
        name = f"{prefix}{i}"
        rows.append((name, dna.decode(r).encode(), _qual(rng, rl),
                     None, None, None))
        origin[name] = (f"chr{ci}", s + 1, fw)
    return rows, origin


def pair_rows(rng, chroms, n, prefix, rl=60):
    """(rows, origin) of FR pairs (fragment 250-400 bp, 0-2 substitutions
    a mate): rows (name/1, seq1, qual1, name/2, seq2, qual2), origin maps
    the pair's name to (chromosome, mate 1's and mate 2's 1-based
    position)."""
    rows, origin = [], {}
    for i in range(n):
        ci = int(rng.integers(0, len(chroms)))
        frag = int(rng.integers(250, 400))
        st = int(rng.integers(0, CHROM_LEN - frag))
        g = chroms[ci]
        m1 = _mutate(rng, g[st : st + rl].copy(), 2)
        m2 = _mutate(rng, dna.revcomp(g[st + frag - rl : st + frag]), 2)
        rows.append((f"{prefix}{i}/1", dna.decode(m1).encode(),
                     _qual(rng, rl), f"{prefix}{i}/2",
                     dna.decode(m2).encode(), _qual(rng, rl)))
        origin[f"{prefix}{i}"] = (f"chr{ci}", st + 1, st + frag - rl + 1)
    return rows, origin


def mixed_lines(chroms, seed=3, prefix=""):
    """One pack's lines: 50-60 bp and 18-45 bp reads (the fast and the
    general shape), pairs, a read with Ns, a row without quals and a tab5
    line (name, seq1, qual1, seq2, qual2), as the client may send. (Reads
    are short here because the plain torch DP on the CPU costs seconds a
    pack at 100 bp.)"""
    rng = np.random.default_rng(seed)
    u, _ = unpaired_rows(rng, chroms, 40, (60, 50, 36, 18, 25, 45),
                         prefix + "u")
    p, _ = pair_rows(rng, chroms, 16, prefix + "p")
    lines = [tab6_line(r) for r in u]
    f = lines[5].split(b"\t")
    f[1] = f[1][:10] + b"NNN" + f[1][13:]
    lines[5] = b"\t".join(f)
    lines += [tab6_line(r) for r in p]
    lines.insert(20, prefix.encode() + b"noqual\t" + u[3][1])
    lines.insert(30, b"\t".join([prefix.encode() + b"tab5", u[7][1],
                                  u[7][2], p[2][4], p[2][5]]))
    return lines


# -------------------------------------------------------------- fixtures -

@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Two chromosomes of 60 kbp: the index built and saved by the JAX
    package, loaded by the port, and the same FASTA written as a .bt2 set
    by the port. Returns (chromosome codes, JAX index, port index, {format:
    base}, FASTA path)."""
    rng = np.random.default_rng(23)
    chroms = [rng.integers(0, 4, CHROM_LEN).astype(np.uint8)
              for _ in range(2)]
    fa_text = "".join(f">chr{i} extra words\n{dna.decode(c)}\n"
                      for i, c in enumerate(chroms))
    d = tmp_path_factory.mktemp("torch_server")
    fa = d / "genome.fa"
    fa.write_text(fa_text)
    jidx = j_build_index(fa_text)
    jidx.save(d / "genome")
    bt2_writer.write_bt2_from_fasta(str(fa), str(d / "bt2genome"))
    return (chroms, jidx, FmIndex.load(d / "genome"),
            {"native": str(d / "genome"), "bt2": str(d / "bt2genome")}, fa)


def ref_names(idx):
    return [n.split()[0] if n.split() else n for n in idx.ref_names]


def port_worker(idx, local=False):
    sc, polkw = preset_params(None, local)
    pal = PairedAligner(idx, scoring=sc, policy=SearchPolicy(**polkw),
                        device="cpu")
    return pal.up, pal


@pytest.fixture(scope="module")
def server(genome):
    srv = tsrv.Bt2Server(genome[3]["native"], batch_size=BATCH,
                         device="cpu")
    with serving(srv) as port:
        yield srv, port
    srv.close()


# ------------------------------------------------------------ _align_pack -

@pytest.mark.parametrize("mode", ["e2e", "local"])
def test_align_pack_equals_jax(genome, mode):
    """One pack of unpaired rows of 18-100 bp (fast and general shape),
    pairs, a read with Ns, a row without quals and a tab5 line: the port's
    _align_pack (device 'cpu') returns the JAX server's bytes."""
    chroms, jidx, tidx = genome[:3]
    local = mode == "local"
    lines = mixed_lines(chroms)
    rows = [tsrv._parse_tab6(line) for line in lines]
    assert rows == [jsrv._parse_tab6(line) for line in lines]
    sc, polkw = j_preset_params(None, local)
    jpol = JPolicy(**polkw)
    jup = JAligner(jidx, scoring=sc, policy=jpol, engine="xla")
    jpal = JPaired(jidx, scoring=sc, policy=jpol, engine="xla")
    jpal.up = jup
    want = jsrv.Bt2Server._align_pack((jup, jpal), rows, ref_names(jidx))
    got = tsrv.Bt2Server._align_pack(port_worker(tidx, local), rows,
                                     ref_names(tidx))
    assert got == want
    assert got.count(b"@CO END READ\t") == len(rows)
    n_pairs = sum(r[3] is not None for r in rows)
    assert len(got.split(b"\n")) == 2 * len(rows) + n_pairs + 1


@pytest.mark.parametrize("preset", [None, "very-fast", "fast", "sensitive",
                                    "very-sensitive"])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("prefix", [True, False])
def test_config_lines_equal_jax(preset, local, prefix):
    """The config block of the port's server for a preset and policy is
    the JAX server's, byte for byte (the constructors derive `pol` the
    same way from preset_params)."""
    _, jkw = j_preset_params(preset, local)
    _, tkw = preset_params(preset, local)
    want = jsrv.Bt2Server.config_lines(
        SimpleNamespace(pol=JPolicy(**jkw), index_name="hg38 draft"), prefix)
    got = tsrv.Bt2Server.config_lines(
        SimpleNamespace(pol=SearchPolicy(**tkw), index_name="hg38 draft"),
        prefix)
    assert got == want
    assert got.startswith(b"X-BT2SRV-Version: 2.5.4\r\n" if prefix
                          else b"BT2SRV-Version: 2.5.4\r\n")


def test_server_config_and_constants(server):
    srv, _ = server
    assert tsrv.VERSION == jsrv.VERSION and \
        tsrv.FLUSH_READS == jsrv.FLUSH_READS == 4096
    want = jsrv.Bt2Server.config_lines(
        SimpleNamespace(pol=JPolicy(**j_preset_params(None, False)[1]),
                        index_name="genome"), True)
    assert srv.config_lines(True) == want
    # one copy of the index a device: the unpaired rows run on the
    # PairedAligner's own UnpairedAligner
    assert srv.pal.up is srv.up and srv.up.device == torch.device("cpu")
    assert srv._dispatch.n_workers == 1


# ---------------------------------------------------------------- socket -

def test_banner_config_400_405(server):
    srv, port = server
    assert http(port, b"GET / HTTP/1.1\r\nHost: x\r\n\r\n") == (
        b"HTTP/1.1 200 OK\r\nConnection: close\r\n\r\nbowtie2 SaaS\n")
    for path in (b"/config", b"/BT2SRV/genome/config"):
        assert http(port, b"GET " + path + b" HTTP/1.1\r\nHost: x\r\n\r\n") \
            == (b"HTTP/1.1 200 OK\r\nConnection: close\r\n\r\n"
                + srv.config_lines(False))
    assert http(port, b"GET /nonsense HTTP/1.1\r\nHost: x\r\n\r\n") == (
        b"HTTP/1.1 400 Bad Request\r\nConnection: close\r\n\r\n")
    # an align request with neither chunks nor a length
    assert http(port, b"PUT /BT2SRV/genome/align HTTP/1.1\r\n\r\n").endswith(
        b"HTTP/1.1 400 Bad Request\r\nConnection: close\r\n\r\n")
    assert http(port, b"FROB / HTTP/1.1\r\nHost: x\r\n\r\n") == (
        b"HTTP/1.1 405 Method Not Allowed\nAllow: GET, POST, PUT\r\n"
        b"Connection: close\r\n\r\n")


@pytest.fixture(scope="module")
def two_packs(genome, server):
    """A raw chunked tab6 request of two packs' lines with fixed names, and
    the server's (head, body)."""
    _, port = server
    lines = (mixed_lines(genome[0], seed=4, prefix="a")
             + mixed_lines(genome[0], seed=5, prefix="b"))
    assert BATCH < len(lines) < 2 * BATCH
    return lines, raw_request(port, lines)


@pytest.mark.parametrize("chunked", [True, False])
def test_raw_request_equals_align_pack(genome, server, two_packs, chunked):
    """A raw tab6 request with fixed names (chunked: two packs; with a
    Content-Length: one) answers with the config headers and, in order,
    each pack's _align_pack bytes on a CPU worker of its own, then the
    terminator."""
    srv, port = server
    tidx = genome[2]
    if chunked:
        lines, (head, body) = two_packs
    else:
        lines = mixed_lines(genome[0], seed=6, prefix="c")
        head, body = raw_request(port, lines, chunked=False)
    assert head == (b"HTTP/1.1 200 OK\r\nConnection: close\r\n"
                    + srv.config_lines(True)
                    + b"X-BT2SRV-Terminator: 1")
    rows = [tsrv._parse_tab6(line) for line in lines]
    worker = port_worker(tidx)
    want = b"".join(tsrv.Bt2Server._align_pack(
        worker, rows[k : k + BATCH], ref_names(tidx))
        for k in range(0, len(rows), BATCH)) + b"@CO BT2SRV All Done\n"
    assert body == want


def check_records(lines, origin, pair_origin):
    """Every read answered once (a pair twice), under its restored name,
    at its planted origin and strand."""
    seen: dict[str, list] = {}
    for line in lines:
        f = line.split("\t")
        seen.setdefault(f[0], []).append(f)
    assert set(seen) == set(origin) | set(pair_origin)
    for name, (chrom, pos, fw) in origin.items():
        (f,) = seen[name]
        assert (f[2], int(f[3]), not int(f[1]) & 16) == (chrom, pos, fw), f
    for name, (chrom, p1, p2) in pair_origin.items():
        f1, f2 = seen[name]
        assert int(f1[1]) & 0x40 and int(f2[1]) & 0x80 and int(f1[1]) & 0x2
        assert (f1[2], int(f1[3]), f2[2], int(f2[3])) == (chrom, p1, chrom,
                                                          p2), (f1, f2)


def client_workload(chroms, seed, n=90, n_pairs=30, prefix="c"):
    rng = np.random.default_rng(seed)
    u, origin = unpaired_rows(rng, chroms, n, (50, 60, 55), prefix + "r",
                              nmm=1)
    p, pair_origin = pair_rows(rng, chroms, n_pairs, prefix + "p")
    rows = [r[:3] for r in u] + p
    order = np.random.default_rng(seed + 1).permutation(len(rows))
    return [rows[i] for i in order], origin, pair_origin


@pytest.mark.parametrize("client", ["port", "jax"])
def test_clients_against_port_server(genome, server, client):
    """The port's and the JAX Bt2Client both complete against the port's
    server (wire compatibility from the client side): every read answered,
    names restored, every slot freed."""
    _, port = server
    rows, origin, pair_origin = client_workload(genome[0], 41)
    cls = Bt2Client if client == "port" else JClient
    cl = cls("127.0.0.1", port, "genome")
    assert cl.config["X-BT2SRV-Index-Name"] == "genome"
    cl.send_reads(rows)
    check_records(list(cl.finish()), origin, pair_origin)
    assert not cl._slots


def test_concurrent_clients(genome, server):
    """Three connections at once, each over several packs: each gets all
    its records, in submission order, under restored names."""
    _, port = server
    loads = [client_workload(genome[0], 50 + c, n=90, n_pairs=0,
                             prefix=f"k{c}") for c in range(3)]
    results, errors = [None] * 3, []

    def run(c):
        try:
            cl = Bt2Client("127.0.0.1", port, "genome")
            cl.send_reads(loads[c][0])
            results[c] = list(cl.finish())
        except Exception as e:   # surfaced in the test's thread
            errors.append((c, e))

    threads = [threading.Thread(target=run, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    for c, (rows, origin, pair_origin) in enumerate(loads):
        assert results[c] is not None, f"client {c} hung"
        check_records(results[c], origin, pair_origin)
        names = [line.split("\t", 1)[0] for line in results[c]]
        want = []
        for r in rows:
            n = tsrv._strip_mate(r[0])
            want += [n, n] if len(r) == 6 else [n]
        assert names == want


def test_passthrough(genome, server):
    """--passthrough re-emits each read's original record (%-escaped)
    after its SAM record."""
    _, port = server
    rng = np.random.default_rng(8)
    u, _ = unpaired_rows(rng, genome[0], 8, (60,), "pt")
    rows = [r[:3] for r in u]
    origs = [b"@" + n.encode() + b" extra 50%\n" + s + b"\n+\n" + q
             for n, s, q in rows]
    cl = Bt2Client("127.0.0.1", port, "genome", passthrough=True)
    cl.send_reads([r + (o,) for r, o in zip(rows, origs)])
    lines = list(cl.finish())
    assert len(lines) == 16
    got = {sam.split("\t", 1)[0]: pt for sam, pt in zip(lines[0::2],
                                                         lines[1::2])}
    for (n, _, _), o in zip(rows, origs):
        assert got[n] == o.replace(b"%", b"%25").replace(b"\n",
                                                         b"%0A").decode()


def test_failing_pack_fails_the_connection(genome, server, monkeypatch):
    """An error in a pack reaches the client as in the JAX server: the
    connection closes without the terminator and finish() raises; no other
    device answers."""
    srv, port = server

    def boom(batch):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(srv.up, "align_batch", boom)
    rng = np.random.default_rng(9)
    u, _ = unpaired_rows(rng, genome[0], 20, (50,), "e")
    cl = Bt2Client("127.0.0.1", port, "genome")
    cl.send_reads([r[:3] for r in u])
    with pytest.raises(RuntimeError, match="Did not process all the input"):
        list(cl.finish())
    monkeypatch.undo()
    # the server goes on serving the next connection
    cl = Bt2Client("127.0.0.1", port, "genome")
    cl.send_reads([r[:3] for r in u])
    assert len(list(cl.finish())) == len(u)


def test_remote_relay_equals_local(genome, server, two_packs):
    """A server with one local worker and --remote-worker set to a second
    server gives the records that server gives alone (raw tab6 with fixed
    names, one pack on each worker)."""
    srv, port = server
    lines, (_, want) = two_packs
    n_conns = srv._conn_seq
    relay = tsrv.Bt2Server(genome[3]["native"], batch_size=BATCH,
                           device="cpu",
                           remote_workers=[f"127.0.0.1:{port}"])
    assert relay._dispatch.n_workers == 2
    try:
        with serving(relay) as rport:
            _, got = raw_request(rport, lines)
    finally:
        relay.close()
    assert srv._conn_seq == n_conns + 1     # the relayed pack's connection
    assert got == want


# ------------------------------------------------------- client requests -

def _record_requests(n_conns: int):
    """A fake BT2SRV server on an ephemeral port that records each
    connection's request bytes and answers every read with its END READ
    marker and the terminator. Returns (port, recordings, thread)."""
    lsock = socket.create_server(("127.0.0.1", 0))
    recs = []

    def serve():
        for _ in range(n_conns):
            conn, _ = lsock.accept()
            with conn:
                data = b""
                while b"\r\n\r\n" not in data:
                    data += conn.recv(4096)
                conn.sendall(b"HTTP/1.1 200 OK\r\nConnection: close\r\n"
                             b"X-BT2SRV-Terminator: 1\r\n\r\n")
                while chunk := conn.recv(1 << 16):
                    data += chunk
                recs.append(data)
                body = data.split(b"\r\n\r\n", 1)[1]
                for line in body.split(b"\n"):
                    f = line.split(b"\t")
                    if len(f) >= 3:
                        conn.sendall(b"@CO END READ\t" + f[0] + b"\n")
                conn.sendall(b"@CO BT2SRV All Done\n")
        lsock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return lsock.getsockname()[1], recs, t


def test_client_request_bytes_equal_jax(genome):
    """The request the port's client sends (handshake, chunks of 40 rows,
    %04X/1 and %04X/2 slot names, the 0-chunk) is the JAX client's, byte
    for byte."""
    rows, _, _ = client_workload(genome[0], 61, n=70, n_pairs=25)
    rows[3] = (rows[3][0], rows[3][1].decode(), rows[3][2].decode())
    port, recs, t = _record_requests(2)
    for cls in (JClient, Bt2Client):
        cl = cls("127.0.0.1", port, "idx name")
        cl.send_reads(rows)
        assert len(list(cl.finish())) == 0 and not cl._slots
    t.join(30)
    assert len(recs) == 2 and recs[1] == recs[0]
    assert recs[0].count(b"/1\t") == len(rows)
    assert recs[0].endswith(b"0\r\n\r\n")


# ------------------------------------------------------------------- CLI -

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_fastq(path, rows, mate=None):
    with open(path, "wb") as f:
        for r in rows:
            name, seq, qual = (r[:3] if mate != 2 else r[3:6])
            name = tsrv._strip_mate(name)
            f.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n" + qual
                    + b"\n")


@pytest.mark.parametrize("fmt,device_flag", [("bt2", ["--cpu"]),
                                             ("native", ["--device", "cpu"])])
def test_cli_server_client_and_drop_in(genome, tmp_path, fmt, device_flag):
    """`server` in a subprocess on a .bt2 or a .fm.npz index, driven by the
    `client` subcommand (-U, then -1/-2) and by `align --server-host
    --server-port`: every read answered under its own name, at its
    origin."""
    chroms, bases = genome[0], genome[3]
    rng = np.random.default_rng(71)
    u, origin = unpaired_rows(rng, chroms, 100, (50, 60), "q", nmm=1)
    p, pair_origin = pair_rows(rng, chroms, 40, "pp")
    _write_fastq(tmp_path / "u.fq", u)
    _write_fastq(tmp_path / "m1.fq", p, 1)
    _write_fastq(tmp_path / "m2.fq", p, 2)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "bowtie2_server_tpu_torch"]
    srv = subprocess.Popen(
        cmd + ["server", "-x", bases[fmt], "--host", "127.0.0.1", "--port",
               str(port), "--batch", "128"] + device_flag,
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        t0 = time.time()
        while True:
            assert srv.poll() is None, srv.communicate()[1].decode()[-2000:]
            try:
                if http(port, b"GET / HTTP/1.1\r\n\r\n").endswith(
                        b"bowtie2 SaaS\n"):
                    break
            except OSError:
                pass
            assert time.time() - t0 < 120, "server did not start"
            time.sleep(0.2)
        runs = {
            "client": ["client", "--host", "127.0.0.1", "--port", str(port),
                       "-x", "genome", "-U", str(tmp_path / "u.fq")],
            "paired": ["client", "--server-host", "127.0.0.1",
                       "--server-port", str(port), "-x", "genome",
                       "-1", str(tmp_path / "m1.fq"),
                       "-2", str(tmp_path / "m2.fq")],
            "drop_in": ["align", "-x", bases[fmt], "--server-host",
                        "127.0.0.1", "--server-port", str(port),
                        "-U", str(tmp_path / "u.fq")],
        }
        for name, args in runs.items():
            out = tmp_path / f"{name}.sam"
            r = subprocess.run(cmd + args + ["-S", str(out)], cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=300)
            assert r.returncode == 0, (name, r.stderr[-2000:])
            lines = out.read_text().splitlines()
            assert not any(line.startswith("@") for line in lines)
            if name == "paired":
                check_records(lines, {}, pair_origin)
            else:
                check_records(lines, origin, {})
            assert f"received {len(lines)} SAM records" in r.stderr
    finally:
        srv.terminate()
        srv.wait(30)
