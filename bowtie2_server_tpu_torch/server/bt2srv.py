"""The BT2SRV wire protocol server (ref: pat.cpp:1823-2197
PatternSourceServiceFactory, §0 of SURVEY.md). Port of
bowtie2_server_tpu/server/bt2srv.py: the packs run through the port's
PairedAligner and UnpairedAligner of each device group: a device, or a
'dp' mesh of several cards (parallel/mesh.py).

Wire-compatible with the reference's client binary (-DBT2WEBCLIENT):

  request:  PUT|POST /BT2SRV/<index>/align HTTP/1.1 with
            Transfer-Encoding: chunked (or Content-Length) and optionally
            X-BT2SRV-Request-Terminator: 1; body = HTTP chunks of tab6/tab5
            lines (name\\tseq\\tqual[\\tname2\\tseq2\\tqual2]).
  response: HTTP/1.1 200 OK + Connection: close + X-BT2SRV-* config headers
            (+ X-BT2SRV-Terminator: 1 when requested), blank line, then raw
            SAM records streamed as reads finish, with "@CO END READ\\t<name>"
            after each read's records and a final "@CO BT2SRV All Done\\n"
            (ref: pat.cpp:2139-2172, aln_sink.cpp:2150-2170). Response
            framing is socket-close-delimited, not chunked.
  also:     GET / -> "bowtie2 SaaS" banner; GET /config or
            GET /BT2SRV/<index>/config -> config as body (ref: pat.cpp:1990).

Concurrency model: each connection parses its own input on the event
loop; packs from all connections dispatch ROUND-ROBIN (one pack per
connection per turn — the fairness of the reference's per-connection idle
queues, pat.cpp:2016-2086) onto N workers, each owning one device group
(server/dispatch.py). All torch work of a pack runs on its worker's
thread, against that worker's devices; the event loop runs none. Results
stream back in read order per connection — the protocol permits any
order, ordered is simpler and deterministic (the OutputQueue role,
outq.h:38). A pack that fails (a CUDA fault, a kernel that does not
build) fails its connection: it closes without "@CO BT2SRV All Done", so
the client reports the reads it did not get; nothing is answered from
another device.
"""
from __future__ import annotations

import asyncio
import itertools

from .. import native
from ..align.paired import PairedAligner, PairedRecs
from ..align.pipeline import LazyRecs, SearchPolicy
from ..io.fastq import make_batch
from ..io.sam import sam_record
from ..parallel.mesh import Mesh, device_scope
from ..utils import trace
from ..utils.presets import preset_params

VERSION = "2.5.4"
FLUSH_READS = 4096  # must stay < the client's 20k in-flight slot cap


class Bt2Server:
    def __init__(self, index_base: str, index_name: str | None = None,
                 local: bool = False, preset: str | None = None,
                 batch_size: int = FLUSH_READS, n_workers: int = 1,
                 remote_workers: list[str] | None = None, *, device):
        """device: where the packs are aligned ('cuda' every card: one
        worker gets a 'dp' mesh over all of them, N workers each a group of
        cards // N, a mesh when that is more than one; 'cuda:k' that card;
        'cpu' the plain torch versions of the kernels). remote_workers:
        "host:port" addresses of backend BT2SRV servers (one per remote
        host); packs relay to them over the same wire protocol and merge
        in submission order — the multi-HOST scale-out axis (SURVEY §2.3
        row 3: the reference's shared worker pool over per-connection
        queues, pat.cpp:2016-2086, mapped to per-host shards with a
        deterministic merge). Mixable with local device workers."""
        from ..index.bt2_reader import detect_index
        from .dispatch import AlignDispatcher, make_device_groups
        _, loader = detect_index(str(index_base))
        self.idx = loader(str(index_base))
        self.index_name = index_name or str(index_base).rsplit("/", 1)[-1]
        sc, polkw = preset_params(preset, local)
        self.pol = SearchPolicy(**polkw)
        # one aligner pair per device group; packs dispatch round-robin
        # across connections onto the groups (ref: the shared worker pool
        # over per-connection queues, pat.cpp:2016-2086; SURVEY §2.3 row
        # 3). The unpaired rows run on the PairedAligner's own
        # UnpairedAligner, so each card holds the index once.
        workers = []
        for grp in make_device_groups(n_workers, device):
            where = (dict(mesh=grp) if isinstance(grp, Mesh)
                     else dict(device=grp))
            pal = PairedAligner(self.idx, scoring=sc, policy=self.pol,
                                **where)
            workers.append((pal.up, pal))
        self.up, self.pal = workers[0]
        for addr in remote_workers or []:
            host, _, port = addr.rpartition(":")
            workers.append(("remote", host, int(port), self.index_name))
        self._dispatch = AlignDispatcher(workers)
        # the SAM emitter's library: a changed source builds here, in the
        # set-up, and not in the first pack
        native.get_lib()
        self.batch_size = batch_size
        self._conn_seq = 0
        self._server = None

    def close(self):
        """Stop the dispatcher worker threads (long-lived processes that
        create many servers — the test suite — would otherwise accumulate
        idle threads; ref: the server's acknowledged shutdown TODO,
        pat.h:1946-1954, done properly here)."""
        self._dispatch.shutdown()

    # ---- config block (ref: pat.cpp:1990-2011 reply_config) ----

    def config_lines(self, header_prefix: bool) -> bytes:
        p0 = b"X-" if header_prefix else b""
        p = b"X-BT2SRV-" if header_prefix else b""
        return b"".join([
            p0 + b"BT2SRV-Version: " + VERSION.encode() + b"\r\n",
            p + b"Index-Name: " + self.index_name.encode() + b"\r\n",
            p + b"Seed-Len: %d\r\n" % self.pol.seed_len,
            p + b"Seed-Rounds: %d\r\n" % self.pol.n_seed_rounds,
            p + b"Max-DP-Streak: %d\r\n" % self.pol.dp_streak,
            p + b"KHits: %d\r\n" % self.pol.khits,
        ])

    # ---- alignment of one flushed pack ----

    @staticmethod
    def _align_pack_remote(worker, rows):
        """Relay one pack to a backend BT2SRV server over the wire
        protocol (our own client, concurrent send/receive) and reassemble
        the response bytes with per-read END READ markers. One connection
        per pack keeps the relay stateless; the handshake cost amortizes
        over the pack (ref: the DCN-dispatch mapping, SURVEY §2.3 row 3)."""
        from .client import Bt2Client
        _, host, port, iname = worker
        cl = Bt2Client(host, port, iname)
        cl.send_reads([r[:3] if r[3] is None else r for r in rows])
        by_name: dict[str, list[str]] = {}
        for line in cl.finish():
            by_name.setdefault(line.split("\t", 1)[0], []).append(line)
        out = []
        for r in rows:
            key = r[0]
            if key.endswith("/1") or key.endswith("/2"):
                key = key[:-2]
            for line in by_name.get(key, ()):
                out.append(line)
            out.append("@CO END READ\t" + key)
        return ("\n".join(out) + "\n").encode()

    @staticmethod
    def _align_pack(worker, rows, ref_names):
        """rows: list of (name, seq, qual, name2|None, seq2|None, qual2|None).
        Runs on a dispatcher worker thread against that worker's devices.
        Returns the response bytes (SAM records + END READ markers)."""
        if isinstance(worker, tuple) and worker and worker[0] == "remote":
            return Bt2Server._align_pack_remote(worker, rows)
        up, pal = worker
        # the worker thread's current card is its group's first (a new
        # thread starts on card 0): the rect DP and mate rescue run there;
        # a mesh's shards enter their own cards
        with trace.span("srv.pack") as sp, device_scope(up.device):
            recs, pairs = _align(up, pal, rows)
            sp.set(reads=_n_reads(rows))
            return _pack_bytes(up, rows, recs, pairs, ref_names)

    # ---- connection handling ----

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        try:
            header = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            writer.close()
            return
        head = header.decode("latin1")
        req = head.split("\r\n", 1)[0]
        try:
            if (req.startswith("PUT ") or req.startswith("POST ")) and \
                    "/align" in req and "/BT2SRV/" in req:
                await self._handle_align(reader, writer, head)
            elif req.startswith("GET ") and (
                    " /config" in req or "/config " in req or
                    ("/BT2SRV/" in req and "/config" in req)):
                writer.write(b"HTTP/1.1 200 OK\r\nConnection: close\r\n\r\n")
                writer.write(self.config_lines(False))
            elif req.startswith("GET / "):
                writer.write(b"HTTP/1.1 200 OK\r\nConnection: close\r\n\r\n"
                             b"bowtie2 SaaS\n")
            elif req.split(" ", 1)[0] in ("GET", "POST", "PUT"):
                writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                             b"Connection: close\r\n\r\n")
            else:
                writer.write(
                    b"HTTP/1.1 405 Method Not Allowed\nAllow: GET, POST, "
                    b"PUT\r\nConnection: close\r\n\r\n")
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _handle_align(self, reader, writer, head: str):
        hl = head.lower()
        chunked = "transfer-encoding: chunked" in hl
        term = "x-bt2srv-request-terminator: 1" in hl
        content_length = None
        for line in head.split("\r\n"):
            if line.lower().startswith("content-length:"):
                content_length = int(line.split(":", 1)[1].strip())
        if not chunked and content_length is None:
            writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                         b"Connection: close\r\n\r\n")
            return
        writer.write(b"HTTP/1.1 200 OK\r\nConnection: close\r\n")
        writer.write(self.config_lines(True))
        if term:
            writer.write(b"X-BT2SRV-Terminator: 1\r\n")
        writer.write(b"\r\n")
        await writer.drain()

        self._conn_seq += 1
        conn_id = self._conn_seq
        pending_lines = b""
        rows = []
        # pipelined dispatch: parse of pack i+1 overlaps alignment of pack
        # i; depth bounds per-connection in-flight work (back-pressure —
        # the analog of the reference's sized per-connection idle queue,
        # pat.cpp:2046-2050). Results are written in submission order.
        inflight: list = []
        DEPTH = 2

        async def flush(final: bool = False):
            nonlocal rows
            if rows:
                pack, rows = rows, []
                inflight.append(asyncio.wrap_future(self._dispatch.submit(
                    conn_id, self._align_pack, pack,
                    [n.split()[0] if n.split() else n
                     for n in self.idx.ref_names])))
            while inflight and (final or len(inflight) >= DEPTH):
                data = await inflight.pop(0)
                writer.write(data)
                await writer.drain()

        def parse() -> bool:
            """Rows from the complete lines received, until a pack is
            full (True) or no complete line is left (False)."""
            nonlocal pending_lines
            n0 = len(rows)
            with trace.span("srv.parse") as sp:
                full = False
                while b"\n" in pending_lines:
                    line, pending_lines = pending_lines.split(b"\n", 1)
                    line = line.rstrip(b"\r")
                    if not line:
                        continue
                    rows.append(_parse_tab6(line))
                    if len(rows) >= self.batch_size:
                        full = True
                        break
                sp.set(reads=len(rows) - n0)
            return full

        async def feed(data: bytes):
            nonlocal pending_lines
            pending_lines += data
            while parse():
                await flush()

        if chunked:
            while True:
                size_line = await reader.readuntil(b"\r\n")
                size = int(size_line.strip() or b"0", 16)
                if size == 0:
                    # optional trailing CRLF
                    try:
                        await asyncio.wait_for(reader.readexactly(2), 0.5)
                    except Exception:
                        pass
                    break
                data = await reader.readexactly(size)
                await feed(data)
                await reader.readexactly(2)  # chunk CRLF
        else:
            remaining = content_length
            while remaining > 0:
                data = await reader.read(min(1 << 16, remaining))
                if not data:
                    break
                remaining -= len(data)
                await feed(data)
        if pending_lines.strip():
            rows.append(_parse_tab6(pending_lines.strip()))
        await flush(final=True)
        if term:
            writer.write(b"@CO BT2SRV All Done\n")
        await writer.drain()

    async def serve(self, host: str = "0.0.0.0", port: int = 8080):
        self._server = await asyncio.start_server(
            self.handle, host, port, limit=1 << 20)
        import sys
        print("INFO: Server listening", file=sys.stderr)
        print("INFO: Server ready to process", file=sys.stderr)
        async with self._server:
            await self._server.serve_forever()


def _align_rows(up, pal, rows, ref_names) -> list[str]:
    """The SAM lines and END READ markers of one pack, in row order."""
    data = _pack_bytes(up, rows, *_align(up, pal, rows), ref_names)
    return data.decode().split("\n")[:-1]


def _align(up, pal, rows):
    """The aligners' results of a pack's unpaired rows and of its paired
    rows, in row order; None where the pack has none."""
    paired_rows = [r for r in rows if r[3] is not None]
    unpaired_rows = [r for r in rows if r[3] is None]
    recs = pairs = None
    if unpaired_rows:
        b = make_batch([r[0] for r in unpaired_rows],
                       [r[1] for r in unpaired_rows],
                       [r[2] for r in unpaired_rows])
        recs = up.align_batch(b)
    if paired_rows:
        b1 = make_batch([_strip_mate(r[0]) for r in paired_rows],
                        [r[1] for r in paired_rows],
                        [r[2] for r in paired_rows])
        b2 = make_batch([_strip_mate(r[3]) for r in paired_rows],
                        [r[4] for r in paired_rows],
                        [r[5] for r in paired_rows])
        pairs = pal.align_batch(b1, b2)
    return recs, pairs


def _pack_bytes(up, rows, recs, pairs, ref_names) -> bytes:
    """The pack's response bytes: each row's SAM lines, then its END READ
    marker, in row order. The native emitter writes them from the
    aligners' column stores (`native.sam_emit`, one call for the unpaired
    rows and one for the pairs), splicing the lines `sam_record` renders
    for the reads the columns do not hold. Results without a column store
    (a batch the big index halved, the host path's pairs), -k above 1 and
    a missing native library take one `sam_record` a record."""
    mates = _n_reads(rows)
    if not _columns_hold(up, recs, pairs):
        with trace.span("srv.records"):
            row_recs = _row_records(rows, recs, pairs)
        with trace.span("srv.sam") as sp:
            data = ("\n".join(_sam_lines(row_recs, ref_names))
                    + "\n").encode()
            sp.set(mates=mates, columns=0)
        return data
    # the reads outside the columns: materialised and rendered, and the
    # batches' blobs
    with trace.span("srv.records"):
        sides = []
        if recs is not None:
            sides.append((native.sam_side(recs, ref_names), None))
        if pairs is not None:
            sides.append((native.sam_side(pairs.r1, ref_names, mates=True),
                          native.sam_side(pairs.r2, ref_names, mates=True)))
    with trace.span("srv.sam") as sp:
        outs = [native.sam_emit(a, b, ref_names=ref_names, markers=True)
                for a, b in sides]
        sp.set(mates=mates, columns=sum(s.columns for ab in sides
                                        for s in ab if s is not None))
        if len(outs) == 1:
            return outs[0][0]
        return _in_row_order(rows, outs)


def _n_reads(rows) -> int:
    """A pack's reads, a mate counting as one."""
    return sum(1 if r[3] is None else 2 for r in rows)


def _columns_hold(up, recs, pairs) -> bool:
    """Whether the native emitter can write the pack: one record a read
    (-k 1), each result a LazyRecs (a pair's, one a mate) and the native
    library built."""
    return (up.pol.khits == 1
            and (recs is None or isinstance(recs, LazyRecs))
            and (pairs is None or (isinstance(pairs, PairedRecs)
                                   and isinstance(pairs.r1, LazyRecs)
                                   and isinstance(pairs.r2, LazyRecs)))
            and native.get_lib() is not None)


def _in_row_order(rows, outs) -> bytes:
    """A pack's bytes from the emitter's two outputs, (bytes, each row's
    end offset) of the unpaired rows and of the paired rows, in row
    order."""
    done = {False: [0, 0], True: [0, 0]}   # kind: rows taken, bytes taken
    parts = []
    for paired, run in itertools.groupby(r[3] is not None for r in rows):
        data, ends = outs[paired]
        k, b0 = done[paired]
        k += sum(1 for _ in run)
        b1 = int(ends[k - 1])
        parts.append(data[b0:b1])
        done[paired] = [k, b1]
    return b"".join(parts)


def _row_records(rows, recs, pairs) -> list[list]:
    """Each row's AlnRecs (a read's one, a pair's two), in row order."""
    unpaired_rows = [r for r in rows if r[3] is None]
    paired_rows = [r for r in rows if r[3] is not None]
    results: dict[int, list] = {}
    for row, rec in zip(unpaired_rows, recs or ()):
        results[id(row)] = [rec]
    for row, (r1, r2) in zip(paired_rows, pairs or ()):
        results[id(row)] = [r1, r2]
    return [results[id(row)] for row in rows]


def _sam_lines(row_recs, ref_names) -> list[str]:
    """The SAM lines of each row's records (`_row_records`), each row's
    followed by its END READ marker."""
    out = []
    for recs in row_recs:
        for rec in recs:
            out.append(sam_record(rec, ref_names))
        # end-of-read marker (ref: aln_sink.cpp:2159): paired reads use
        # the truncated name
        out.append("@CO END READ\t" + recs[0].name)
    return out


def _parse_tab6(line: bytes):
    f = line.split(b"\t")
    if len(f) >= 6:
        return (f[0].decode(), f[1], f[2], f[3].decode(), f[4], f[5])
    return (f[0].decode(), f[1], f[2] if len(f) > 2 else b"", None, None,
            None)


def _strip_mate(name: str) -> str:
    return name[:-2] if name.endswith(("/1", "/2")) else name


def run_server(index_base, port=8080, host="0.0.0.0", **kw):
    srv = Bt2Server(index_base, **kw)
    asyncio.run(srv.serve(host, port))
