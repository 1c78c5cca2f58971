"""The BT2SRV wire client of the benchmark: a frozen copy of the protocol
logic of the port's `server/client.py` (itself the reference client's,
pat.cpp:2221-2789), instrumented for the benchmark.

* PUT handshake with `X-BT2SRV-Request-Terminator: 1`; the server's 200
  reply and its config headers, which must promise the terminator.
* Reads go up as chunked tab6 (`name\\tseq\\tqual[\\tname2\\tseq2\\tqual2]`),
  RE_PER_PACKET reads a chunk, under 4-hex-digit slot names (`%04X/1`,
  `%04X/2`); at most MAX_SLOTS reads are in flight, and a slot frees on the
  server's `@CO END READ` marker.
* A receiver thread drains the socket from the handshake on, so that the
  upload never deadlocks against results streamed back mid-upload.
* `@CO BT2SRV All Done` ends the response.

What the benchmark adds: each read's records are handed, with the time of
its END READ marker, to a callback; and the faults of the exchange are
counted instead of raised: a record or marker for no slot in flight
(`stray`), a read whose record count is wrong (`miscounted`), reads never
answered (`unanswered`), and a response without All Done (`no_all_done`).
"""
from __future__ import annotations

import socket
import threading
import time

RE_PER_PACKET = 40   # reads a chunk (ref: pat.h:2451)
MAX_SLOTS = 20000    # reads in flight (ref: pat.h:2466, 2 x 10,000)


class Connection:
    def __init__(self, host: str, port: int, index_name: str, n_records: int,
                 on_read=None, max_slots: int = MAX_SLOTS):
        """n_records: records each read must get (1 unpaired, 2 a pair).
        on_read(key, lines, t): called on the receiver thread at each END
        READ marker, with the key given to send() and the read's record
        lines (bytes, QNAME as the server wrote it)."""
        self.n_records = n_records
        self.on_read = on_read
        self.max_slots = max_slots
        self.faults = {"stray": 0, "miscounted": 0, "unanswered": 0,
                       "no_all_done": 0}
        self.sock = socket.create_connection((host, port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb", buffering=1 << 16)
        req = (f"PUT /BT2SRV/{index_name}/align HTTP/1.1\r\n"
               f"Host: {host}:{port}\r\n"
               "User-Agent: BT2CLT\r\n"
               "Accept: */*\r\n"
               "Transfer-Encoding: chunked\r\n"
               "X-BT2SRV-Request-Terminator: 1\r\n\r\n")
        self.sock.sendall(req.encode())
        status = self.rfile.readline()
        if b" 200 " not in status:
            raise ConnectionError(f"server refused: {status!r}")
        config = {}
        while True:
            line = self.rfile.readline().rstrip(b"\r\n")
            if not line:
                break
            k, _, v = line.partition(b":")
            config[k.strip()] = v.strip()
        if config.get(b"X-BT2SRV-Terminator") != b"1":
            raise ConnectionError("server did not promise a terminator")
        self._slots: dict[int, tuple[object, list]] = {}
        self._free: list[int] = []
        self._next = 0
        self._cv = threading.Condition()
        self.all_done_t = None
        self.closed = False
        self._recv = threading.Thread(target=self._recv_loop, daemon=True,
                                      name="portbench-recv")
        self._recv.start()

    # ---- receive side ----

    def _recv_loop(self):
        try:
            for raw in self.rfile:
                if raw.startswith(b"@CO "):
                    if raw.startswith(b"@CO BT2SRV All Done"):
                        self.all_done_t = time.monotonic()
                        break
                    if raw.startswith(b"@CO END READ"):
                        self._end_read(raw.rstrip(b"\n").split(b"\t", 1)[-1])
                        continue
                if raw.startswith(b"@"):
                    continue
                sid = _slot_of(raw)
                with self._cv:
                    ent = self._slots.get(sid)
                if ent is None:
                    self.faults["stray"] += 1
                else:
                    ent[1].append(raw.rstrip(b"\n"))
        except OSError:
            pass
        finally:
            with self._cv:
                self.closed = True
                self._cv.notify_all()

    def _end_read(self, qname: bytes):
        t = time.monotonic()
        sid = _slot_of(qname)
        with self._cv:
            ent = self._slots.pop(sid, None)
            if ent is not None:
                self._free.append(sid)
                self._cv.notify_all()
        if ent is None:
            self.faults["stray"] += 1
            return
        key, lines = ent
        if len(lines) != self.n_records:
            self.faults["miscounted"] += 1
        if self.on_read is not None:
            self.on_read(key, lines, t)

    # ---- send side ----

    def _acquire(self, key, until: float) -> int | None:
        with self._cv:
            while len(self._slots) >= self.max_slots and not self.closed:
                if time.monotonic() >= until:
                    return None
                self._cv.wait(0.05)
            if self.closed:
                raise ConnectionError("the server closed the connection")
            if self._free:
                sid = self._free.pop()
            else:
                sid = self._next
                self._next = (self._next + 1) % (1 << 16)
            self._slots[sid] = (key, [])
            return sid

    def send(self, rows, until: float = float("inf")) -> int:
        """rows: a list of (key, [seq, qual] or [seq1, qual1, seq2, qual2])
        with bytes fields; each goes up under a free slot's name. Returns
        the rows sent: fewer when `until` (a time.monotonic() value) passed
        while it waited for a free slot."""
        pack, sent = [], 0
        for key, fields in rows:
            sid = self._acquire(key, until)
            if sid is None:
                break
            sent += 1
            if len(fields) == 4:
                pack.append(b"%04X/1\t%s\t%s\t%04X/2\t%s\t%s\n" % (
                    sid, fields[0], fields[1], sid, fields[2], fields[3]))
            else:
                pack.append(b"%04X/1\t%s\t%s\n" % (sid, fields[0], fields[1]))
            if len(pack) >= RE_PER_PACKET:
                self._chunk(b"".join(pack))
                pack = []
        if pack:
            self._chunk(b"".join(pack))
        return sent

    def _chunk(self, data: bytes):
        self.sock.sendall(b"%x\r\n" % len(data) + data + b"\r\n")

    def finish(self, timeout: float) -> None:
        """Send the last chunk and wait for All Done (or the socket's end)
        at most `timeout` seconds; then count what never came."""
        try:
            self.sock.sendall(b"0\r\n\r\n")
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        self._recv.join(timeout)
        self.abort()
        self._recv.join(10)
        if self.all_done_t is None:
            self.faults["no_all_done"] += 1
        with self._cv:
            self.faults["unanswered"] += len(self._slots)

    def abort(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _slot_of(line: bytes) -> int:
    """The slot of a record or marker: the QNAME's hex digits before any
    '/' (-1 when it is no slot name)."""
    q = line.split(b"\t", 1)[0].split(b"/", 1)[0]
    try:
        return int(q, 16)
    except ValueError:
        return -1
