"""BT2SRV client (ref: pat.cpp:2221-2789 PatternSourceWebClient).

Wire-identical to the reference's -DBT2WEBCLIENT binary:

* PUT handshake, chunked tab6 upload, SAM streamed back until the
  "@CO BT2SRV All Done" terminator (ref: pat.cpp:2395-2416, 2551).
* Reads are sent under 4-hex-digit slot names ("%04X/1", "%04X/2"); the
  original names live in a client-side slot map bounded at MAX_SLOTS
  in-flight reads and are restored on receipt (ref: pat.h:2464-2550
  LockedOrigBufMap; pat.cpp:2341 readPair2Tab6). Slots free on the
  server's "@CO END READ" markers.
* A dedicated receiver thread drains the socket from handshake time, so a
  server that streams results mid-upload can never fill the client's
  receive buffer and deadlock the upload (the reference runs separate
  send/receive threads for exactly this reason, pat.h:2413-2414).
* --passthrough: the original input record is saved per slot and re-emitted
  (newline-%-escaped) after each of the read's SAM records (ref:
  pat.cpp:2286-2336 saving, 2570-2646 restoration).
* Errors on either direction surface as the reference's "Did not process
  all the input file" failure from finish() (ref: pat.cpp:2540-2543,
  bt2_search.cpp:4606-4609 hasErrors_).
"""
from __future__ import annotations

import queue
import socket
import threading

RE_PER_PACKET = 40   # reads per HTTP chunk (ref: pat.h:2451)
MAX_SLOTS = 20000    # in-flight read bound (ref: pat.h:2466, 2 x 10,000)


def _strip_mate_suffix(name: str) -> str:
    if name.endswith("/1") or name.endswith("/2"):
        return name[:-2]
    return name


def _escape_newlines(b: bytes) -> bytes:
    return b.replace(b"%", b"%25").replace(b"\n", b"%0A")


class Bt2Client:
    def __init__(self, host: str = "localhost", port: int = 8080,
                 index_name: str = "index", passthrough: bool = False):
        self.passthrough = passthrough
        self.sock = socket.create_connection((host, port))
        self.rfile = self.sock.makefile("rb")
        req = (f"PUT /BT2SRV/{index_name}/align HTTP/1.1\r\n"
               f"Host: {host}:{port}\r\n"
               "User-Agent: BT2CLT\r\n"
               "Accept: */*\r\n"
               "Transfer-Encoding: chunked\r\n"
               "X-BT2SRV-Request-Terminator: 1\r\n\r\n")
        self.sock.sendall(req.encode())
        # response header + config (ref: pat.cpp:2439-2484 fdInit)
        self.config = {}
        status = self.rfile.readline()
        if b"200" not in status:
            raise ConnectionError(f"server refused: {status!r}")
        while True:
            line = self.rfile.readline().rstrip(b"\r\n")
            if not line:
                break
            if b":" in line:
                k, v = line.split(b":", 1)
                self.config[k.decode().strip()] = v.decode().strip()
        if self.config.get("X-BT2SRV-Terminator") != "1":
            raise ConnectionError("server did not promise a terminator")

        # slot map: idx -> (restored name, passthrough record bytes|None)
        self._slots: dict[int, tuple[str, bytes | None]] = {}
        self._free: list[int] = []
        self._next_slot = 0
        self._cv = threading.Condition()
        self._lines: "queue.SimpleQueue[str | None]" = queue.SimpleQueue()
        self._error: BaseException | None = None
        self._all_done = False
        self._recv = threading.Thread(target=self._recv_loop, daemon=True,
                                      name="bt2clt-recv")
        self._recv.start()

    # ---- receive side (dedicated thread; ref: receiveDataWorker,
    # pat.cpp:2756-2789 -> process_read_line 2570-2646) ----

    def _recv_loop(self):
        try:
            for raw in self.rfile:
                line = raw.rstrip(b"\n")
                if line.startswith(b"@CO BT2SRV All Done"):
                    self._all_done = True
                    break
                if line.startswith(b"@CO END READ"):
                    sid = self._slot_of(line.split(b"\t", 1)[-1])
                    if sid is not None:
                        with self._cv:
                            self._slots.pop(sid, None)
                            self._free.append(sid)
                            self._cv.notify_all()
                    continue
                if line.startswith(b"@"):
                    continue   # stray header line: drop (client SAM has none)
                self._emit(line)
        except Exception as e:          # socket error: fail the stream
            self._error = e
        finally:
            self._lines.put(None)
            with self._cv:
                self._cv.notify_all()

    @staticmethod
    def _slot_of(qname: bytes) -> int | None:
        h = qname.split(b"/", 1)[0]
        try:
            return int(h, 16)
        except ValueError:
            return None

    def _emit(self, line: bytes):
        """Translate the slot QNAME back to the original name; append the
        passthrough record when enabled."""
        qname, rest = (line.split(b"\t", 1) + [b""])[:2]
        sid = self._slot_of(qname)
        ent = self._slots.get(sid) if sid is not None else None
        if ent is not None:
            name, orig = ent
            self._lines.put(name + "\t" + rest.decode())
            if self.passthrough and orig is not None:
                self._lines.put(_escape_newlines(orig).decode())
        else:
            self._lines.put(line.decode())

    # ---- send side (caller thread; ref: addReadPair/readPair2Tab6,
    # pat.h:2429-2437, pat.cpp:2341-2374) ----

    def _acquire_slot(self, name: str, orig: bytes | None) -> int:
        with self._cv:
            while (len(self._slots) >= MAX_SLOTS and self._error is None
                   and not self._all_done):
                self._cv.wait(1.0)
            if self._error is not None:
                raise ConnectionError("server connection failed") \
                    from self._error
            if self._free:
                sid = self._free.pop()
            else:
                sid = self._next_slot
                self._next_slot = (self._next_slot + 1) % (1 << 16)
            self._slots[sid] = (_strip_mate_suffix(name), orig)
            return sid

    def send_reads(self, rows):
        """rows: iterable of (name, seq, qual) or
        (name1, seq1, qual1, name2, seq2, qual2); an extra trailing
        element (length 4 / 7) carries the original record bytes for
        --passthrough restoration (a (rec1, rec2) tuple for pairs)."""
        pack: list[str] = []
        try:
            for row in rows:
                orig = None
                if len(row) in (4, 7):
                    orig = row[-1]
                    row = row[:-1]
                if isinstance(orig, tuple):
                    orig = b"\n".join(o for o in orig if o)
                parts = [x.decode() if isinstance(x, bytes) else str(x)
                         for x in row]
                sid = self._acquire_slot(parts[0], orig)
                if len(parts) >= 6:
                    parts[0] = "%04X/1" % sid
                    parts[3] = "%04X/2" % sid
                else:
                    parts[0] = "%04X/1" % sid
                pack.append("\t".join(parts) + "\n")
                if len(pack) >= RE_PER_PACKET:
                    self._send_chunk("".join(pack))
                    pack = []
            if pack:
                self._send_chunk("".join(pack))
        except (BrokenPipeError, ConnectionError) as e:
            if self._error is None:
                self._error = e
            raise

    def _send_chunk(self, payload: str):
        data = payload.encode()
        self.sock.sendall(b"%x\r\n" % len(data) + data + b"\r\n")

    # ---- completion ----

    def finish(self):
        """Send the 0-chunk and yield translated SAM lines until All Done
        (ref: pat.cpp:2551-2556; finalize pat.h:2441-2449). Raises if the
        stream failed or ended before every sent read was answered."""
        try:
            self.sock.sendall(b"0\r\n\r\n")
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        while True:
            line = self._lines.get()
            if line is None:
                break
            yield line
        self._recv.join(10)
        self.sock.close()
        if self._error is not None or not self._all_done or self._slots:
            raise RuntimeError(
                "Did not process all the input file (connection ended "
                f"with {len(self._slots)} reads unanswered)"
            ) from self._error
