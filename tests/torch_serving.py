"""Helpers that drive a BT2SRV server of the port over a socket, shared by
tests/test_torch_server.py, tests/test_torch_cuda.py and chip_smoke.py.
They import neither JAX nor any module of the port."""
import asyncio
import contextlib
import socket
import threading


@contextlib.contextmanager
def serving(srv):
    """srv.handle on 127.0.0.1 (an ephemeral port, which the context
    yields), on an event loop of its own thread, as tests/test_server.py
    runs the JAX server. The loop stops on exit; the server's dispatcher
    is the caller's to close."""
    loop = asyncio.new_event_loop()
    started = threading.Event()
    hold = {}

    async def run():
        s = await asyncio.start_server(srv.handle, "127.0.0.1", 0,
                                       limit=1 << 20)
        hold["port"] = s.sockets[0].getsockname()[1]
        hold["ev"] = asyncio.Event()
        started.set()
        async with s:
            await hold["ev"].wait()

    t = threading.Thread(target=lambda: loop.run_until_complete(run()),
                         daemon=True, name="bt2srv-loop")
    t.start()
    assert started.wait(30), "server did not start"
    try:
        yield hold["port"]
    finally:
        loop.call_soon_threadsafe(hold["ev"].set)
        t.join(30)
        loop.close()


def raw_request(port, lines, chunked=True) -> tuple[bytes, bytes]:
    """One align request of raw tab6 lines (bytes, without newlines) with
    the terminator requested: chunked, 40 lines a chunk as the client
    sends them, or with a Content-Length. Returns (response head, body)."""
    body = b"".join(line + b"\n" for line in lines)
    head = (b"PUT /BT2SRV/index/align HTTP/1.1\r\nHost: x\r\n"
            b"X-BT2SRV-Request-Terminator: 1\r\n")
    head += (b"Transfer-Encoding: chunked\r\n" if chunked
             else b"Content-Length: %d\r\n" % len(body))
    with socket.create_connection(("127.0.0.1", port)) as s:
        s.sendall(head + b"\r\n")
        if chunked:
            for k in range(0, len(lines), 40):
                c = b"".join(line + b"\n" for line in lines[k : k + 40])
                s.sendall(b"%x\r\n" % len(c) + c + b"\r\n")
            s.sendall(b"0\r\n\r\n")
        else:
            s.sendall(body)
        s.shutdown(socket.SHUT_WR)
        data = b""
        while chunk := s.recv(1 << 16):
            data += chunk
    head, _, resp = data.partition(b"\r\n\r\n")
    return head, resp


def http(port, request: bytes) -> bytes:
    """The whole reply to one request on a new connection."""
    with socket.create_connection(("127.0.0.1", port)) as s:
        s.sendall(request)
        data = b""
        while chunk := s.recv(4096):
            data += chunk
    return data


def tab6_line(row) -> bytes:
    """A tab6/tab5 row (its None fields dropped) as one request line."""
    return b"\t".join(x if isinstance(x, bytes) else x.encode()
                      for x in row if x is not None)
