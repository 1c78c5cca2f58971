"""The system under test: the port's BT2SRV server, built as
`bowtie2_server_tpu_torch.server.bt2srv.run_server` builds it and served on
127.0.0.1 at a free port on an event loop of its own thread, as the port's
socket tests serve it. It runs in the run's own process, so that the run
reads the cards' memory and trace and sees every module the program
loads; its clients are other processes."""
from __future__ import annotations

import asyncio
import threading


class Served:
    def __init__(self, index_base: str, device: str, n_workers: int,
                 index_name: str = "genome"):
        from bowtie2_server_tpu_torch.server.bt2srv import Bt2Server
        self.srv = Bt2Server(index_base, index_name=index_name,
                             n_workers=n_workers, device=device)
        self.index_name = index_name
        self._loop = asyncio.new_event_loop()
        started = threading.Event()
        hold: dict = {}

        async def run():
            s = await asyncio.start_server(self.srv.handle, "127.0.0.1", 0,
                                           limit=1 << 20)
            hold["port"] = s.sockets[0].getsockname()[1]
            hold["stop"] = asyncio.Event()
            started.set()
            async with s:
                await hold["stop"].wait()

        self._thread = threading.Thread(
            target=lambda: self._loop.run_until_complete(run()), daemon=True,
            name="portbench-server-loop")
        self._thread.start()
        if not started.wait(60):
            raise RuntimeError("the server did not start listening")
        self._hold = hold
        self.port = hold["port"]

    def close(self):
        """Stop listening, end the loop's thread and the dispatcher's
        workers."""
        self._loop.call_soon_threadsafe(self._hold["stop"].set)
        self._thread.join(60)
        self._loop.close()
        self.srv.close()
        for t in self.srv._dispatch._threads:
            t.join(60)
