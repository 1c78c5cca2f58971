"""Multi-worker pack dispatch with per-connection fairness (ref:
pat.cpp:2016-2086 — per-connection `psq_idle` queues feeding the shared
`psq_ready_` pool consumed by all worker threads; SURVEY §2.3 row 3 maps
that scale-out axis to dispatching read packs across device groups).

Architecture: N workers, each owning one DEVICE GROUP — one torch device
(the CPU, or one CUDA card) or a 'dp' mesh of several cards
(parallel/mesh.py); the index is replicated per card.
Packs are taken round-robin ACROSS CONNECTIONS — one pack per connection
per turn — so a connection streaming millions of reads cannot starve a
small one (the reference gets the same property from its per-connection
idle queues). Results return through per-pack futures; the caller writes
them in submission order per connection, which makes the merged SAM stream
deterministic (the OutputQueue role, outq.h:38).
"""
from __future__ import annotations

import itertools
import sys
import threading
from collections import OrderedDict, deque
from concurrent.futures import Future

import torch

from ..utils import trace


class AlignDispatcher:
    def __init__(self, workers):
        """workers: list of opaque worker contexts (e.g. aligner pairs);
        one thread is spawned per worker. Work items are (fn, args) where
        fn(worker_ctx, *args) runs on the worker's thread."""
        self._workers = workers
        self._lock = threading.Condition()
        # conn_id -> deque[(fn, args, Future)]; OrderedDict gives a stable
        # round-robin order over live connections
        self._queues: "OrderedDict[int, deque]" = OrderedDict()
        self._rr: deque[int] = deque()
        self._stop = False
        self._packs = itertools.count(1)   # pack identifiers (trace spans)
        self._threads = [
            threading.Thread(target=self._run, args=(w,), daemon=True,
                             name=f"bt2srv-worker-{k}")
            for k, w in enumerate(workers)]
        for t in self._threads:
            t.start()

    @property
    def n_workers(self) -> int:
        return len(self._workers)

    def submit(self, conn_id: int, fn, *args) -> Future:
        """Enqueue one pack for `conn_id`; returns its Future."""
        fut: Future = Future()
        item = (fn, args, fut, next(self._packs), trace.now())
        with self._lock:
            q = self._queues.get(conn_id)
            if q is None:
                q = deque()
                self._queues[conn_id] = q
                self._rr.append(conn_id)
            q.append(item)
            self._lock.notify()
        return fut

    def _next_item(self):
        """Round-robin pop: one pack from the next connection that has
        work. Must hold the lock."""
        for _ in range(len(self._rr)):
            cid = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(cid)
            if q:
                return q.popleft()
            if q is not None and not q:
                # empty queue: retire the connection from the rotation
                self._queues.pop(cid, None)
                try:
                    self._rr.remove(cid)
                except ValueError:
                    pass
        return None

    def _run(self, worker):
        while True:
            with self._lock:
                item = self._next_item()
                if item is None and not self._stop:
                    with trace.span("srv.idle"):
                        while item is None and not self._stop:
                            self._lock.wait()
                            item = self._next_item()
                if self._stop and item is None:
                    return
            fn, args, fut, pack, t_submit = item
            trace.set_pack(pack)
            trace.record("srv.queue", t_submit)
            try:
                fut.set_result(fn(worker, *args))
            except BaseException as e:   # surface to the awaiting handler
                fut.set_exception(e)
            finally:
                trace.set_pack(None)

    def shutdown(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()


def make_device_groups(n_workers: int, device) -> list:
    """Partition the devices of `device` into n_workers disjoint groups
    (ref: SURVEY §2.3 row 3 — per-host/per-group read shards; JAX
    server/dispatch.py). device: 'cpu' (the CPU), 'cuda' (every card) or
    'cuda:k' (that card). One worker over more than one card gets one 'dp'
    mesh over every card; else each worker gets `cards // n_workers`
    cards, a Mesh (parallel/mesh.py) when that is more than one, the
    torch.device itself otherwise. Cards left over are named on
    stderr."""
    from ..parallel.mesh import Mesh
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        devs = [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    else:
        devs = [device]
    n_workers = max(n_workers, 1)
    if n_workers == 1 and len(devs) > 1:
        return [Mesh(devs)]
    if len(devs) < n_workers:
        raise ValueError(
            f"{n_workers} workers need >= {n_workers} devices "
            f"(have {len(devs)})")
    per = len(devs) // n_workers
    groups = [devs[k * per : (k + 1) * per] for k in range(n_workers)]
    idle = devs[n_workers * per :]
    if idle:
        print(f"bt2srv: {n_workers} worker(s) use "
              f"{[[str(d) for d in g] for g in groups]}; "
              f"{[str(d) for d in idle]} stay idle", file=sys.stderr)
    return [Mesh(g) if len(g) > 1 else g[0] for g in groups]
