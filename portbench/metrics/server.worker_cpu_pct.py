"""The share (%) of its packs' wall time in which the server's worker
thread ran on a core: its CPU time over the wall time of `srv.pack`, with
the waits on the card's output (`cg.fetch`) inside each pack taken out of
both. Under 100: time runnable but not running, as behind the event loop
for the GIL. Over the packs that started and ended in the traced slice."""
from portbench.spans import named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    sps = named(TRACE, ctx, "srv.pack", "cg.fetch")
    packs = [s for s in sps if s.name == "srv.pack"]
    fetches = [s for s in sps if s.name == "cg.fetch"]
    cpu = wall = 0.0
    for p in packs:
        inner = [f for f in fetches if f.thread == p.thread
                 and p.t0 <= f.t0 and f.t1 <= p.t1]
        cpu += p.cpu_s - sum(f.cpu_s for f in inner)
        wall += p.s - sum(f.s for f in inner)
    if wall <= 0:
        return None
    return 100.0 * cpu / wall
