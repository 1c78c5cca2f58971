"""The share (%) of the traced slice in which the server's workers waited
on an empty queue (`srv.idle`, `AlignDispatcher._run`), averaged over the
workers that aligned a pack or waited in the slice."""
from portbench.spans import named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    sps = named(TRACE, ctx, "srv.idle", "srv.pack")
    workers = {s.thread for s in sps}
    if not workers:
        return None
    idle = sum(s.s for s in sps if s.name == "srv.idle")
    return 100.0 * idle / ((ctx.t_stop - ctx.t_start) * len(workers))
