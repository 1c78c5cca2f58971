"""Median ms a pack waits in `AlignDispatcher`'s queues (`srv.queue`: from
`submit` to the worker's pickup), over the packs picked up in the traced
slice."""
from portbench.probes import median
from portbench.spans import named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return median([s.s * 1e3 for s in named(TRACE, ctx, "srv.queue")])
