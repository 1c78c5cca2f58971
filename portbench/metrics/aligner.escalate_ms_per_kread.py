"""Host ms a thousand enqueued reads that the unpaired aligner spends past
a batch's first fetch when its fused pipeline overflowed a capacity
(`up.escalate`, `UnpairedAligner.collect_wait`: the re-runs at 2x and 4x
and the host path, `_collect_host`, when it runs; the paired aligner's
mates too), over the spans that started and ended in the traced slice.
The reads are those of the `cg.enqueue` spans in the slice (`reads`). It
reads 0 where the program counts its enqueued reads and no batch
overflowed, and nothing where the enqueues carry no counts (a program
without this span)."""
from portbench.spans import named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    spans = named(TRACE, ctx, "cg.enqueue", "up.escalate")
    reads = sum(s.attrs["reads"] for s in spans
                if s.name == "cg.enqueue" and "reads" in s.attrs)
    if not reads:
        return None
    ms = sum(s.s for s in spans if s.name == "up.escalate") * 1e3
    return ms / (reads / 1e3)
