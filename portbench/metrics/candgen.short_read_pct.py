"""The share (%) of the reads enqueued to the fused pipeline that took the
general short-read shape (FM walks on the card) rather than the fast shape
(`cg.enqueue`'s `short` and `reads`, `CandGen._launch`), over the enqueues
that started and ended in the traced slice; an escalated batch's re-runs
count again. A program whose `cg.enqueue` spans carry no counts reads
nothing."""
from portbench.spans import named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    spans = [s for s in named(TRACE, ctx, "cg.enqueue") if "reads" in s.attrs]
    reads = sum(s.attrs["reads"] for s in spans)
    if not reads:
        return None
    return 100.0 * sum(s.attrs["reads"] for s in spans
                       if s.attrs["short"]) / reads
