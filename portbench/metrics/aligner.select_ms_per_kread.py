"""Host ms a thousand reads in `up.select` (`align/pipeline.py`,
`UnpairedAligner.align_wait`: the vectorised commit of the fused winners,
the traceback of the gapped and --local ones, and the per-read loop for
the reads it leaves), over the batches whose spans started and ended in
the traced slice."""
from portbench.spans import ms_per_kread, named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return ms_per_kread(named(TRACE, ctx, "up.select"))
