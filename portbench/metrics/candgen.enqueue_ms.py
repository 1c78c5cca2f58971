"""Mean host ms of one enqueue of the fused pipeline (`cg.enqueue`,
`CandGen._launch`: the staged copies, the pipeline's launches and the
result copy on each shard), over the spans that started and ended in the
traced slice."""
from portbench.spans import mean_ms, named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return mean_ms(named(TRACE, ctx, "cg.enqueue"))
