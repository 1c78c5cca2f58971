"""Mean host ms of one shard's enqueue over a 'dp' mesh (`cg.shard`,
`candgen._sharded_pipeline`: the shard's staged copies, its fused
pipeline's launches, the index remap and the result copy on its card),
over the spans that started and ended in the traced slice. A program
without the span reads nothing."""
from portbench.spans import mean_ms, named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return mean_ms(named(TRACE, ctx, "cg.shard"))
