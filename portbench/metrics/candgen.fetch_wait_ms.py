"""Mean host ms of one `CandGen.fetch` (`cg.fetch`: the wait on the
shards' events, which is the card's remaining time and the copy, and the
decode), over the spans that started and ended in the traced slice."""
from portbench.spans import mean_ms, named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return mean_ms(named(TRACE, ctx, "cg.fetch"))
