"""The share (%) of the banded DP problems launched by the fused pipeline
that are real: the interior candidates (`cg.fetch`'s `valid`, the counter
row's DPEx) over the problems launched (`launched`, C_max a shard), over
the fetches that started and ended in the traced slice."""
from portbench.spans import named, recorder, share_pct

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return share_pct(named(TRACE, ctx, "cg.fetch"), "valid", "launched")
