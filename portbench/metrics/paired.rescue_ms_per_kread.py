"""Host ms a thousand mates in mate rescue (`pe.rescue`, `align/paired.py`,
`PairedAligner._run_rescue`: the fragment windows packed, the rectangle DP
of `ops/csrc/sw.cu` on the rect stream, the hits appended), over the pair
batches whose `pe.wait` spans started and ended in the traced slice
(`portbench/pairspans.py`); a batch with no rescue adds its mates and no
time. A mate counts as a read."""
from portbench.pairspans import stage_ms_per_kmate
from portbench.spans import recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return stage_ms_per_kmate(TRACE, ctx, "pe.rescue")
