"""Host ms a thousand mates in the paired aligner's per-pair decisions
(`pe.decide`, `align/paired.py`: `_decide` over each pair the concordant
fast path left: concordant combos traced and classified, discordant,
mixed), over the pair batches whose `pe.wait` spans started and ended in
the traced slice (`portbench/pairspans.py`). A mate counts as a read."""
from portbench.pairspans import stage_ms_per_kmate
from portbench.spans import recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return stage_ms_per_kmate(TRACE, ctx, "pe.decide")
