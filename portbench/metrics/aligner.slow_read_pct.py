"""The share (%) of the unpaired aligner's reads that the per-read
selection loop finished, where the vectorised fast commit left them
(`up.select`, `UnpairedAligner.align_wait`: `slow` over `reads`), over the
batches whose spans started and ended in the traced slice."""
from portbench.spans import named, recorder, share_pct

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return share_pct(named(TRACE, ctx, "up.select"), "slow", "reads")
