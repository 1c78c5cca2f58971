"""Host ms a thousand mates in the paired aligner's wait (`pe.wait`,
`align/paired.py`, `PairedAligner.align_wait`: both mates' collect, the
concordant fast path, the combos, mate rescue and the per-pair decisions),
over the pair batches whose `pe.wait` spans started and ended in the
traced slice. A mate counts as a read, as in `srv.pack`."""
from portbench.spans import ms_per_kread, named, recorder

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return ms_per_kread(named(TRACE, ctx, "pe.wait"))
