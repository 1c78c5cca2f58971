"""The share (%) of pairs that the paired aligner's concordant fast path
committed (`pe.fast`, `align/paired.py`: `_fast_cp` and
`_commit_fast_cp`; `fast` over `pairs`), over the pair batches whose
spans started and ended in the traced slice; the rest go through the
combos, mate rescue and `_decide`."""
from portbench.spans import named, recorder, share_pct

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    return share_pct(named(TRACE, ctx, "pe.fast"), "fast", "pairs")
