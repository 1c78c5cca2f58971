"""The share (%) of the unpaired aligner's traceback passes that the CUDA
traceback kernel ran (`up.select`'s `tb_card` over its `tb`: the band and
rectangle tracebacks of the batch, the --met Bt counter's increase), over
the batches whose spans started and ended in the traced slice. None where
the spans carry no such counts or count no traceback."""
from portbench.spans import named, recorder, share_pct

TRACE = recorder()
PROBES = {}


def read(calls, ctx):
    sel = [s for s in named(TRACE, ctx, "up.select") if "tb_card" in s.attrs]
    return share_pct(sel, "tb_card", "tb")
