"""Host ms a thousand reads in `UnpairedAligner.align_batch`
(`align/pipeline.py`), the calls the server's worker makes for unpaired
rows, over the calls that started and ended in the traced slice."""
from portbench.probes import batch_reads, ended, outermost

PROBES = {"up": "worker.up.align_batch", "pal": "worker.pal.align_batch"}
CAPTURE = {"up": batch_reads}


def read(calls, ctx):
    ups = ended(outermost(calls["up"], calls["pal"]), ctx)
    reads = sum(c.info for c in ups)
    if not reads:
        return None
    return sum(c.s for c in ups) * 1e3 / (reads / 1e3)
